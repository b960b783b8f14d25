"""Roofline terms of one rank's step, from what a trace of it counts.

The counterpart of `repro/launch/hlo_analysis.py`.  The reference reads
XLA's `cost_analysis()` of the compiled per-device module and parses its
HLO text for the collectives; the port has no HLO: `launch/dryrun.py`
runs a rank's step eagerly on fake tensors, where `FlopCounterMode` counts
the operations, `CostMode` below counts every op's bytes, the collectives
each rank issues and the device memory live, and the custom ops' costs
(the decode-attention kernel's `bytes_flops`) are added since no op
counter sees inside them.  `model_flops` and `active_params` are the
reference's, copied as they are.

Hardware constants: one NVIDIA H100 80GB HBM3 at its 700 W power limit
(NVIDIA's data sheet, SXM part, dense rates): 989 TFLOP/s in bf16, 3.35
TB/s of HBM3, and for a collective the link of its group: NVLink at 450
GB/s a direction when the group's ranks sit in one 8-card node, else the
node's network at 50 GB/s a card (400 Gb/s NDR InfiniBand).  Ranks are
laid out row-major over ("pod", "data", "model") with 8 a node, so on the
production meshes (`launch.mesh.make_production_mesh`) every axis spans
nodes: "model" is 16 consecutive ranks, two nodes; "data" and "pod" stride
across nodes.  All their collectives take the network link; a (2, 2) mesh
of 4 ranks sits in one node and takes NVLink.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 80GB HBM3, 700 W (data sheet, SXM, dense)
PEAK_FLOPS = 989e12        # bf16 tensor cores, per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 50e9             # bytes/s per card over the network (NDR 400 Gb/s)
NVLINK_BW = 450e9          # bytes/s per card, each direction, in one node
NODE_CARDS = 8             # cards a node, joined by NVLink
# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 (700 W, torch 2.11 + CUDA 12.8)
H100_TOTAL_MEMORY = 85_017_493_504

# Workspace a card's kernel allocates inside an op, beside its inputs and
# its output, which no traced op shows (op -> fn(args) -> bytes): CUDA's
# softmax backward forms grad * output before its reduction (torch 2.11,
# `softmax_backward_cuda_out`; the allocator's history on an H100 shows it)
CARD_WORKSPACE = {
    torch.ops.aten._softmax_backward_data.default:
        lambda grad, *_: _nbytes(grad)}

# Ops an autograd formula runs out of place on a tensor subclass, such as
# a fake tensor, and in place on a plain one (op -> the position of the
# buffer it writes): `gather`'s backward scatters into a fresh zeros
# buffer (`areAnyTensorSubclassLike`, torch's `gather_backward`), so an
# eager run never holds the copy a trace makes
SUBCLASS_OUT_OF_PLACE = {torch.ops.aten.scatter_add.default: 0}

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
         "all_to_all")
# the c10d ops a collective reaches: (kind, the position of the process
# group among the op's arguments).  Each counts the bytes of its result,
# its first argument (the reference sums result shapes): the reduced
# tensor, the gathered tensor, this rank's reduced part, the broadcast
# tensor, the exchanged output.
_C10D = {"allreduce_": ("all_reduce", 1), "allgather_": ("all_gather", 2),
         "_allgather_base_": ("all_gather", 2),
         "reduce_scatter_": ("reduce_scatter", 2),
         "_reduce_scatter_base_": ("reduce_scatter", 2),
         "broadcast_": ("broadcast", 1), "alltoall_": ("all_to_all", 2),
         "alltoall_base_": ("all_to_all", 2)}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def group_link(ranks) -> str:
    """"nvlink" when a group's global ranks sit in one node of NODE_CARDS
    cards, else "network"."""
    return "nvlink" if len({r // NODE_CARDS for r in ranks}) == 1 \
        else "network"


class CostMode(TorchDispatchMode):
    """Counts, while active, what the ops of a step cost one rank:

    - `collectives`: bytes by kind (`KINDS`) and by link ("nvlink",
      "network"), and `calls` by kind, of every c10d op issued
      (`torch.distributed`'s collectives dispatch through them, the direct
      ones of `launch/steps.py` included);
    - `op_bytes`: every other op's input plus output bytes (an in-place
      result counted as the op writes it; views, which move nothing, not
      at all): eager's traffic, unfused;
    - `extra_flops` / `extra_bytes`: the custom ops' costs (`costs`:
      op -> fn(args) -> (bytes, flops));
    - `live`, `peak`: device bytes held, following each storage from the
      op that makes it to its release (`track` registers storages made
      before the step, such as its arguments; a "meta" tensor holds
      none), plus, while an op of
      `workspace` (op -> fn(args) -> bytes: `CARD_WORKSPACE` for the
      card's route) runs, the buffer its kernel allocates inside, and
      less, while an op of `SUBCLASS_OUT_OF_PLACE` makes its output, the
      buffer an eager run would have written in place; so `peak` is what
      an eager run holds, up to the allocator's rounding.
    """

    def __init__(self, costs: Optional[Dict] = None,
                 workspace: Optional[Dict] = None):
        super().__init__()
        self.costs = costs or {}
        self.workspace = workspace or {}
        self.collectives = {k: 0 for k in KINDS}
        self.links = {"nvlink": 0, "network": 0}
        self.calls = {k: 0 for k in KINDS}
        self.op_bytes = 0
        self.extra_flops = 0
        self.extra_bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._inplace = 0

    def track(self, *trees) -> int:
        """Count the storages of the tensors in `trees` as held (each
        once); returns the bytes newly counted."""
        added = 0
        for tree in trees:
            for t in _tensors(tree):
                added += self._hold(t)
        return added

    def _hold(self, t: torch.Tensor) -> int:
        if t.device.type == "meta":   # shapes only: no device memory
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live - self._inplace)
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":   # a fake tensor's metadata queries
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d" and name in _C10D:
            kind, at = _C10D[name]
            nbytes = _nbytes(args[0])
            ranks = dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(args[at]))
            self.collectives[kind] += nbytes
            self.links[group_link(ranks)] += nbytes
            self.calls[kind] += 1
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if func in self.costs:
            b, f = self.costs[func](*args, **kwargs)
            self.extra_bytes += b
            self.extra_flops += f
        elif not func.is_view:
            self.op_bytes += _nbytes(list(args)) + _nbytes(
                list(kwargs.values())) + _nbytes(out)
        # the bytes of the output that stand in for a buffer held already
        self._inplace = (_nbytes(args[SUBCLASS_OUT_OF_PLACE[func]])
                         if func in SUBCLASS_OUT_OF_PLACE else 0)
        for t in _tensors(out):
            self._hold(t)
        self._inplace = 0
        if func in self.workspace:
            self.peak = max(self.peak, self.live
                            + self.workspace[func](*args, **kwargs))
        return out

    def collective_summary(self) -> Dict[str, int]:
        """Bytes by kind, with their total (the reference's
        `collective_bytes` layout) and by link."""
        return {**self.collectives, "total": sum(self.collectives.values()),
                "by_link": dict(self.links), "calls": dict(self.calls)}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float,
                   nvlink_bytes_per_device: float = 0.0) -> Dict[str, float]:
    """Seconds each resource needs for one step on one card:
    flops / PEAK_FLOPS, bytes / HBM_BW, and the collectives' bytes over
    their links (coll_bytes over the network's LINK_BW, and
    nvlink_bytes_per_device, the part whose groups sit in one node, over
    NVLINK_BW)."""
    return dict(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=(coll_bytes_per_device / LINK_BW
                      + nvlink_bytes_per_device / NVLINK_BW),
    )


def dominant(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])


def model_flops(cfg, shape: Dict, n_params: int, n_active: Optional[int] = None) -> float:
    """MODEL_FLOPS: 6*N*D train tokens (dense; N_active for MoE), 2*N*tokens
    decode, 2*N*D prefill."""
    n = n_active or n_params
    kind = shape["kind"]
    tokens = shape["global_batch"] * (shape["seq_len"] if kind != "decode" else 1)
    per_tok = 6 * n if kind == "train" else 2 * n
    return float(per_tok) * tokens


def active_params(cfg, n_params: int) -> int:
    """Parameters touched per token (MoE: shared + top_k of routed)."""
    if not cfg.moe:
        return n_params
    m = cfg.moe
    expert_p = 3 * cfg.d_model * m.d_expert
    moe_layers = sum(1 for k in cfg.block_pattern if k == "attn_moe")
    frac = moe_layers / len(cfg.block_pattern)
    n_moe_blocks = round(cfg.n_layers * frac)
    routed_total = n_moe_blocks * m.num_experts * expert_p
    routed_active = n_moe_blocks * m.top_k * expert_p
    return n_params - routed_total + routed_active

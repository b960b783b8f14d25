"""Multi-process bootstrap of the port's sharded sweeps.

The counterpart of `repro/launch/distributed.py`.  JAX shards with one
process and many devices; the port runs one process a device (a rank), so a
sharded sweep is a `torch.distributed` process group whose ranks each run
the same `SweepEngine.run`:

    initialize_distributed()            # torchrun's MASTER_ADDR / WORLD_SIZE
                                        # / RANK, or pass them explicitly
    mesh = make_sweep_mesh(worker_shards=2)   # the ranks are the devices
    plan = ExecutionPlan(mesh=mesh, chunk_rounds=32)

With one process, or no arguments and no environment, it is a no-op that
returns False, and the single-process sweep stays bitwise what it was.  The
backend is NCCL for a CUDA device and gloo for the CPU unless the caller
names one; a backend that fails to start raises, and nothing falls back to
another backend or to the CPU.  NCCL refuses two ranks on one card, so
several ranks sharing one card name the gloo backend themselves (gloo's
all_reduce, all_gather and broadcast take CUDA tensors).

`fetch` is the counterpart of the reference's `process_allgather` fetch
edge.  The LM steps over the worker axes take two more collectives:
`all_reduce_sum_local_grad`, a psum whose backward is the identity (a
rank's local term feeds the global sum linearly, and the over-the-air
all_reduce of the gradients already sums the ranks' contributions), and
`all_reduce_max`, the reference's pmax.  Tensor parallelism over a
"model" group takes Megatron's pair: `copy_in` (identity forward, psum
backward) where a replicated activation enters a rank's shard of a layer,
and `reduce_out` (psum forward, identity backward: the same op as
`all_reduce_sum_local_grad`) where the shard's partial product leaves it;
`all_gather` along the last dim joins vocab-sharded logits.
`gather_shards` is the differentiable gather of a column-parallel product
that every rank then reads in its own way (MLA's q_lora columns, the SSD
block's in_proj columns, the RG-LRU's convolved x): all_gather forward, and backward this rank's
slice of the group-summed gradient.
`gather_storage` joins a weight leaf whose storage is sharded over the
"data" ranks (`launch.sharding.fsdp_augment`, ZeRO-3) where a layer uses
it: all_gather forward, a summing reduce_scatter backward (each rank's
gradient of the whole leaf comes from its own rows, so the sum over the
"data" ranks is the over-the-air sum of their workers).
The sequence-parallel residual (the reference's `make_constrain`: each
"model" rank holds its S / M positions of the [B, S, d] stream) takes
Megatron's sequence-parallel pair in place of `copy_in` / `reduce_out`:
`gather_seq` (all_gather on the sequence forward, summing reduce_scatter
backward) where a rank's rows enter its shard of a layer, and
`scatter_seq` (reduce_scatter forward, all_gather backward) where the
shard's partial product leaves it; the two carry the bytes of the one
all_reduce they replace.  `split_seq` takes a rank's rows of a tensor
every rank holds whole (slice forward, all_gather backward), and
`gather_out` on the sequence dim is its inverse.  The
reference's `setup_compilation_cache` has no counterpart: the
port compiles nothing at run time except its CUDA kernels, which
`kernels/_build.py` builds once into `build/kernels/` and reuses.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# The process group's default timeout: a rank that raises before a
# collective leaves the others waiting this long before they raise too.
DEFAULT_TIMEOUT_S = 600.0
# The timeout `initialize_distributed` gave the process group, which the
# sweep mesh's groups take too (`group_options`).
_timeout: Optional[datetime.timedelta] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S,
                           device=None) -> bool:
    """Start the process group (idempotent; a no-op for one process).

    Returns True when a group of more than one rank is (or already was) up,
    False otherwise.  Arguments left None come from torchrun's variables:
    WORLD_SIZE, RANK, and init_method "env://" (MASTER_ADDR /
    MASTER_PORT); init_method="file:///shared/path" meets without ports.
    world_size=1, or no arguments and no WORLD_SIZE, starts nothing and
    returns False.

    device: this rank's device.  None takes cuda:LOCAL_RANK (LOCAL_RANK
    defaults to 0) and makes it the current card; "cpu" runs the ranks on
    the CPU.  backend None is "nccl" for a CUDA device and "gloo" for the
    CPU.  Every collective of the group waits at most timeout_s."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if world_size is None and init_method is not None:
        raise ValueError(f"init_method {init_method!r} without a world size: "
                         f"pass world_size= or set WORLD_SIZE")
    if world_size is None or world_size == 1:
        return False
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    rank = _env_int("RANK") if rank is None else rank
    if rank is None or not 0 <= rank < world_size:
        raise ValueError(f"rank must be in [0, {world_size}), got {rank} "
                         f"(pass rank= or set RANK)")
    if device is None:
        device = f"cuda:{_env_int('LOCAL_RANK') or 0}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank, timeout=_timeout)
    return True


def group_options(backend: str):
    """`backend`'s options for a group made beside the process group,
    carrying the timeout `initialize_distributed` gave it; None (the
    backend's default timeout) for a group started elsewhere."""
    if _timeout is None or backend not in ("nccl", "gloo"):
        return None
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = _timeout
    return opts


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def broadcast_int(value: int, device, src: int = 0) -> int:
    """Rank `src`'s integer on every rank (a no-op without a process group).
    The tensor lives on `device`, the device the group's backend serves."""
    if world()[1] == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(t, src)
    return int(t.item())


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` of `group` concatenated along `dim` in rank order
    (the reference's tiled all_gather); `x` itself when group is None."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's psum: the elementwise sum of every rank's `x` over
    `group` (a new tensor); `x` itself when group is None."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The reference's pmax: the elementwise max of every rank's `x` over
    `group` (a new tensor); `x` itself when group is None."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _SumLocalGrad(torch.autograd.Function):
    """all_reduce_sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum_local_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """`all_reduce_sum` whose gradient is the identity: each rank's
    gradient through it is the part its own `x` contributes, so a later
    sum of the ranks' gradients (the train step's over-the-air all_reduce)
    gives the global gradient once.  `torch.distributed.nn`'s all_reduce
    sums the gradient over the ranks in its backward as well, which would
    count it R times.  `x` itself when group is None."""
    if group is None:
        return x
    return _SumLocalGrad.apply(x, group)


class _CopyIn(torch.autograd.Function):
    """identity forward, all_reduce_sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def copy_in(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's "copy to the tensor-parallel region": `x`, replicated on
    every rank of `group`, feeds this rank's shard of a layer; the
    gradient is summed over the group, since each rank's backward holds
    only its own shard's share of it.  `x` itself when group is None."""
    if group is None:
        return x
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's "reduce from the tensor-parallel region": the sum over
    `group` of every rank's partial product, replicated; its gradient is
    the identity, since the replicated loss downstream gives every rank
    the whole gradient already (`all_reduce_sum_local_grad`)."""
    return all_reduce_sum_local_grad(x, group)


class _GatherShards(torch.autograd.Function):
    """all_gather forward, all_reduce_sum then this rank's slice
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce_sum(grad, ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def gather_shards(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Every rank's shard `x` of `group` concatenated along `dim` (rank
    order), where each rank then reads the whole tensor in its own way:
    the gradient of this rank's shard is its slice of the gradient summed
    over the group (the reference's all_gather, whose transpose is a
    reduce-scatter).  `x` itself when group is None."""
    if group is None:
        return x
    return _GatherShards.apply(x, group, dim % x.dim())


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's part along `dim` (the parts in rank order) of the
    elementwise sum over `group` of every rank's `x`; `x` itself when
    group is None.  ValueError unless the group's size divides the dim."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    parts = [p.contiguous() for p in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherSum(torch.autograd.Function):
    """all_gather forward, summing reduce_scatter backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim), None, None


def gather_storage(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The whole of a leaf whose storage `group`'s ranks split along `dim`
    (this rank's part `x`, the parts in rank order): all_gather forward;
    backward, the reduce_scatter of the whole leaf's gradient summed over
    the group, so each rank's part receives every rank's contribution to
    it once.  `x` itself when group is None."""
    if group is None:
        return x
    return _GatherSum.apply(x, group, dim % x.dim())


# the sequence dim of the residual stream [B, S, d]
SEQ_DIM = 1


def gather_seq(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sequence-parallel "copy to the tensor-parallel region": every
    rank's rows `x` [B, S / M, ...] of `group` joined on the sequence
    (rank order) into [B, S, ...], which this rank's shard of a layer
    reads; the gradient of its rows is the reduce_scatter of the
    gradient summed over the group, since each rank's backward holds only
    its shard's share of it.  `x` itself when group is None."""
    if group is None:
        return x
    return _GatherSum.apply(x, group, SEQ_DIM)


class _ScatterSeq(torch.autograd.Function):
    """reduce_scatter forward, all_gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, SEQ_DIM)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, SEQ_DIM), None


def scatter_seq(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sequence-parallel "reduce from the tensor-parallel region":
    this rank's rows [B, S / M, ...] of the sum over `group` of every
    rank's partial product `x` [B, S, ...]; the gradient of the partial
    product is the whole gradient, gathered from the ranks' rows.  `x`
    itself when group is None."""
    if group is None:
        return x
    return _ScatterSeq.apply(x, group)


class _SplitSeq(torch.autograd.Function):
    """this rank's rows forward, all_gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        if x.shape[SEQ_DIM] % n:
            raise ValueError(f"split_seq: {tuple(x.shape)} has a sequence "
                             f"that does not split over {n} ranks")
        s = x.shape[SEQ_DIM] // n
        return x.narrow(SEQ_DIM, dist.get_rank(group) * s, s).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, SEQ_DIM), None


def split_seq(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows [B, S / M, ...] of `x` [B, S, ...], which every
    rank of `group` holds whole and the same (a product of replicated
    weights, a gathered output); the gradient of the whole tensor is
    every rank's rows' gradient gathered, whole on every rank as the
    replicated product's backward wants it.  `x` itself when group is
    None."""
    if group is None:
        return x
    return _SplitSeq.apply(x, group)


class _GatherOut(torch.autograd.Function):
    """all_gather forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


def gather_out(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Megatron's "gather from the tensor-parallel region": every rank's
    shard `x` of `group` concatenated along `dim` (rank order) into a
    tensor replicated over the group, such as the residual stream; the
    gradient of this rank's shard is its slice of the gradient, which the
    replicated loss downstream gives every rank whole (where
    `gather_shards` sums it over the group first, for a gathered tensor
    each rank reads only in part).  `x` itself when group is None."""
    if group is None:
        return x
    return _GatherOut.apply(x, group, dim % x.dim())


def fetch(x, dim: Optional[int] = None, group=None) -> np.ndarray:
    """Host numpy copy of `x`.  With `dim`, every rank's `x` (over `group`,
    the whole process group by default) concatenated along `dim` in rank
    order first: the counterpart of the reference's
    `process_allgather(x, tiled=True)`.  A collective when dim is given and
    more than one rank runs."""
    if isinstance(x, torch.Tensor):
        if dim is not None and world()[1] > 1:
            x = all_gather(x, dist.group.WORLD if group is None else group,
                           dim)
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Mixture-of-Experts of the port: router, the two dispatch implementations
and shared experts (`repro/models/moe.py`).

Expert weights are stacked [E, d, f] / [E, f, d], as in the reference, so
JAX weights carry across unchanged.  The expert products are plain batched
matrix products (`torch.bmm`, cuBLAS): in the reference they are XLA
einsums outside any Pallas kernel.

  * `moe_scan_dense` ("scan_dense"): every expert computes every token,
    weighted by the router's combine weights.  The reference scans the
    experts one at a time and adds their weighted outputs in expert order;
    here one `bmm` computes all E experts at once and the weighted outputs
    are summed over the expert axis (E launches fewer; the sum order
    differs from the reference's by rounding only).
  * `moe_capacity_gather` ("capacity_gather"): sort-based token -> expert
    buckets of capacity C = ceil(top_k T / E) * capacity_factor, overflow
    dropped (the reference's `.at[slot].set(mode="drop")`: dropped pairs
    write a spare row that is never read).  The reference scatter-adds each
    (token, k) contribution back with `.at[stok].add`; here the
    contributions are gathered back into [T, k] order and summed over k, a
    fixed order (`index_add_` on the card would add with float atomics, in
    an order that varies from run to run at top_k > 1).

`torch.topk` and `jax.lax.top_k` may order exact ties differently; on
continuous router probabilities ties have measure zero.  Routing is a
discontinuous function of its input: a difference at rounding level
between two routes of the same model (the decode kernel against its plain
version in bf16, say) can swap two nearly tied experts, and one swapped
expert moves that token's output by a whole expert's share.  To compare
two such routes, `RoutingTape` records the experts one run chooses and
replays them in the other (`with routing(tape): ...`), counting the
choices the replayed run would have made otherwise.

Over the worker axes of a mesh (`launch/steps.py`) each rank holds its
rows of the global batch, and `with worker_batch(group): ...` makes the
MoE calls inside see the global batch where the reference's do: the aux
loss `E * sum_e f_e * P_e` is a product of batch means, so its routed
counts and probability sums are summed over the group before it is
formed (the sums through `all_reduce_sum_local_grad`, so each rank's
backward holds its own tokens' share), and `moe_capacity_gather` raises:
its capacity ceil(k T / E) * cf and its drops are the global batch's,
which one rank's tokens cannot reproduce.

Over a "model" axis of M ranks (`common.tensor_parallel`) the router stays
replicated in f32: the residual stream is the same bytes on every model
rank, so the top-k choices are too.  `moe_scan_dense` splits each expert's
f over the ranks (the reference's spec), `moe_capacity_gather` splits the
experts (E / M a rank; the tokens are replicated, so the capacity and the
dropped pairs stay the global ones), and the shared experts split their f;
the routed and shared partial outputs are summed before the layer's one
`reduce_out`.  The combine weights enter the split through `copy_in`, so
the router's gradient is whole on every rank.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.distributed import (all_reduce_sum_local_grad,
                                            copy_in, reduce_out)
from repro_torch.models.common import ModelConfig, ParamInit, model_shards
from repro_torch.models.ffn import init_swiglu, swiglu

Tensor = torch.Tensor


def init_moe(pi: ParamInit, cfg: ModelConfig) -> Dict:
    """The router (f32 whatever cfg.dtype is, as the reference draws it),
    the stacked expert weights w1 / wg [E, d, f], w2 [E, f, d], and the
    shared experts' SwiGLU of width num_shared * f."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_expert
    p = {"router": pi.param((d, e), fan_in=d, dtype=torch.float32),
         "w1": pi.param((e, d, f), fan_in=d),
         "wg": pi.param((e, d, f), fan_in=d),
         "w2": pi.param((e, f, d), fan_in=f)}
    if m.num_shared:
        p["shared"] = init_swiglu(pi, cfg, d_ff=m.num_shared * f)
    return p


def router_probs(p: Dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """[T, E] softmax router probabilities in f32."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


def load_balance_loss(probs: Tensor, idx: Tensor, num_experts: int) -> Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e, f_e the share of top-k
    slots routed to expert e, P_e the mean router probability; under
    `worker_batch`, both means over the global batch."""
    hot = F.one_hot(idx.long(), num_experts).float().sum(dim=1)   # [T, E]
    group, aux = _WORKER_GROUP.get()
    if group is None or not aux:
        return num_experts * torch.sum(hot.mean(dim=0) * probs.mean(dim=0))
    # one all_reduce: [sum_t P, routed counts, T]
    t = torch.full((1,), probs.shape[0], dtype=probs.dtype,
                   device=probs.device)
    sums = all_reduce_sum_local_grad(
        torch.cat([probs.sum(dim=0), hot.sum(dim=0), t]), group)
    p_sum, counts, t_all = sums.split([num_experts, num_experts, 1])
    return num_experts * torch.sum((counts / t_all) * (p_sum / t_all))


class RoutingTape:
    """The experts chosen by every MoE call of a run, in call order.

    Under `routing(tape)` a first run records each call's top-k experts
    [T, k]; once `tape.replay()` is called, the calls of a second run take
    the recorded experts instead of their own (their gates are the second
    run's probabilities of those experts), and `tape.flips` (a device
    tensor: no host sync) counts the tokens whose own top-k set differs
    from the recorded one.  For kernel-vs-plain comparisons only."""

    def __init__(self):
        self.recorded: List[Tensor] = []
        self.replaying = False
        self.cursor = 0
        self.flips: Optional[Tensor] = None
        self.decisions = 0

    def replay(self) -> "RoutingTape":
        self.replaying, self.cursor = True, 0
        return self

    def route(self, idx: Tensor) -> Tensor:
        if not self.replaying:
            self.recorded.append(idx)
            return idx
        want = self.recorded[self.cursor]
        self.cursor += 1
        differ = (torch.sort(idx, dim=-1).values
                  != torch.sort(want, dim=-1).values).any(dim=-1).sum()
        self.flips = differ if self.flips is None else self.flips + differ
        self.decisions += idx.shape[0]
        return want


# the tape of the innermost `routing` block of this context (as the
# reference scopes its sharding hints, `repro/models/common.py::_SHARD_CTX`)
_TAPE = contextvars.ContextVar("repro_torch_routing_tape", default=None)
# (the worker group, whether the aux loss is wanted) of the innermost
# `worker_batch` block
_WORKER_GROUP = contextvars.ContextVar("repro_torch_worker_group",
                                       default=(None, False))


@contextlib.contextmanager
def worker_batch(group, aux: bool = True) -> Iterator[None]:
    """Inside the block each rank of `group` holds its rows of a global
    batch: `moe_capacity_gather` raises, and with aux=True the aux loss is
    the global batch's (one all_reduce a MoE call; aux=False, for the
    steps that drop the aux loss, leaves it rank-local).  group None
    changes nothing."""
    token = _WORKER_GROUP.set((group, aux))
    try:
        yield
    finally:
        _WORKER_GROUP.reset(token)


@contextlib.contextmanager
def routing(tape: RoutingTape) -> Iterator[RoutingTape]:
    """Route every MoE call inside the block through `tape`."""
    token = _TAPE.set(tape)
    try:
        yield tape
    finally:
        _TAPE.reset(token)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The top-k gates renormalized to sum 1, and their experts [T, k]
    (under `routing`, the tape's experts)."""
    gates, idx = torch.topk(probs, k, dim=-1)
    tape = _TAPE.get()
    if tape is not None:
        idx = tape.route(idx)
        gates = probs.gather(-1, idx)
    return gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9), idx


def _experts(w1: Tensor, wg: Tensor, w2: Tensor, x: Tensor) -> Tensor:
    """silu(x @ w1) * (x @ wg) @ w2 for a stack of experts: x [E, C, d]
    (or [C, d], every expert on the same rows) -> [E, C, d]."""
    if x.dim() == 2:
        x = x.expand(w1.shape[0], *x.shape)
    h = F.silu(torch.bmm(x, w1)) * torch.bmm(x, wg)
    return torch.bmm(h, w2)


def _routed_split(cfg: ModelConfig) -> bool:
    """Whether the routed experts are split over the `tensor_parallel`
    axis: their f (scan_dense) or their E (capacity_gather), as the
    reference's specs split them."""
    axis, m = model_shards(), cfg.moe
    return axis is not None and axis.shards(
        m.d_expert if m.impl == "scan_dense" else m.num_experts)


def moe_scan_dense(p: Dict, x2: Tensor, cfg: ModelConfig
                   ) -> Tuple[Tensor, Tensor]:
    """x2 [T, d] -> ([T, d], aux loss): every expert on every token, each
    output weighted by its (token, expert) combine weight (the top-k gates,
    0 elsewhere).  Under `tensor_parallel` with the f split, the output is
    this rank's partial sum."""
    m = cfg.moe
    probs = router_probs(p, x2, cfg)                              # [T, E]
    gates, idx = _top_k(probs, m.top_k)
    comb = torch.zeros_like(probs).scatter(1, idx, gates)         # [T, E]
    if _routed_split(cfg):
        group = model_shards().group
        x2, comb = copy_in(x2, group), copy_in(comb, group)
    out = _experts(p["w1"], p["wg"], p["w2"], x2)                 # [E, T, d]
    y = (comb.T[:, :, None].to(out.dtype) * out).sum(dim=0)
    return y, load_balance_loss(probs, idx, m.num_experts)


def moe_capacity_gather(p: Dict, x2: Tensor, cfg: ModelConfig
                        ) -> Tuple[Tensor, Tensor]:
    """x2 [T, d] -> ([T, d], aux loss): sort-based bucketed dispatch with
    capacity; pairs past an expert's capacity are dropped.  Under
    `tensor_parallel` with the experts split, this rank computes the
    buckets of its experts and the output is its partial sum."""
    if _WORKER_GROUP.get()[0] is not None:
        raise NotImplementedError(
            "moe_capacity_gather over the worker axes: its capacity "
            "ceil(k T / E) * capacity_factor and the pairs it drops are the "
            "global batch's, which a rank's rows cannot reproduce (the zoo's "
            "MoE archs take scan_dense)")
    m = cfg.moe
    t, d = x2.shape
    e, k = m.num_experts, m.top_k
    cap = max(int(-(-k * t // e) * m.capacity_factor), 1)
    probs = router_probs(p, x2, cfg)
    gates, idx = _top_k(probs, k)
    # this rank's experts [e0, e0 + e_loc): all of them off the split
    e_loc = p["w1"].shape[0]
    e0 = 0
    if _routed_split(cfg):
        axis = model_shards()
        e0 = axis.index * e_loc
        x2, gates = copy_in(x2, axis.group), copy_in(gates, axis.group)

    flat_e = idx.reshape(-1)                                      # [T k]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = torch.div(order, k, rounding_mode="floor")             # token
    seg_start = torch.searchsorted(se, torch.arange(e, device=se.device))
    rank = torch.arange(t * k, device=se.device) - seg_start[se]
    ok = (rank < cap) & (se >= e0) & (se < e0 + e_loc)
    slot = torch.where(ok, (se - e0) * cap + rank,
                       torch.full_like(rank, e_loc * cap))
    # row e_loc * cap takes every dropped (or other rank's) pair and is
    # never read
    buf = x2.new_zeros((e_loc * cap + 1, d))
    buf[slot] = x2[stok]
    ye = _experts(p["w1"], p["wg"], p["w2"],
                  buf[:e_loc * cap].reshape(e_loc, cap, d)
                  ).reshape(e_loc * cap, d)
    out = torch.where(ok[:, None],
                      ye[torch.clamp_max(slot, e_loc * cap - 1)],
                      torch.zeros((), dtype=ye.dtype, device=ye.device))
    # back to (token, k) order, then a fixed-order sum over k
    pairs = torch.empty_like(out)
    pairs[order] = out
    w = (gates.reshape(-1) * ok[torch.argsort(order)])[:, None]
    y = (w.to(x2.dtype) * pairs).reshape(t, k, d).sum(dim=1)
    return y, load_balance_loss(probs, idx, e)


def moe_ffn(p: Dict, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """[B, S, d] -> ([B, S, d], aux loss), plus the shared experts if the
    config has them.  Under `tensor_parallel` the split parts' partial
    outputs are summed, then reduced over the ranks once."""
    b, s, d = x.shape
    impl = (moe_scan_dense if cfg.moe.impl == "scan_dense"
            else moe_capacity_gather)
    y2, aux = impl(p, x.reshape(b * s, d), cfg)
    y = y2.reshape(b, s, d)
    axis = model_shards()
    # the split parts' partial sum, and the whole parts' sum
    partial, whole = (y, None) if _routed_split(cfg) else (None, y)
    if cfg.moe.num_shared:
        if axis is not None and axis.shards(cfg.moe.num_shared
                                            * cfg.moe.d_expert):
            partial = _plus(partial, swiglu(p["shared"],
                                            copy_in(x, axis.group)))
        else:
            whole = _plus(whole, swiglu(p["shared"], x))
    if partial is not None:
        whole = _plus(whole, reduce_out(partial, axis.group))
    return whole, aux


def _plus(a: Optional[Tensor], b: Tensor) -> Tensor:
    return b if a is None else a + b

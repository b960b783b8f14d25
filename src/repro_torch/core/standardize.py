"""Gradient standardization for analog transmission (paper §II-B, eq. 3 & 7).

Before each round every worker estimates the scalar mean/variance of its own
gradient (over the D entries), the PS averages them into global stats
(gbar_t, eps_t^2), broadcasts them back, and workers transmit

    gtilde_i = (g_i - gbar_t * 1) / eps_t .                  (eq. 3)

The PS de-standardizes the received superposition y_t as

    gagg = eps_t * y_t + (sum_i p_i |h_i|) * gbar_t * 1 .    (eq. 7)

The sweep's per-worker sums come off the flat gradient rows in one pass
through the `grad_stats` kernel (its plain version on the CPU); the
mean/variance epilogue runs on scalars.  Under strict_numerics the sums are
taken per leaf segment and added in leaf order, the reduction tree of the
per-leaf path (`flat_scalar_stats(flat, sizes)`: one call of the kernel's
fixed-order route `grad_stats_segments` over every segment, whose order
depends on the leaf sizes alone).  Under model sharding
each rank sums its own columns (`flat_partial_stats`, the same kernel) and
the ranks add the partial sums.  The looped trainer's and the tree-state
sweep's pytree path (`per_worker_scalar_stats`, `standardize`,
`destandardize`) is plain tensor math, as in the reference, where it
reaches no Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
# tree_size lives here in the reference
from repro_torch.tree import tree_leaves, tree_map, tree_size  # noqa: F401

Tensor = torch.Tensor


def per_worker_scalar_stats(grads_u: Dict[str, Tensor], batch_dims: int = 1
                            ) -> Tuple[Tensor, Tensor]:
    """(gbar_i, eps2_i) per worker from stacked per-worker gradients.

    grads_u: nested dict whose leaves have `batch_dims` leading axes ([U,
    ...], or [S, U, ...] with batch_dims=2, the reference's vmap over
    lanes).  Returns gbar and eps2 of those leading shape, the per-worker
    mean and (biased) variance of the D gradient entries: f32 sums per
    leaf, added leaf by leaf in the reference's `tree_leaves` order (keys
    sorted at every level)."""
    leaves = tree_leaves(grads_u)
    lead = leaves[0].shape[:batch_dims]
    d = sum(int(x[(0,) * batch_dims].numel()) for x in leaves)
    s1 = sum(x.float().reshape(*lead, -1).sum(dim=-1) for x in leaves)
    s2 = sum(x.float().square().reshape(*lead, -1).sum(dim=-1)
             for x in leaves)
    return stats_from_partials(s1, s2, d)


def flat_scalar_stats(flat: Tensor, sizes: Optional[Sequence[int]] = None,
                      *, plain: bool = False) -> Tuple[Tensor, Tensor]:
    """(gbar_i, eps2_i) per flat gradient row: flat [..., D] -> two [...]
    tensors, the per-row mean and (biased) variance of the D entries.

    sizes=None: all rows go through ONE `grad_stats` launch over the
    [prod(...), D] view, so flat must be contiguous.  With `sizes` (the
    per-leaf entry counts in flatten order, summing to D) the sums are
    taken per leaf segment and added in leaf order, as
    `per_worker_scalar_stats` adds its leaves, by one
    `grad_stats_segments` call on the rows: the strict_numerics route,
    whose order depends on the leaf sizes alone.  `plain` forces the
    kernel's plain version (kernel-vs-plain tests only)."""
    d = flat.shape[-1]
    rows = flat.reshape(-1, d)
    if sizes is None:
        sums = ops.grad_stats(rows, plain=plain)
    else:
        sums = ops.grad_stats_segments(rows, sizes, plain=plain)
    s1, s2 = sums[:, 0], sums[:, 1]
    return stats_from_partials(s1.reshape(flat.shape[:-1]),
                               s2.reshape(flat.shape[:-1]), d)


def flat_partial_stats(flat: Tensor, *, plain: bool = False
                       ) -> Tuple[Tensor, Tensor]:
    """Partial sums (s1, s2) = (sum g, sum g^2) over the last axis of a
    model-sharded flat gradient [..., d_loc] (each rank's column block):
    one `grad_stats` launch over the [prod(...), d_loc] rows.  The sweep
    adds them over the "model" ranks (two scalars a row) and finishes with
    `stats_from_partials(s1, s2, d)`, d the real, unpadded D.  Ghost
    columns are zeros and add exactly 0.0; the ranks' partials are added in
    the backend's order, another reduction tree than one sum over the whole
    row, so the stats agree with `flat_scalar_stats` to f32 rounding, not
    bitwise (strict_numerics gathers full rows instead)."""
    d = flat.shape[-1]
    sums = ops.grad_stats(flat.reshape(-1, d), plain=plain)
    lead = flat.shape[:-1]
    return sums[:, 0].reshape(lead), sums[:, 1].reshape(lead)


def stats_from_partials(s1: Tensor, s2: Tensor, d: int
                        ) -> Tuple[Tensor, Tensor]:
    """Mean/variance epilogue on already-reduced sums (with the reference's
    1e-20 variance floor); `d` is the real entry count."""
    gbar = s1 / d
    eps2 = torch.clamp_min(s2 / d - gbar**2, 1e-20)
    return gbar, eps2


def global_stats(gbar_i: Tensor, eps2_i: Tensor) -> Tuple[Tensor, Tensor]:
    """PS-side averaging over the last (worker) axis: gbar_t = mean_i gbar_i,
    eps_t^2 = mean_i eps2_i."""
    return gbar_i.mean(dim=-1), eps2_i.mean(dim=-1)


def participation_scale(mask: Tensor, dtype=torch.float32) -> Tensor:
    """U / (participating workers) over the last axis of a [..., U] mask."""
    cnt = mask.to(dtype).sum(dim=-1)
    # a true divide: torch computes u / cnt as u * (1 / cnt)
    return torch.full_like(cnt, mask.shape[-1]) / cnt


def masked_global_stats(gbar_i: Tensor, eps2_i: Tensor, mask: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """`global_stats` over the participating workers only (K-of-U sampling:
    non-participants never report).  Spelled mean(where(mask, x, 0)) *
    (U / count), as in the reference, so a full mask scales by exactly 1.0."""
    scale = participation_scale(mask)
    return (torch.where(mask, gbar_i, 0.0).mean(dim=-1) * scale,
            torch.where(mask, eps2_i, 0.0).mean(dim=-1) * scale)


def standardize(tree: Dict[str, Tensor], gbar: Tensor, eps2: Tensor
                ) -> Dict[str, Tensor]:
    """eq. (3): (g - gbar 1) / eps, elementwise over the dict."""
    inv = torch.rsqrt(eps2)
    return tree_map(lambda g: (g - gbar) * inv, tree)


def destandardize(tree: Dict[str, Tensor], coeff_sum: Tensor, gbar: Tensor,
                  eps2: Tensor) -> Dict[str, Tensor]:
    """eq. (7): eps * y + coeff_sum * gbar * 1, elementwise over the dict."""
    eps = torch.sqrt(eps2)
    return tree_map(lambda y: eps * y + coeff_sum * gbar, tree)

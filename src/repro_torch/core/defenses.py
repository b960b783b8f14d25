"""Digital-FL Byzantine-robust aggregation (the paper's §I related work).

The paper's point is that screening defenses need the individual local
gradients, which analog aggregation hides.  The digital comparison mode
gathers them, so a sweep can set the analog scheme beside:

  coordinate-wise median           [Yin et al. 2018]
  coordinate-wise trimmed mean     [Yin et al. 2018]
  Krum / Multi-Krum                [Blanchard et al. 2017]
  geometric median (Weiszfeld)     [Minsker 2015 / RFA]

The counterpart of `repro/core/defenses.py`, over a leading lane axis: each
`flat_*` function maps a [..., U, D] per-worker gradient slab (one lane, or
the [S_g, U, D] sub-slab of a lane group) to its [..., D] aggregate, with
the hyper-parameters trim / f / multi as per-lane int tensors [...] (or
Python ints), reduced under index masks rather than Python slices, as in
the reference.  Their bounds are checked in the config layer
(`scenario.DefenseSpec.validate`).

Median and trimmed mean sort each column over the worker axis through the
port's CUDA sort kernels (`sorted_columns`).  Krum's pairwise distances and
the geometric median's norms are plain tensor math in the reference, outside
any Pallas kernel, and stay PyTorch calls here.

Not in this slice: the masked (K-of-U participation) twins (ROADMAP.md
Queue 1 item 6), the per-lane switch selector that only the switch dispatch
reaches (item 7), and the pytree `digital_aggregate` (with `FLTrainer`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.scenario import DEFENSE_CODES
from repro_torch.kernels import ops

Tensor = torch.Tensor

# Defense families by data layout: column-wise defenses reduce each of the D
# coordinates over the worker axis on its own; the row-geometry defenses
# score whole [D] rows by pairwise distance.
COLUMNWISE_CODES = frozenset(
    DEFENSE_CODES[n] for n in ("mean", "median", "trimmed_mean"))
ROW_GEOMETRY_CODES = frozenset(
    DEFENSE_CODES[n] for n in ("krum", "multi_krum", "geometric_median"))

# Worker-axis routing of the column sort: up to this U the unrolled
# odd-even kernel, above it the bitonic kernel while U padded to a power of
# two fits its shared-memory cap (ops.BITONIC_MAX_U = 8192, the reference's
# cap).  There is no D threshold: the reference's SORT_KERNEL_MIN_D = 2^14
# was measured for a TPU, and the port takes the kernel at every D on the
# card.
SORT_UNROLL_MAX_U = ops.UNROLL_MAX_U
_Q_LARGE_U_SORT = ("ROADMAP.md Queue 2 item 6 (a sort past the bitonic "
                   "kernel's shared-memory tile)")


def sort_route(u: int) -> Optional[str]:
    """The sort kernel `sorted_columns` launches on the card for U workers:
    "sort_columns", "sort_columns_bitonic", or None above the bitonic
    cap, where no kernel exists yet."""
    if u <= SORT_UNROLL_MAX_U:
        return "sort_columns"
    if 1 << max(u - 1, 0).bit_length() <= ops.BITONIC_MAX_U:
        return "sort_columns_bitonic"
    return None


def sorted_columns(flat: Tensor, *, plain: bool = False) -> Tensor:
    """[..., U, D] -> the same, ascending over the worker axis: the
    screening primitive that coordinate median and trimmed mean share.

    On the card the sort is the kernel `sort_route(U)` names; above the
    bitonic cap it raises NotImplementedError.  CPU tensors (and
    plain=True) take the plain versions at every U."""
    route = sort_route(flat.shape[-2])
    if route is not None:
        return ops.KERNELS[route](flat.contiguous(), plain=plain)
    if flat.device.type == "cuda" and not plain:
        raise NotImplementedError(
            f"sorted_columns: U={flat.shape[-2]} pads past BITONIC_MAX_U="
            f"{ops.BITONIC_MAX_U}; no sort kernel covers it yet — "
            f"{_Q_LARGE_U_SORT}")
    return torch.sort(flat, dim=-2).values


def _per_lane(x, like: Tensor) -> Tensor:
    """A per-lane hyper-parameter (int or [...] tensor) as a tensor on
    `like`'s device, with a trailing axis to broadcast against [..., U]."""
    return torch.as_tensor(x, device=like.device)[..., None]


def flat_mean(flat: Tensor) -> Tensor:
    return flat.mean(dim=-2)


def flat_median(flat: Tensor, *, plain: bool = False) -> Tensor:
    # (srt[(u-1)//2] + srt[u//2]) / 2: the middle element for odd U
    # ((x + x) / 2 is exact), the two-middle average for even U.
    u = flat.shape[-2]
    srt = sorted_columns(flat, plain=plain)
    return (srt[..., (u - 1) // 2, :] + srt[..., u // 2, :]) / 2


def flat_trimmed_mean(flat: Tensor, trim, *, plain: bool = False) -> Tensor:
    """Drop the `trim` largest and smallest per coordinate, then mean.

    trim is an int or a per-lane [...] int tensor: the sorted columns are
    reduced under an index mask, so lanes with different trims share one
    launch.  Python ints are range-checked here; tensors are the config
    layer's job (`DefenseSpec.validate`)."""
    u = flat.shape[-2]
    if isinstance(trim, int) and not 0 <= 2 * trim < u:
        raise ValueError(
            f"trimmed_mean trim={trim} invalid for U={u}: need 0 <= 2*trim < U")
    srt = sorted_columns(flat, plain=plain)
    t = _per_lane(trim, flat)
    idx = torch.arange(u, device=flat.device)
    keep = (idx >= t) & (idx < u - t)                         # [..., U]
    kept = torch.where(keep[..., None], srt, 0.0).sum(dim=-2)
    return kept / (u - 2 * t)


def _prefix_sum(srt: Tensor, closest: Tensor) -> Tensor:
    """Sum of the first `closest` entries of each sorted row of [..., B, U]
    (closest [...], per lane)."""
    j = torch.arange(srt.shape[-1], device=srt.device)
    return torch.where(j < closest[..., None, None], srt, 0.0).sum(dim=-1)


def _krum_scores(flat: Tensor, num_byzantine) -> Tensor:
    """score_i = sum of the max(U-f-2, 1) smallest squared distances from
    worker i to the others; [..., U, D] -> [..., U].

    The broadcast difference is a [..., U, U, D] intermediate: the small-U
    path only (`flat_krum` takes `_krum_scores_blocked` from
    KRUM_BLOCK_MIN_U on)."""
    u = flat.shape[-2]
    closest = torch.clamp_min(u - _per_lane(num_byzantine, flat)[..., 0] - 2,
                              1)
    diff = flat[..., :, None, :] - flat[..., None, :, :]
    d2 = (diff * diff).sum(dim=-1)                             # [..., U, U]
    # Exclude self with a boolean mask: adding eye * inf would put
    # 0 * inf = NaN on every off-diagonal entry, and every score with it.
    eye = torch.eye(u, dtype=torch.bool, device=flat.device)
    d2 = torch.where(eye, torch.inf, d2)
    srt = torch.sort(d2, dim=-1).values  # self's inf lands in the last column
    # closest <= U-2, so the masked prefix never reaches the inf column.
    return _prefix_sum(srt, closest)


# From this U on, Krum scores one [KRUM_BLOCK_ROWS, U] distance block at a
# time: neither the [U, U, D] broadcast nor the whole [U, U] matrix is held.
KRUM_BLOCK_MIN_U = 64
KRUM_BLOCK_ROWS = 128


def _krum_scores_blocked(flat: Tensor, num_byzantine,
                         block_rows: int = KRUM_BLOCK_ROWS) -> Tensor:
    """`_krum_scores` for large U, one [..., B, U] distance block at a time:
    d2 = |x_b|^2 + |x|^2 - 2 x_b x^T through a matmul (true f32 on the card:
    TF32 would shift the scores by ~1e-3 and could flip a selection),
    clamped at 0, self-distances masked to +inf by global row id, each row
    sorted and prefix-reduced as on the small-U path.  The expanded form
    rounds differently from the direct (x-y)^2 sum, so the two paths agree
    to rtol, not bitwise."""
    u = flat.shape[-2]
    closest = torch.clamp_min(u - _per_lane(num_byzantine, flat)[..., 0] - 2,
                              1)
    sq = (flat * flat).sum(dim=-1)                                 # [..., U]
    flat_t = flat.transpose(-1, -2)
    cols = torch.arange(u, device=flat.device)
    scores = []
    for r0 in range(0, u, block_rows):
        r1 = min(r0 + block_rows, u)
        xb = flat[..., r0:r1, :]
        d2 = sq[..., r0:r1, None] + sq[..., None, :] - 2.0 * (xb @ flat_t)
        d2 = torch.clamp_min(d2, 0.0)
        rows = torch.arange(r0, r1, device=flat.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        scores.append(_prefix_sum(torch.sort(d2, dim=-1).values, closest))
    return torch.cat(scores, dim=-1)


def flat_krum(flat: Tensor, num_byzantine, multi=1) -> Tensor:
    """(Multi-)Krum: the mean of the `multi` lowest-scoring workers'
    gradients; num_byzantine and multi are ints or per-lane tensors.  Ties
    rank in worker order (a stable argsort, as jnp.argsort is)."""
    u = flat.shape[-2]
    scores = (_krum_scores_blocked(flat, num_byzantine)
              if u >= KRUM_BLOCK_MIN_U
              else _krum_scores(flat, num_byzantine))
    order = torch.argsort(scores, dim=-1, stable=True)        # best first
    ranked = torch.gather(flat, -2, order[..., None].expand(flat.shape))
    m = _per_lane(multi, flat)
    keep = torch.arange(u, device=flat.device) < m             # [..., U]
    sel = torch.where(keep[..., None], ranked, 0.0).sum(dim=-2)
    return sel / m.to(flat.dtype)


def flat_geometric_median(flat: Tensor, iters: int = 8,
                          eps: float = 1e-8) -> Tensor:
    """Weiszfeld iterations from the mean, weights 1 / max(|x_i - z|, eps)."""
    z = flat.mean(dim=-2)
    for _ in range(iters):
        w = 1.0 / torch.clamp_min(
            torch.linalg.vector_norm(flat - z[..., None, :], dim=-1), eps)
        z = (w[..., None] * flat).sum(dim=-2) / w.sum(dim=-1)[..., None]
    return z


# code -> flat kernel over (flat, trim, f, multi, gm_iters, plain).  Code 0
# (analog FLOA) maps to the mean, as in the reference's table; the grouped
# engine never runs a digital kernel for the analog group.
_FLAT_KERNELS_BY_CODE: Dict[int, Callable] = {
    DEFENSE_CODES["floa"]: lambda f, t, nb, m, it, pl: flat_mean(f),
    DEFENSE_CODES["mean"]: lambda f, t, nb, m, it, pl: flat_mean(f),
    DEFENSE_CODES["median"]:
        lambda f, t, nb, m, it, pl: flat_median(f, plain=pl),
    DEFENSE_CODES["trimmed_mean"]:
        lambda f, t, nb, m, it, pl: flat_trimmed_mean(f, t, plain=pl),
    DEFENSE_CODES["krum"]: lambda f, t, nb, m, it, pl: flat_krum(f, nb, m),
    DEFENSE_CODES["multi_krum"]:
        lambda f, t, nb, m, it, pl: flat_krum(f, nb, m),
    DEFENSE_CODES["geometric_median"]:
        lambda f, t, nb, m, it, pl: flat_geometric_median(f, iters=it),
}


def make_group_defense_kernel(code: int, gm_iters: int = 8, *,
                              plain: bool = False) -> Callable:
    """One defense family's kernel for a lane group (`build_lane_groups`):
    fn(flat [S_g, U, D], trim, f, multi each [S_g]) -> [S_g, D].  `code` is
    a Python int, so no other family runs; per-lane math is the table
    entry's.  plain=True sends the sorts to their plain versions (the
    engine's force_plain)."""
    return functools.partial(_FLAT_KERNELS_BY_CODE[int(code)], it=gm_iters,
                             pl=plain)

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

The masked twins (`flat_masked_*`) serve K-of-U participation: a [..., U]
bool mask keeps the round's participating rows, and each twin reduces to
its unmasked form at a full mask.  Median and trimmed mean pad the
non-participants with +inf and sort through the same kernels.

The pytree API (`digital_aggregate` and the named wrappers) flattens a
{name: [U, ...]} gradient dict to the slab, runs the flat function, and
unravels: the digital `FLTrainer`'s entry point.

The switch dispatch (`make_flat_defense_selector`, the sweep's
grouped_dispatch=False reference) runs every family present once over all
lanes, through the same kernels, and keeps each lane's own family's row.
"""
from __future__ import annotations

import functools
import logging
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.aggregation import flatten_worker_grads, mean_aggregate
from repro_torch.core.scenario import DEFENSE_CODES
from repro_torch.core.standardize import participation_scale
from repro_torch.kernels import ops

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

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
# cap), and past the cap `torch.sort`, as the reference takes `jnp.sort`
# there.  There is no D threshold: the reference's SORT_KERNEL_MIN_D = 2^14
# was measured for a TPU, and the port takes the kernel at every D on the
# card.
SORT_UNROLL_MAX_U = ops.UNROLL_MAX_U


def sort_route(u: int) -> Optional[str]:
    """The sort kernel `sorted_columns` launches on the card for U workers:
    "sort_columns", "sort_columns_bitonic", or None above the bitonic
    cap, where the sort is `torch.sort`."""
    if u <= SORT_UNROLL_MAX_U:
        return "sort_columns"
    if 1 << max(u - 1, 0).bit_length() <= ops.BITONIC_MAX_U:
        return "sort_columns_bitonic"
    return None


def sorted_columns(flat: Tensor, *, plain: bool = False) -> Tensor:
    """[..., U, D] -> the same, ascending over the worker axis: the
    screening primitive that coordinate median and trimmed mean share.

    The sort is the kernel `sort_route(U)` names (its plain version on CPU
    tensors, or with plain=True).  Above the bitonic cap no kernel exists
    and every device takes `torch.sort`; on the card that route is logged
    once per process, as the reference logs its `jnp.sort` route."""
    u = flat.shape[-2]
    route = sort_route(u)
    if route is not None:
        return ops.KERNELS[route](flat.contiguous(), plain=plain)
    if flat.device.type == "cuda" and not plain:
        _log_sort_fallback_once(u)
    return torch.sort(flat, dim=-2).values


_sort_fallback_logged = False


def _log_sort_fallback_once(u: int) -> None:
    """The large-U route notice, once per process: U padded to a power of
    two exceeds the bitonic kernel's cap, so the card sorts with
    `torch.sort`.  Logged, not warned: the test suite turns warnings into
    errors, and this is routing telemetry, not a correctness hazard."""
    global _sort_fallback_logged
    if not _sort_fallback_logged:
        _sort_fallback_logged = True
        logger.warning(
            "sorted_columns: U=%d pads past BITONIC_MAX_U=%d — no "
            "sorting-network kernel exists at this U, falling back to "
            "torch.sort. Logged once per process.", u, ops.BITONIC_MAX_U)


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
    return _mean_of_best(flat, scores, multi)


def flat_geometric_median(flat: Tensor, iters: int = 8,
                          eps: float = 1e-8) -> Tensor:
    """Weiszfeld iterations from the mean, weights 1 / max(|x_i - z|, eps)."""
    z = flat.mean(dim=-2)
    for _ in range(iters):
        w = 1.0 / torch.clamp_min(
            torch.linalg.vector_norm(flat - z[..., None, :], dim=-1), eps)
        z = (w[..., None] * flat).sum(dim=-2) / w.sum(dim=-1)[..., None]
    return z


def _rows_at(srt: Tensor, idx: Tensor) -> Tensor:
    """Row idx[...] of each lane's sorted [..., U, D] slab -> [..., D]."""
    ix = idx[..., None, None].expand(*srt.shape[:-2], 1, srt.shape[-1])
    return torch.gather(srt, -2, ix)[..., 0, :]


def flat_masked_mean(flat: Tensor, mask: Tensor) -> Tensor:
    """Mean of the participating rows (flat_mean at a full mask)."""
    scale = participation_scale(mask, flat.dtype)
    return (torch.where(mask[..., None], flat, 0.0).mean(dim=-2)
            * scale[..., None])


def flat_masked_median(flat: Tensor, mask: Tensor, *,
                       plain: bool = False) -> Tensor:
    """Coordinate median over the participating rows: non-participants are
    +inf, so the sort puts them last, and the middle rows come from the
    lane's participant count."""
    srt = sorted_columns(torch.where(mask[..., None], flat, torch.inf),
                         plain=plain)
    cnt = mask.sum(dim=-1)
    return (_rows_at(srt, (cnt - 1) // 2) + _rows_at(srt, cnt // 2)) / 2


def flat_masked_trimmed_mean(flat: Tensor, trim, mask: Tensor, *,
                             plain: bool = False) -> Tensor:
    """Trimmed mean over the participating rows: drop the `trim` largest
    and smallest participating values per coordinate, mean the rest."""
    u = flat.shape[-2]
    srt = sorted_columns(torch.where(mask[..., None], flat, torch.inf),
                         plain=plain)
    cnt = mask.sum(dim=-1)[..., None]
    t = _per_lane(trim, flat)
    idx = torch.arange(u, device=flat.device)
    keep = (idx >= t) & (idx < cnt - t)
    kept = torch.where(keep[..., None], srt, 0.0).sum(dim=-2)
    return kept / (cnt - 2 * t)


def _masked_closest(mask: Tensor, num_byzantine, like: Tensor) -> Tensor:
    return torch.clamp_min(
        mask.sum(dim=-1) - _per_lane(num_byzantine, like)[..., 0] - 2, 1)


def _masked_krum_scores(flat: Tensor, num_byzantine, mask: Tensor
                        ) -> Tensor:
    """`_krum_scores` over the participating rows: distances to or from a
    non-participant are +inf, the closest-count comes from the participant
    count, and non-participants score +inf."""
    u = flat.shape[-2]
    closest = _masked_closest(mask, num_byzantine, flat)
    diff = flat[..., :, None, :] - flat[..., None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    eye = torch.eye(u, dtype=torch.bool, device=flat.device)
    pair_ok = mask[..., :, None] & mask[..., None, :] & ~eye
    d2 = torch.where(pair_ok, d2, torch.inf)
    scores = _prefix_sum(torch.sort(d2, dim=-1).values, closest)
    return torch.where(mask, scores, torch.inf)


def _masked_krum_scores_blocked(flat: Tensor, num_byzantine, mask: Tensor,
                                block_rows: int = KRUM_BLOCK_ROWS) -> Tensor:
    """`_krum_scores_blocked` with the participation mask applied per block:
    non-participants' columns +inf before the row sort, their rows +inf
    after."""
    u = flat.shape[-2]
    closest = _masked_closest(mask, num_byzantine, flat)
    sq = (flat * flat).sum(dim=-1)
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
        d2 = torch.where(mask[..., None, :], d2, torch.inf)
        scores.append(_prefix_sum(torch.sort(d2, dim=-1).values, closest))
    return torch.where(mask, torch.cat(scores, dim=-1), torch.inf)


def _mean_of_best(flat: Tensor, scores: Tensor, multi) -> Tensor:
    """The mean of the `multi` lowest-scoring rows (stable ranking)."""
    u = flat.shape[-2]
    order = torch.argsort(scores, dim=-1, stable=True)        # best first
    ranked = torch.gather(flat, -2, order[..., None].expand(flat.shape))
    m = _per_lane(multi, flat)
    keep = torch.arange(u, device=flat.device) < m             # [..., U]
    sel = torch.where(keep[..., None], ranked, 0.0).sum(dim=-2)
    return sel / m.to(flat.dtype)


def flat_masked_krum(flat: Tensor, num_byzantine, multi, mask: Tensor
                     ) -> Tensor:
    """(Multi-)Krum over the participating rows (flat_krum's large-U
    routing); non-participants score +inf, and multi <= K (checked by the
    sweep spec) keeps them out of the mean."""
    u = flat.shape[-2]
    scores = (_masked_krum_scores_blocked(flat, num_byzantine, mask)
              if u >= KRUM_BLOCK_MIN_U
              else _masked_krum_scores(flat, num_byzantine, mask))
    return _mean_of_best(flat, scores, multi)


def flat_masked_geometric_median(flat: Tensor, mask: Tensor, iters: int = 8,
                                 eps: float = 1e-8) -> Tensor:
    """Weiszfeld over the participating rows: non-participants weigh 0, and
    the iteration starts from the participants' mean."""
    z = flat_masked_mean(flat, mask)
    for _ in range(iters):
        w = torch.where(mask, 1.0 / torch.clamp_min(
            torch.linalg.vector_norm(flat - z[..., None, :], dim=-1), eps),
            0.0)
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

# The masked twins, over (flat, trim, f, multi, mask, gm_iters, plain).
_MASKED_FLAT_KERNELS_BY_CODE: Dict[int, Callable] = {
    DEFENSE_CODES["floa"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_mean(f, pk),
    DEFENSE_CODES["mean"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_mean(f, pk),
    DEFENSE_CODES["median"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_median(f, pk, plain=pl),
    DEFENSE_CODES["trimmed_mean"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_trimmed_mean(
            f, t, pk, plain=pl),
    DEFENSE_CODES["krum"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_krum(f, nb, m, pk),
    DEFENSE_CODES["multi_krum"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_krum(f, nb, m, pk),
    DEFENSE_CODES["geometric_median"]:
        lambda f, t, nb, m, pk, it, pl: flat_masked_geometric_median(
            f, pk, iters=it),
}


def make_group_defense_kernel(code: int, gm_iters: int = 8,
                              masked: bool = False, *,
                              plain: bool = False) -> Callable:
    """One defense family's kernel for a lane group (`build_lane_groups`):
    fn(flat [S_g, U, D], trim, f, multi each [S_g]) -> [S_g, D], with a
    trailing [S_g, U] bool participation mask when masked=True.  `code` is
    a Python int, so no other family runs; per-lane math is the table
    entry's.  plain=True sends the sorts to their plain versions (the
    engine's force_plain)."""
    table = _MASKED_FLAT_KERNELS_BY_CODE if masked else _FLAT_KERNELS_BY_CODE
    return functools.partial(table[int(code)], it=gm_iters, pl=plain)


def make_flat_defense_selector(codes: Optional[Sequence[int]] = None,
                               gm_iters: int = 8, masked: bool = False, *,
                               plain: bool = False) -> Callable:
    """The per-lane defense switch over the codes present in a sweep (the
    reference's vmapped `lax.switch`, which computes every listed branch
    for every lane and then selects).

    Returns fn(code [S], flat [S, U, D], trim, f, multi each [S]) -> [S, D],
    with a trailing [S, U] bool participation mask when masked=True: each
    family in `codes` (default: all of DEFENSE_CODES) runs once over all S
    lanes through its group kernel (`make_group_defense_kernel`, so the
    sorts and Krum's blocked distances take the grouped path's routes),
    and lane s keeps the row of its own code's family.  Codes outside the
    list (the analog lanes' 0 in a digital-only list) take the first
    branch; the caller overrides those lanes.  plain=True sends the sorts
    to their plain versions."""
    if codes is None:
        codes = sorted(DEFENSE_CODES.values())
    codes = sorted({int(c) for c in codes})
    if not codes:
        raise ValueError("empty defense-code set")
    lookup = torch.zeros(max(DEFENSE_CODES.values()) + 1, dtype=torch.long)
    for i, c in enumerate(codes):
        lookup[c] = i
    branches = [make_group_defense_kernel(c, gm_iters, masked, plain=plain)
                for c in codes]
    placed: Dict[torch.device, Tensor] = {}   # the lookup, by device

    def select(code: Tensor, flat: Tensor, trim, num_byzantine, multi,
               *mask) -> Tensor:
        rows = [branch(flat, trim, num_byzantine, multi, *mask)
                for branch in branches]
        if code.device not in placed:   # once: a CUDA graph copies nothing
            placed[code.device] = lookup.to(code.device)
        idx = placed[code.device][code.long()]
        out = rows[0]
        for i, row in enumerate(rows[1:], start=1):
            out = torch.where((idx == i)[:, None], row, out)
        return out

    return select


# ----------------------------------------------------------- pytree wrappers
# Each flattens the (nested) {name: [U, ...]} gradients to the [U, D] slab
# in the JAX package's leaf order and unravels the [D] aggregate back.


def coordinate_median(grads_u, *, plain: bool = False):
    flat, unravel = flatten_worker_grads(grads_u)
    return unravel(flat_median(flat, plain=plain))


def trimmed_mean(grads_u, trim: int = 1, *, plain: bool = False):
    """Remove the `trim` largest and smallest per coordinate, then mean."""
    flat, unravel = flatten_worker_grads(grads_u)
    return unravel(flat_trimmed_mean(flat, trim, plain=plain))


def krum(grads_u, num_byzantine: int, multi: int = 1, *,
         plain: bool = False):
    """(Multi-)Krum: the mean of the `multi` lowest-scoring workers."""
    flat, unravel = flatten_worker_grads(grads_u)
    return unravel(flat_krum(flat, num_byzantine, multi))


def geometric_median(grads_u, iters: int = 8, eps: float = 1e-8, *,
                     plain: bool = False):
    """Weiszfeld iterations for the geometric median."""
    flat, unravel = flatten_worker_grads(grads_u)
    return unravel(flat_geometric_median(flat, iters=iters, eps=eps))


DEFENSES: Dict[str, Callable] = {
    "median": coordinate_median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
    "geometric_median": geometric_median,
    "mean": lambda grads_u, plain=False: mean_aggregate(grads_u),
}


def digital_aggregate(grads_u, defense: str = "mean", *, plain: bool = False,
                      **kw):
    """Gather-based digital aggregation with a named defense; `plain` sends
    the sorts to their plain versions (kernel-vs-plain checks only)."""
    return DEFENSES[defense](grads_u, plain=plain, **kw)

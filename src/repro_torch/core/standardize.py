"""Gradient standardization for analog transmission (paper §II-B, eq. 3 & 7).

Before each round every worker estimates the scalar mean/variance of its own
gradient (over the D entries), the PS averages them into global stats
(gbar_t, eps_t^2), broadcasts them back, and workers transmit

    gtilde_i = (g_i - gbar_t * 1) / eps_t .                  (eq. 3)

The PS de-standardizes the received superposition y_t as

    gagg = eps_t * y_t + (sum_i p_i |h_i|) * gbar_t * 1 .    (eq. 7)

The per-worker sums come off the flat gradient rows in one pass through the
`grad_stats` kernel (its plain version on the CPU); the mean/variance
epilogue runs on scalars.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


def flat_scalar_stats(flat: Tensor, *, plain: bool = False
                      ) -> Tuple[Tensor, Tensor]:
    """(gbar_i, eps2_i) per flat gradient row: flat [..., D] -> two [...]
    tensors, the per-row mean and (biased) variance of the D entries.

    All rows go through ONE `grad_stats` launch over the [prod(...), D]
    view, so flat must be contiguous.  `plain` forces the kernel's plain
    version (kernel-vs-plain tests only)."""
    d = flat.shape[-1]
    sums = ops.grad_stats(flat.reshape(-1, d), plain=plain)
    s1 = sums[:, 0].reshape(flat.shape[:-1])
    s2 = sums[:, 1].reshape(flat.shape[:-1])
    return stats_from_partials(s1, s2, d)


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

"""Byzantine attack models (paper §III-B, Thm 1).

The strongest attack (Thm 1): attacker n transmits its own sign-flipped,
unstandardized gradient ghat = -g at the maximum power the accounting allows,

    phat_{n,t} = sqrt( p_n^max / (D (gbar_t^2 + eps_t^2)) )   (eq. 18)

while reporting truthful scalar stats, so the PS's de-standardization bias
p_n |h_n| gbar_t does not cancel for it.

Ablations: GAUSSIAN (white noise at max power), SIGN_FLIP_PROTOCOL_POWER (-g
at protocol power), NONE.  The adaptive COLLUDING / OMNISCIENT cohorts are
named here and their received weights are defined, because
`core.scenario.scenario_coefficients` evaluates them for every lane; the
port's sweep refuses lanes that use them (see ROADMAP.md).

Helpers take per-worker arrays [..., U] and per-lane scalars [...] (dim,
gbar, eps2) and reduce over the last axis, like `core.power_control`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

from repro_torch.core.power_control import per_worker

Tensor = torch.Tensor


class AttackType(str, enum.Enum):
    NONE = "none"
    STRONGEST = "strongest"  # Thm 1: sign flip at max accounting power
    SIGN_FLIP_PROTOCOL_POWER = "sign_flip_protocol_power"
    GAUSSIAN = "gaussian"
    COLLUDING = "colluding"    # shared rank-1 direction at max power
    OMNISCIENT = "omniscient"  # negated honest mean at eq. 18 max power


# Attacks whose payload is one shared direction (rank-1 across the cohort).
DIRECTIONAL_ATTACKS = (AttackType.COLLUDING, AttackType.OMNISCIENT)


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """byzantine_mask: tuple of U bools, True = worker is Byzantine."""

    attack: AttackType = AttackType.NONE
    byzantine_mask: Tuple[bool, ...] = ()

    @property
    def num_attackers(self) -> int:
        return int(sum(self.byzantine_mask))

    def mask(self) -> Tensor:
        return torch.as_tensor(self.byzantine_mask, dtype=torch.bool)


def first_n_mask(num_workers: int, n: int) -> Tuple[bool, ...]:
    return tuple(i < n for i in range(num_workers))


def strongest_attack_amplitude(p_max: Tensor, dim, gbar, eps2) -> Tensor:
    """phat_n of eq. (18): p_max [..., U]; dim, gbar, eps2 per lane [...]."""
    return torch.sqrt(p_max / (per_worker(dim)
                               * (per_worker(gbar)**2 + per_worker(eps2))))


def jam_std_arrays(h_abs: Tensor, p_maxes: Tensor, dim, mask: Tensor,
                   eps2) -> Tensor:
    """GAUSSIAN jamming std: max-power white noise from masked workers,
    scaled by eps_t."""
    amp = torch.sqrt(p_maxes / per_worker(dim)) * h_abs  # max power jam
    return torch.sqrt(eps2 * (torch.where(mask, amp, 0.0) ** 2).sum(dim=-1))


def colluding_dir_weight(h_abs: Tensor, p_maxes: Tensor, dim, mask: Tensor,
                         eps2) -> Tensor:
    """Received weight of the COLLUDING cohort's shared unit-RMS direction:
    eps_t * sum_{n in B} |h_n| sqrt(p_n^max / D)."""
    amp = torch.sqrt(p_maxes / per_worker(dim))
    return torch.sqrt(eps2) * torch.where(mask, amp * h_abs, 0.0).sum(dim=-1)


def omniscient_dir_weight(h_abs: Tensor, p_maxes: Tensor, dim, mask: Tensor,
                          gbar, eps2) -> Tensor:
    """Received weight of the OMNISCIENT cohort's negated honest mean:
    sum_{n in B} (-eps_t phat_n |h_n|)."""
    phat = strongest_attack_amplitude(p_maxes, dim, gbar, eps2)
    return -torch.sqrt(eps2) * torch.where(mask, phat * h_abs, 0.0).sum(dim=-1)

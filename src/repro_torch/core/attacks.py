"""Byzantine attack models (paper §III-B, Thm 1).

The strongest attack (Thm 1): attacker n transmits its own sign-flipped,
unstandardized gradient ghat = -g at the maximum power the accounting allows,

    phat_{n,t} = sqrt( p_n^max / (D (gbar_t^2 + eps_t^2)) )   (eq. 18)

while reporting truthful scalar stats, so the PS's de-standardization bias
p_n |h_n| gbar_t does not cancel for it.

Ablations: GAUSSIAN (white noise at max power), SIGN_FLIP_PROTOCOL_POWER (-g
at protocol power), NONE.

Adaptive cohorts, whose payload is one shared rank-1 direction: COLLUDING
(a cohort-common unit-RMS direction at max power) and OMNISCIENT (the
negated honest mean at the eq. 18 power).  Their received weights are
defined here; the direction itself needs round state, so the sweep
(fl/sweep.py) injects it after the OTA combine, and the stateless
`signed_coefficients` path models only their (zero) per-worker payload and
their bias.

The `*_arrays` / `*_weight` helpers take per-worker arrays [..., U] and
per-lane scalars [...] (dim, gbar, eps2) and reduce over the last axis, like
`core.power_control`; `signed_coefficients` and `gaussian_jam_std` are the
dataclass path of one scenario ([U] arrays), which `core.aggregation`
uses.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import (PowerConfig, per_worker,
                                            placed_amplitudes,
                                            transmit_amplitudes)

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


def placed_constants(power: PowerConfig, channel: ChannelConfig,
                     attack: AttackConfig, device) -> Dict[str, Tensor]:
    """The host-side constants `signed_coefficients` reads (the attack
    mask, the power caps, `power_control.placed_amplitudes`), placed on
    `device` once, with the same values: a step captured in a CUDA graph
    may copy nothing from the host."""
    return {"mask": attack.mask().to(device),
            "p_maxes": power.p_maxes().to(device),
            **placed_amplitudes(power, channel, device)}


def signed_coefficients(h_abs: Tensor, power: PowerConfig,
                        channel: ChannelConfig, attack: AttackConfig,
                        gbar: Tensor, eps2: Tensor,
                        placed: Optional[Dict[str, Tensor]] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Per-worker signed payload coefficients and the de-standardization
    bias weight of one scenario: (s [U], bias_w []).

      s[i]    multiplies worker i's raw gradient in the aggregate: p_i |h_i|
              if honest, -eps_t phat_n |h_n| for a strongest attacker
              (eq. 7 with ghat = -g), -p_n |h_n| for a protocol-power sign
              flip, 0 for GAUSSIAN / COLLUDING / OMNISCIENT (no gradient
              payload).
      bias_w  sum over attackers of p_n |h_n|, multiplying gbar_t * 1: the
              PS de-standardizes as if every worker standardized, and only
              the sign-flip attackers did (their bias is 0).

    `placed`: `placed_constants` on h_abs's device (else made here).
    """
    dev = h_abs.device
    placed = placed or placed_constants(power, channel, attack, dev)
    eps = torch.sqrt(eps2)
    honest_s = transmit_amplitudes(h_abs, power, channel, placed) * h_abs
    mask = placed["mask"]
    if attack.attack == AttackType.NONE or attack.num_attackers == 0:
        return honest_s, torch.zeros((), device=dev)
    if attack.attack == AttackType.STRONGEST:
        phat = strongest_attack_amplitude(placed["p_maxes"],
                                          float(power.dim), gbar, eps2)
        attacker_s = -eps * phat * h_abs
    elif attack.attack == AttackType.SIGN_FLIP_PROTOCOL_POWER:
        attacker_s = -honest_s
    elif attack.attack in (AttackType.GAUSSIAN,) + DIRECTIONAL_ATTACKS:
        attacker_s = torch.zeros_like(honest_s)
    else:
        raise ValueError(f"unknown attack {attack.attack}")
    s = torch.where(mask, attacker_s, honest_s)
    if attack.attack == AttackType.SIGN_FLIP_PROTOCOL_POWER:
        return s, torch.zeros((), device=dev)
    return s, torch.where(mask, honest_s, 0.0).sum()


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


def gaussian_jam_std(h_abs: Tensor, power: PowerConfig, attack: AttackConfig,
                     eps2: Tensor) -> Tensor:
    """Std of the white noise GAUSSIAN attackers add, after
    de-standardization (scaled by eps_t like any received symbol); 0 for
    every other attack."""
    dev = h_abs.device
    if attack.attack != AttackType.GAUSSIAN or attack.num_attackers == 0:
        return torch.zeros((), device=dev)
    return jam_std_arrays(h_abs, power.p_maxes().to(dev), float(power.dim),
                          attack.mask().to(dev), eps2)

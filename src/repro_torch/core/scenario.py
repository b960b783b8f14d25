"""Scenario parameters as tensors: `FLOAConfig` as a struct of arrays.

`FLOAConfig` is a frozen dataclass whose policy/attack fields select Python
branches.  A sweep runs many scenarios (lanes) at once, so this module turns
each lane's config into tensors (enums -> int32 codes, masks/sigmas ->
vectors) that stack into one [S, ...] `ScenarioParams`, and re-derives
channel.py / power_control.py / attacks.py without branches: every
policy/attack formula is computed for every lane and the lane's own is
picked with `torch.where` on the codes.  The codes and formulas are those of
`repro/core/scenario.py`, so lane coefficients match the JAX package's.

Only the port's slice is here: full participation (the reference's
`part=None` branch) and no digital defense codes.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import attacks as A
from repro_torch.core.channel import rayleigh_gains
from repro_torch.core.power_control import (Policy, ci_b0_arrays,
                                            max_amplitude_arrays, per_worker)

Tensor = torch.Tensor

POLICY_CODES = {
    Policy.CI: 0,
    Policy.BEV: 1,
    Policy.EF: 2,
    Policy.TRUNCATED_CI: 3,
}
ATTACK_CODES = {
    A.AttackType.NONE: 0,
    A.AttackType.STRONGEST: 1,
    A.AttackType.SIGN_FLIP_PROTOCOL_POWER: 2,
    A.AttackType.GAUSSIAN: 3,
    A.AttackType.COLLUDING: 4,
    A.AttackType.OMNISCIENT: 5,
}
_CI, _BEV, _EF, _TCI = 0, 1, 2, 3
_NONE, _STRONGEST, _SIGN_FLIP, _GAUSSIAN = 0, 1, 2, 3
_COLLUDING, _OMNISCIENT = 4, 5


class ScenarioParams(NamedTuple):
    """One scenario's FLOA knobs as tensors, or S of them stacked on a
    leading lane axis (`stack`)."""

    policy: Tensor     # int32 [] — POLICY_CODES
    attack: Tensor     # int32 [] — ATTACK_CODES
    byz_mask: Tensor   # bool  [U]
    sigma: Tensor      # f32   [U] Rayleigh scales
    p_max: Tensor      # f32   [U] per-worker max power
    dim: Tensor        # f32   []  power-accounting gradient dim D (eq. 4)
    noise_std: Tensor  # f32   []  receiver AWGN std (0 under EF)
    alpha: Tensor      # f32   []  raw learning rate (eq. 8)


def from_floa(cfg, alpha: float) -> ScenarioParams:
    """FLOAConfig -> ScenarioParams (CPU tensors).

    EF scenarios get noise_std forced to 0 here: the branchless coefficients
    always add the noise term, so the std itself must be zero."""
    cfg.validate()
    u = cfg.num_workers
    mask = (cfg.attack.mask() if cfg.attack.byzantine_mask
            else torch.zeros((u,), dtype=torch.bool))
    is_ef = cfg.power.policy == Policy.EF
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)    # noqa: E731
    return ScenarioParams(
        policy=i32(POLICY_CODES[cfg.power.policy]),
        attack=i32(ATTACK_CODES[cfg.attack.attack]),
        byz_mask=mask,
        sigma=cfg.channel.sigmas(),
        p_max=cfg.power.p_maxes(),
        dim=f32(float(cfg.power.dim)),
        noise_std=f32(0.0 if is_ef else cfg.channel.noise_std),
        alpha=f32(alpha),
    )


def stack(params: Sequence[ScenarioParams], device=None) -> ScenarioParams:
    """[ScenarioParams] * S -> ScenarioParams with a leading S axis on every
    field, on `device`.  All scenarios must share U."""
    return ScenarioParams(*(torch.stack(xs).to(device)
                            for xs in zip(*params)))


def sample_gains(generators: Sequence[torch.Generator],
                 sp: ScenarioParams) -> Tensor:
    """|h_{s,i}| ~ Rayleigh(sp.sigma[s]), [S, U], lane s drawn from its own
    generator.  EF lanes draw too; `scenario_coefficients` ignores |h| there."""
    return torch.stack([rayleigh_gains(g, sig)
                        for g, sig in zip(generators, sp.sigma)])


def scenario_coefficients(
    h_abs: Tensor, sp: ScenarioParams, gbar: Tensor, eps2: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Branchless eq. (7) coefficients for one scenario or a stacked sweep.

    h_abs [..., U], sp fields [...] / [..., U], gbar/eps2 [...].  Returns
    (s, bias_w, jam_std, noise_std, dir_w):
      s [..., U]    signed per-worker payload coefficients
      bias_w [...]  de-standardization bias weight (x gbar x 1)
      jam_std [...] GAUSSIAN jamming noise std (0 unless that attack is on)
      noise_std [...] effective receiver AWGN std (0 under EF)
      dir_w [...]   received weight of a COLLUDING/OMNISCIENT cohort's
                    shared direction (0 for every other attack)
    """
    pw = per_worker
    u = sp.byz_mask.shape[-1]
    dim = sp.dim   # power-accounting D from the config, NOT the model's size
    is_ef = sp.policy == _EF
    mask = sp.byz_mask
    eps = torch.sqrt(eps2)

    # --- power_control.transmit_amplitudes, all policies at once.
    b0 = ci_b0_arrays(sp.p_max, sp.sigma, dim)
    ci_amp = pw(b0) / h_abs
    bev_amp = max_amplitude_arrays(sp.p_max, dim)
    policy = pw(sp.policy)
    amp = torch.where(policy == _CI, ci_amp,
                      torch.where(policy == _TCI,
                                  torch.minimum(ci_amp, bev_amp), bev_amp))
    honest_s = torch.where(pw(is_ef), 1.0 / u, amp * h_abs)

    # --- attacks: per-worker payload coefficients.
    phat = A.strongest_attack_amplitude(sp.p_max, dim, gbar, eps2)
    strongest_s = -pw(eps) * phat * h_abs
    attack = pw(sp.attack)
    attacker_s = torch.where(attack == _STRONGEST, strongest_s,
                             torch.where(attack == _SIGN_FLIP, -honest_s, 0.0))
    # EF models any active attacker as a sign-flipped mean share (-1/U).
    attacker_s = torch.where(pw(is_ef), -honest_s, attacker_s)
    active = sp.attack != _NONE
    s = torch.where(pw(active) & mask, attacker_s, honest_s)

    # PS de-standardizes assuming protocol power for every worker; attackers
    # that never standardized leave the bias behind.
    has_bias = active & ~is_ef & ((sp.attack == _STRONGEST)
                                  | (sp.attack == _GAUSSIAN)
                                  | (sp.attack == _COLLUDING)
                                  | (sp.attack == _OMNISCIENT))
    bias_w = torch.where(has_bias,
                         torch.where(mask, honest_s, 0.0).sum(dim=-1), 0.0)

    jam = A.jam_std_arrays(h_abs, sp.p_max, dim, mask, eps2)
    jam_std = torch.where(active & ~is_ef & (sp.attack == _GAUSSIAN), jam, 0.0)

    collude_w = A.colluding_dir_weight(h_abs, sp.p_max, dim, mask, eps2)
    omni_w = A.omniscient_dir_weight(h_abs, sp.p_max, dim, mask, gbar, eps2)
    directional = active & ~is_ef
    dir_w = torch.where(directional & (sp.attack == _COLLUDING), collude_w,
                        torch.where(directional & (sp.attack == _OMNISCIENT),
                                    omni_w, 0.0))

    noise_std = torch.where(is_ef, 0.0, sp.noise_std)
    return s, bias_w, jam_std, noise_std, dir_w

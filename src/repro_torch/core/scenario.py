"""Scenario parameters as tensors: `FLOAConfig` as a struct of arrays.

`FLOAConfig` is a frozen dataclass whose policy/attack fields select Python
branches.  A sweep runs many scenarios (lanes) at once, so this module turns
each lane's config into tensors (enums -> int32 codes, masks/sigmas ->
vectors) that stack into one [S, ...] `ScenarioParams`, and re-derives
channel.py / power_control.py / attacks.py without branches: every
policy/attack formula is computed for every lane and the lane's own is
picked with `torch.where` on the codes.  The codes and formulas are those of
`repro/core/scenario.py`, so lane coefficients match the JAX package's.

Also here: the defense-code lane axis (`DEFENSE_CODES`, `DefenseSpec`) and
the static partition of a sweep's lanes by defense code that the grouped
dispatch runs on (`LaneGroups`, `build_lane_groups`, `permute_lanes`).

Also the adaptive-adversary axes' per-lane knobs: Gauss-Markov fading
(`chan_rho`) and K-of-U participation (`part_k`, `participation_mask`);
`scenario_coefficients` takes an optional participation mask, under which
non-participants drop out of the coefficients, the bias and the cohort
sums.  Under a sharded sweep (fl/sweep.py) `build_lane_groups(codes,
shards)` and `pad_lanes` ghost-pad the lane axis to a multiple of the lane
shards.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

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

# Defense-code lane axis: 0 selects the analog FLOA combine (the paper's
# scheme); every other code a digital screening defense applied to the
# gathered [U, D] per-worker gradient slab (core/defenses.py).  "krum" and
# "multi_krum" share a kernel but keep distinct codes so results name the
# family they ran.
DEFENSE_CODES = {
    "floa": 0,
    "mean": 1,
    "median": 2,
    "trimmed_mean": 3,
    "krum": 4,
    "multi_krum": 5,
    "geometric_median": 6,
}
_FLOA_CODE = 0


@dataclasses.dataclass(frozen=True)
class DefenseSpec:
    """Per-lane aggregation rule: analog FLOA (name="floa") or a digital
    screening defense with its hyper-parameters.

    The bounds of trim / f / multi are checked here, on Python ints: the
    defense kernels take them as per-lane tensors and do not re-check.
    gm_iters is the Weiszfeld iteration count; SweepSpec makes every
    geometric-median lane of one sweep agree on it, as the reference does.
    """

    name: str = "floa"
    trim: int = 1           # trimmed_mean: drop `trim` largest+smallest/coord
    num_byzantine: int = 0  # krum / multi_krum: assumed attacker count f
    multi: int = 1          # multi_krum: average the m best-scored workers
    gm_iters: int = 8       # geometric_median: Weiszfeld iterations

    @property
    def code(self) -> int:
        return DEFENSE_CODES[self.name]

    @property
    def is_digital(self) -> bool:
        return self.name != "floa"

    def validate(self, num_workers: int) -> "DefenseSpec":
        if self.name not in DEFENSE_CODES:
            raise ValueError(
                f"unknown defense {self.name!r}; one of {sorted(DEFENSE_CODES)}")
        u = num_workers
        if self.name == "trimmed_mean" and not 0 <= 2 * self.trim < u:
            raise ValueError(
                f"trimmed_mean trim={self.trim} invalid for U={u}: "
                f"need 0 <= 2*trim < U")
        if self.name in ("krum", "multi_krum"):
            if not 0 <= self.num_byzantine < u:
                raise ValueError(
                    f"krum num_byzantine={self.num_byzantine} invalid for "
                    f"U={u}: need 0 <= f < U")
            if not 1 <= self.multi <= u:
                raise ValueError(
                    f"krum multi={self.multi} invalid for U={u}: "
                    f"need 1 <= multi <= U")
        if self.name == "geometric_median" and self.gm_iters < 1:
            raise ValueError(f"geometric_median gm_iters={self.gm_iters} < 1")
        return self

    _KWARGS_BY_DEFENSE = {
        "trimmed_mean": frozenset({"trim"}),
        "krum": frozenset({"num_byzantine", "multi"}),
        "multi_krum": frozenset({"num_byzantine", "multi"}),
        "geometric_median": frozenset({"iters", "gm_iters"}),
    }

    @classmethod
    def from_kwargs(cls, name: str, **kw) -> "DefenseSpec":
        """Build from a (defense, **defense_kwargs) pair.  Kwargs that do not
        belong to `name` are rejected: dropping them would run another
        defense than the caller asked for."""
        extra = set(kw) - cls._KWARGS_BY_DEFENSE.get(name, frozenset())
        if extra:
            raise ValueError(
                f"defense {name!r} does not accept kwargs {sorted(extra)}")
        fields = dict(trim=kw.get("trim", 1),
                      num_byzantine=kw.get("num_byzantine", 0),
                      multi=kw.get("multi", 1),
                      gm_iters=kw.get("iters", kw.get("gm_iters", 8)))
        if name == "krum" and fields["multi"] > 1:
            name = "multi_krum"
        return cls(name=name, **fields)


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
    defense: Tensor    # int32 [] — DEFENSE_CODES (0 = analog FLOA combine)
    def_trim: Tensor   # int32 []  trimmed_mean trim count
    def_f: Tensor      # int32 []  (multi-)Krum assumed attacker count f
    def_multi: Tensor  # int32 []  multi-Krum average count m
    chan_rho: Tensor   # f32   []  Gauss-Markov fading correlation rho
    part_k: Tensor     # int32 []  K-of-U participants (U: everyone)

    @property
    def num_workers(self) -> int:
        return self.byz_mask.shape[-1]


def from_floa(cfg, alpha: float, defense: Optional[DefenseSpec] = None,
              participants: Optional[int] = None) -> ScenarioParams:
    """FLOAConfig -> ScenarioParams (CPU tensors).

    EF scenarios get noise_std forced to 0 here: the branchless coefficients
    always add the noise term, so the std itself must be zero.  defense
    (validated against U) fills the four defense fields; None means the
    analog FLOA combine.  participants is K of K-of-U client sampling, None
    for full participation (part_k = U)."""
    cfg.validate()
    u = cfg.num_workers
    defense = (defense or DefenseSpec()).validate(u)
    if participants is not None and not 1 <= participants <= u:
        raise ValueError(
            f"participants={participants} invalid for U={u}: need 1 <= K <= U")
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
        defense=i32(defense.code),
        def_trim=i32(defense.trim),
        def_f=i32(defense.num_byzantine),
        def_multi=i32(defense.multi),
        chan_rho=f32(cfg.channel.markov_rho),
        part_k=i32(u if participants is None else participants),
    )


def stack(params: Sequence[ScenarioParams], device=None) -> ScenarioParams:
    """[ScenarioParams] * S -> ScenarioParams with a leading S axis on every
    field, on `device`.  All scenarios must share U."""
    return ScenarioParams(*(torch.stack(xs).to(device)
                            for xs in zip(*params)))


@dataclasses.dataclass(frozen=True)
class LaneGroups:
    """Static partition of a sweep's lane axis by defense code.

    Defense codes are concrete config, so the partition is known when the
    engine is built: the grouped dispatch (fl/sweep.py) runs each defense
    family's kernel once over a contiguous sub-slab of its lanes.

    The execution order is shard-uniform: each group is ghost-padded to a
    multiple of `shards` (replicating its LAST member, as `pad_lanes` does)
    and laid out shard-major, so every rank's block of lanes has the same
    group layout `local_slices`.  shards=1 is the unsharded engine, whose
    `perm` is a permutation.

      codes         group defense codes, ascending (one entry per group)
      perm          [S_exec] execution row -> source lane index (ghost rows
                    repeat their group's last real lane)
      inverse       [S] source lane -> its first execution row
      local_slices  ((code, start, end), ...) group boundaries in one
                    shard's execution rows
      shards        the shard count the layout was built for
    """

    codes: Tuple[int, ...]
    perm: Tuple[int, ...]
    inverse: Tuple[int, ...]
    local_slices: Tuple[Tuple[int, int, int], ...]
    shards: int = 1

    @property
    def exec_lanes(self) -> int:
        return len(self.perm)

    @property
    def lanes_per_shard(self) -> int:
        return len(self.perm) // self.shards

    @property
    def num_ghosts(self) -> int:
        return len(self.perm) - len(self.inverse)


def build_lane_groups(codes: Sequence[int], shards: int = 1) -> LaneGroups:
    """Lane defense codes (ints, lane order) -> LaneGroups.

    Within a group the lanes keep their order (a stable partition); groups
    run in ascending code order, so the analog FLOA group (code 0), when
    present, is always the first slice of every shard."""
    codes = [int(c) for c in codes]
    if not codes:
        raise ValueError("empty lane-code list")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    group_codes = sorted(set(codes))
    padded = {}
    for c in group_codes:
        members = [i for i, ci in enumerate(codes) if ci == c]
        padded[c] = members + [members[-1]] * (-len(members) % shards)
    per_shard = {c: len(padded[c]) // shards for c in group_codes}
    perm = []
    for d in range(shards):
        for c in group_codes:
            k = per_shard[c]
            perm.extend(padded[c][d * k:(d + 1) * k])
    first_row = {}
    for row, lane in enumerate(perm):
        first_row.setdefault(lane, row)
    local_slices, off = [], 0
    for c in group_codes:
        local_slices.append((c, off, off + per_shard[c]))
        off += per_shard[c]
    return LaneGroups(codes=tuple(group_codes), perm=tuple(perm),
                      inverse=tuple(first_row[i] for i in range(len(codes))),
                      local_slices=tuple(local_slices), shards=shards)


def permute_lanes(x, perm):
    """Gather lane-stacked data (a tensor, a ScenarioParams, or a dict of
    tensors / None) into execution order along the leading lane axis.
    `perm` is a sequence of lane indices (which may repeat a lane: ghost
    lanes) or a slice."""
    if isinstance(x, torch.Tensor):
        idx = (perm if isinstance(perm, slice)
               else torch.as_tensor(perm, dtype=torch.long, device=x.device))
        return x[idx]
    if isinstance(x, ScenarioParams):
        return ScenarioParams(*(permute_lanes(v, perm) for v in x))
    if isinstance(x, dict):
        return {k: None if v is None else permute_lanes(v, perm)
                for k, v in x.items()}
    raise TypeError(f"cannot permute lanes of {type(x).__name__}")


def pad_lanes(x, total: int):
    """Pad lane-stacked data (as `permute_lanes` takes it) to `total` lanes
    by replicating the last lane: the ghost lanes of a lane-sharded sweep
    run real, discarded scenarios."""
    s = (x if isinstance(x, torch.Tensor) else
         next(v for v in (x if isinstance(x, ScenarioParams)
                          else x.values()) if v is not None)).shape[0]
    if total < s:
        raise ValueError(f"cannot pad {s} lanes to {total}")
    if total == s:
        return x
    return permute_lanes(x, list(range(s)) + [s - 1] * (total - s))


def sample_gains(generators: Sequence[torch.Generator],
                 sp: ScenarioParams) -> Tensor:
    """|h_{s,i}| ~ Rayleigh(sp.sigma[s]), [S, U], lane s drawn from its own
    generator.  EF lanes draw too; `scenario_coefficients` ignores |h| there."""
    return torch.stack([rayleigh_gains(g, sig)
                        for g, sig in zip(generators, sp.sigma)])


def participation_mask(scores: Tensor, part_k: Tensor) -> Tensor:
    """K-of-U client sampling from uniform scores [..., U]: the part_k [...]
    workers with the smallest scores participate (rank of rank, so exactly
    K of U, every subset equally likely); part_k >= U is everyone."""
    rank = torch.argsort(torch.argsort(scores, dim=-1), dim=-1)
    return rank < per_worker(part_k)


def scenario_coefficients(
    h_abs: Tensor, sp: ScenarioParams, gbar: Tensor, eps2: Tensor,
    part: Optional[Tensor] = None,
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

    part: optional [..., U] bool participation mask; non-participants
    transmit nothing, so they drop out of the payload, of the bias /
    jamming / cohort sums and of the EF mean share (1/K instead of 1/U).
    """
    pw = per_worker
    u = sp.byz_mask.shape[-1]
    dim = sp.dim   # power-accounting D from the config, NOT the model's size
    is_ef = sp.policy == _EF
    mask = sp.byz_mask
    eff_mask = mask if part is None else mask & part
    eps = torch.sqrt(eps2)

    # --- power_control.transmit_amplitudes, all policies at once.
    b0 = ci_b0_arrays(sp.p_max, sp.sigma, dim)
    ci_amp = pw(b0) / h_abs
    bev_amp = max_amplitude_arrays(sp.p_max, dim)
    policy = pw(sp.policy)
    amp = torch.where(policy == _CI, ci_amp,
                      torch.where(policy == _TCI,
                                  torch.minimum(ci_amp, bev_amp), bev_amp))
    if part is None:
        ef_share = 1.0 / u
    else:  # (1/U) * (U/K): exactly 1/U at a full mask
        cnt = part.float().sum(dim=-1)
        ef_share = pw((1.0 / u) * (torch.full_like(cnt, u) / cnt))
    honest_s = torch.where(pw(is_ef), ef_share, amp * h_abs)

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
    if part is not None:
        s = torch.where(part, s, 0.0)

    # PS de-standardizes assuming protocol power for every worker; attackers
    # that never standardized leave the bias behind.
    has_bias = active & ~is_ef & ((sp.attack == _STRONGEST)
                                  | (sp.attack == _GAUSSIAN)
                                  | (sp.attack == _COLLUDING)
                                  | (sp.attack == _OMNISCIENT))
    bias_w = torch.where(has_bias,
                         torch.where(eff_mask, honest_s, 0.0).sum(dim=-1),
                         0.0)

    jam = A.jam_std_arrays(h_abs, sp.p_max, dim, eff_mask, eps2)
    jam_std = torch.where(active & ~is_ef & (sp.attack == _GAUSSIAN), jam, 0.0)

    collude_w = A.colluding_dir_weight(h_abs, sp.p_max, dim, eff_mask, eps2)
    omni_w = A.omniscient_dir_weight(h_abs, sp.p_max, dim, eff_mask, gbar,
                                     eps2)
    directional = active & ~is_ef
    dir_w = torch.where(directional & (sp.attack == _COLLUDING), collude_w,
                        torch.where(directional & (sp.attack == _OMNISCIENT),
                                    omni_w, 0.0))

    noise_std = torch.where(is_ef, 0.0, sp.noise_std)
    return s, bias_w, jam_std, noise_std, dir_w

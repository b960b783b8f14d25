"""Multi-scenario sweep engine on flat state: S scenarios x R rounds.

The paper's experimental section (Figs. 1-4) is a grid of scenarios — power
policy x attack x attacker count x learning rate — and the JAX package runs
each figure as one `SweepEngine` call (`repro/fl/sweep.py`).  This is its
port, restricted to flat [S, D] state on one device, no chunking and no
mesh.  One round of an all-analog sweep (every figure):

  1. per-worker gradients as one [S, U, D] slab (nested torch.func.vmap of
     torch.func.grad over lanes and workers);
  2. the eq. 3 stats off the slab (one `grad_stats` kernel launch);
  3. Rayleigh gains, 4. power/attack coefficients (core.scenario);
  5. a receiver-noise row;
  6. the fused OTA combine + PS update of eq. 7 + eq. 8 (one
     `floa_step_batched` kernel launch).  Sweeps with a GAUSSIAN-jamming
     or a COLLUDING / OMNISCIENT lane take the combine-only kernel
     (`floa_aggregate_batched`), add the jamming row and the cohort's
     direction, then update — as the JAX engine does.

Digital lanes (a `DefenseSpec` other than "floa") take the grouped
dispatch, the default plan of the JAX engine: the lanes are partitioned by
defense code (`scenario.build_lane_groups`), and each round computes one
[S, U, D] gradient slab in that group order, then runs each group on its
own sub-slab, in ascending code order:

  - the analog group: steps 2-6 above on its own rows only (so
    `grad_stats` sees the [S_a*U, D] analog rows, and an all-digital sweep
    launches no FLOA kernel and no `grad_stats`);
  - each digital group: its Byzantine rows sign-flipped (`_digital_flip`),
    the family's kernel (core/defenses.py; median and trimmed mean sort
    through the CUDA sort kernels, one launch per group), then
    w - alpha * gagg.

The groups' rows concatenate, and `run` hands the results back in lane
order (`LaneGroups.inverse`).  A sweep with no digital lane runs the
all-analog round above unchanged.

The adaptive-adversary axes, each gated by the spec so that sweeps without
it run exactly as before:

  - Gauss-Markov fading (`markov_rho > 0`, `any_markov`): a [S, U, 2]
    complex-gain state carried across rounds; rho > 0 lanes take |h| off
    it, rho = 0 lanes keep the i.i.d. draw.
  - K-of-U participation (`participants`, `any_partial`): a [S, U] mask
    per round; the analog stats average the participants only
    (`masked_global_stats`), non-participants drop out of the
    coefficients, and every digital group runs its masked twin (median and
    trimmed mean sort +inf-padded columns through the same kernels).
  - COLLUDING / OMNISCIENT cohorts (`any_directional`): after the combine
    the lane adds its cohort's received weight times a shared direction,
    a unit-RMS random row (COLLUDING) or the mean of the honest
    participating rows (OMNISCIENT).

The reported loss is the loss of the UPDATED weights on the round's batch,
and the grad norm is that of the aggregate, as in the JAX engine.  Rounds are
a Python loop (PyTorch runs eagerly); eval runs on rounds with
t % eval_every == 0 and on the last round, NaN elsewhere.

Random draws.  JAX's threefry and PyTorch's Philox cannot give the same
numbers, so a round takes its draws as inputs: `run(..., draws=fn)` with
fn(t) -> a dict keyed by lane ([S, ...] in spec order):

  "h_abs"  [S, U]     Rayleigh gains (every round)
  "z"      [S, D]     standard normal noise rows, or None (`analog_noise`)
  "jam"    [S, D]     standard normal jamming rows, or None
                      (`analog_jamming`)
  "part"   [S, U]     bool participation masks (`any_partial`)
  "h_init" [S, U, 2]  standard normals of the initial complex gains (round
                      0 only, `any_markov`)
  "markov" [S, U, 2]  standard normals of the fading innovations
                      (`any_markov`)
  "dir"    [S, D]     standard normal colluding directions
                      (`any_directional`)

The engine scales them (noise std, sigma, unit RMS).  By default each lane
draws from its own torch.Generators on the engine's device, one per stream,
seeded from ScenarioCase.seed and the stream's slot (0 gains, 1 noise, 2
jamming, 3 direction, 4 fading, 5 participation, 7 initial gains: the JAX
engine's split slots and fold_in constants), so a lane's stream depends
only on its own seed, and a new axis leaves the older streams unchanged.
Digital lanes do not consume their channel draws.

Out of this slice, and refused with NotImplementedError naming the
ROADMAP.md queue item: the switch dispatch (grouped_dispatch=False) and any
other non-default execution plan (chunking, checkpoints, mesh, sharding).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import channel as CH
from repro_torch.core import defenses as DEF
from repro_torch.core import scenario as SC
from repro_torch.core import standardize as S
from repro_torch.core.aggregation import (
    FLOAConfig,
    batched_floa_combine,
    batched_floa_step,
    flatten_worker_grads,
    per_worker_grads,
)
from repro_torch.core.attacks import DIRECTIONAL_ATTACKS, AttackType
from repro_torch.core.power_control import Policy
from repro_torch.device import resolve_device

Tensor = torch.Tensor

_Q_PLAN = ("ROADMAP.md Queue 1 items 7-8 (execution plan, chunking, "
           "checkpointing, sharding)")
_Q_SWITCH = ("ROADMAP.md Queue 1 item 7 (execution plan: the per-lane switch "
             "dispatch)")

# The execution-plan knobs of the JAX engine and their defaults: the only
# plan the port runs.
_PLAN_DEFAULTS = {"flat_state": True, "mesh": None, "strict_numerics": False,
                  "grouped_dispatch": True, "chunk_rounds": None,
                  "async_staging": False, "worker_shards": 1,
                  "model_shards": 1, "checkpoint_dir": None}


def as_device_array(x, device) -> Tensor:
    """Host array -> tensor on `device`, floating data as float32 (what
    `jnp.asarray` gives the JAX engine: the synthetic digits are float64
    under NumPy 2's promotion rules)."""
    x = np.array(x)   # a writable copy: torch refuses read-only buffers
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    return torch.as_tensor(x, device=device)


@dataclasses.dataclass(frozen=True)
class ScenarioCase:
    """One lane of the sweep: a frozen FLOAConfig plus its lr and seed.

    defense selects the lane's aggregation rule: the analog FLOA combine
    (the default), or a digital screening defense applied to the gathered
    [U, D] gradient slab, with digital attackers reporting sign-flipped
    gradients.  participants is K of K-of-U client sampling: each round
    the lane draws K participants (non-participants transmit nothing, and
    digital defenses screen the K rows only); None is full participation
    with no masking at all, while participants=U runs the masked path."""

    name: str
    floa: FLOAConfig
    alpha: float
    seed: int = 0
    defense: SC.DefenseSpec = dataclasses.field(
        default_factory=SC.DefenseSpec)
    participants: Optional[int] = None


def _check_participants(c: ScenarioCase, u: int) -> None:
    """K-of-U bounds of one lane: 1 <= K <= U, and its digital defense's
    bounds must hold for the K rows it screens each round."""
    k, d = c.participants, c.defense
    if not 1 <= k <= u:
        raise ValueError(f"lane {c.name!r}: participants={k} invalid for "
                         f"U={u}: need 1 <= K <= U")
    if d.name == "trimmed_mean" and not 2 * d.trim < k:
        raise ValueError(f"lane {c.name!r}: trimmed_mean trim={d.trim} "
                         f"invalid for K={k} participants: need 2*trim < K")
    if d.name in ("krum", "multi_krum"):
        if d.num_byzantine > k - 3:
            raise ValueError(
                f"lane {c.name!r}: krum num_byzantine={d.num_byzantine} "
                f"invalid for K={k} participants: need f <= K - 3")
        if d.multi > k:
            raise ValueError(
                f"lane {c.name!r}: krum multi={d.multi} invalid for K={k} "
                f"participants: need multi <= K")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """An ordered set of scenarios destined for one sweep."""

    cases: Tuple[ScenarioCase, ...]

    @classmethod
    def build(cls, cases: Sequence) -> "SweepSpec":
        """Accepts ScenarioCase instances or (name, floa, alpha[, seed]) tuples."""
        return cls(cases=tuple(c if isinstance(c, ScenarioCase)
                               else ScenarioCase(*c) for c in cases))

    def __post_init__(self):
        if not self.cases:
            raise ValueError("empty sweep")
        u = self.cases[0].floa.num_workers
        for c in self.cases:
            c.floa.validate()
            if c.floa.num_workers != u:
                raise ValueError("sweep scenarios must share U")
            if not isinstance(c.defense, SC.DefenseSpec):
                raise TypeError(f"lane {c.name!r}: defense must be a "
                                f"DefenseSpec, got {c.defense!r}")
            c.defense.validate(u)
            if c.participants is not None:
                _check_participants(c, u)
        gm_iters = {c.defense.gm_iters for c in self.cases
                    if c.defense.name == "geometric_median"}
        if len(gm_iters) > 1:
            raise ValueError(
                "geometric_median lanes must share gm_iters (one Weiszfeld "
                f"depth per lane group); got {sorted(gm_iters)}")

    def __len__(self) -> int:
        return len(self.cases)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.cases)

    @property
    def num_workers(self) -> int:
        return self.cases[0].floa.num_workers

    def stacked_params(self, device=None) -> SC.ScenarioParams:
        """Frozen dataclass configs -> stacked tensors, [S, ...]."""
        return SC.stack([SC.from_floa(c.floa, c.alpha, c.defense,
                                      participants=c.participants)
                         for c in self.cases], device=device)

    # Defense-code lane axis: a sweep with no digital lane takes the
    # all-analog round; any digital lane takes the grouped dispatch.
    @property
    def any_digital(self) -> bool:
        return any(c.defense.is_digital for c in self.cases)

    @property
    def all_digital(self) -> bool:
        return all(c.defense.is_digital for c in self.cases)

    @property
    def digital_codes(self) -> Tuple[int, ...]:
        return tuple(sorted({c.defense.code for c in self.cases
                             if c.defense.is_digital}))

    @property
    def lane_codes(self) -> Tuple[int, ...]:
        """Per-lane defense codes in lane order: the grouped partition's
        input."""
        return tuple(c.defense.code for c in self.cases)

    # The draws the lanes consume (the grouped engine's trace gates): only
    # analog lanes take noise and jamming rows (a digital lane's channel
    # config is never used).
    @property
    def analog_noise(self) -> bool:
        return any(c.floa.channel.noise_std > 0.0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def analog_jamming(self) -> bool:
        return any(c.floa.attack.attack == AttackType.GAUSSIAN
                   and c.floa.attack.num_attackers > 0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def gm_iters(self) -> int:
        its = {c.defense.gm_iters for c in self.cases
               if c.defense.name == "geometric_median"}
        return its.pop() if its else 8

    # The adaptive-adversary gates: each is False for every lane without
    # the axis, so such sweeps draw and run exactly what they did before.
    @property
    def any_markov(self) -> bool:
        """Gauss-Markov fading consumers: rho > 0 on an analog, non-EF lane
        (digital lanes ignore the channel; EF ignores |h|)."""
        return any(c.floa.channel.markov_rho > 0.0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def any_partial(self) -> bool:
        """K-of-U participation on any lane (participants=U counts: it runs
        the masked path)."""
        return any(c.participants is not None for c in self.cases)

    @property
    def any_directional(self) -> bool:
        """COLLUDING / OMNISCIENT cohorts with a member, on an analog non-EF
        lane: gates the direction added after the combine."""
        return any(c.floa.attack.attack in DIRECTIONAL_ATTACKS
                   and c.floa.attack.num_attackers > 0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)


@dataclasses.dataclass
class SweepResult:
    """Per-scenario, per-round trajectories ([S, R] numpy arrays)."""

    names: Tuple[str, ...]
    params: Dict[str, Tensor]       # final params, leaves [S, ...]
    loss: np.ndarray                # [S, R]
    grad_norm: np.ndarray           # [S, R]
    metrics: Dict[str, np.ndarray]  # each [S, R]

    def index(self, name: str) -> int:
        return self.names.index(name)

    def logs(self, name_or_idx, eval_every: int = 1) -> list:
        """RoundLog list of one lane, on the `FLTrainer.run(eval_every=...)`
        schedule (t % eval_every == 0 and the last round), for the figure
        CSV writers.  Pass the engine's own eval_every: rounds it did not
        evaluate carry NaN accuracy."""
        from repro_torch.fl.trainer import RoundLog
        i = (name_or_idx if isinstance(name_or_idx, int)
             else self.index(name_or_idx))
        rounds = self.loss.shape[1]
        acc = self.metrics.get("accuracy")
        return [RoundLog(step=t, loss=float(self.loss[i, t]),
                         accuracy=(float(acc[i, t]) if acc is not None
                                   else float("nan")),
                         grad_norm=float(self.grad_norm[i, t]))
                for t in range(rounds)
                if eval_every and (t % eval_every == 0 or t == rounds - 1)]


def stack_params(params: Dict[str, Tensor], num: int) -> Dict[str, Tensor]:
    """Broadcast one init dict to a stacked [S, ...] scenario axis."""
    return {k: v[None].expand(num, *v.shape) for k, v in params.items()}


def make_row_unflatten(template: Dict[str, Tensor]):
    """[..., D] flat rows -> params dict, as VIEWS of the row (so gradients
    taken with respect to the row reach every leaf).

    Leaves are laid out in sorted key order — the JAX package's flat order
    (`jax.tree_util.tree_flatten` sorts dict keys): b1 | b2 | w1 | w2 for the
    paper MLP.  Returns (unflatten_row, sizes), sizes in that order."""
    keys = sorted(template)
    shapes = [tuple(template[k].shape) for k in keys]
    sizes = tuple(math.prod(s) for s in shapes)

    def unflatten_row(w: Tensor) -> Dict[str, Tensor]:
        out, off = {}, 0
        for k, shape, n in zip(keys, shapes, sizes):
            out[k] = w[..., off:off + n].reshape(*w.shape[:-1], *shape)
            off += n
        return out

    return unflatten_row, sizes


def _digital_flip(flat: Tensor, sp: SC.ScenarioParams) -> Tensor:
    """Digital attackers report -g (there is no channel to cheat on):
    sign-flip the Byzantine rows of a lane group's [S_g, U, D] slab."""
    flip = (sp.attack != 0)[:, None] & sp.byz_mask
    sign = torch.where(flip, -1.0, 1.0)
    return flat * sign[:, :, None]


def lane_generator(seed: int, slot: int, device) -> torch.Generator:
    """The generator of stream `slot` (`SweepEngine._SLOTS`) of a lane
    seeded `seed`: the engine's default draws and the trainer's."""
    state = np.random.SeedSequence([seed, slot]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def _refuse_plan(plan) -> None:
    if plan is None:
        return
    if getattr(plan, "grouped_dispatch", True) is False:
        raise NotImplementedError(
            f"execution plan grouped_dispatch=False is not ported yet — "
            f"{_Q_SWITCH}")
    bad = []
    for knob, default in _PLAN_DEFAULTS.items():
        got = getattr(plan, knob, default)
        if (got is not default) if default is None else (got != default):
            bad.append(f"{knob}={got!r}")
    if bad:
        raise NotImplementedError(
            f"execution plan {', '.join(bad)} is not ported yet — {_Q_PLAN}")


class SweepEngine:
    """The flat-state sweep for one (loss_fn, spec, eval_fn) triple.

    loss_fn(params_dict, batch) -> scalar; eval_fn(params_dict) -> dict of
    scalars.  device defaults to 'cuda' and raises without a card.
    force_plain=True sends every kernel wrapper to its plain PyTorch version
    even on the card; it exists so a test can hold the kernel route against
    the plain one from the same draws, and the figures never set it.
    """

    # Generator slots of the default draws (the JAX engine's split slots
    # 0-2 and fold_in constants 3, 4, 5, 7).
    _SLOTS = {"h_abs": 0, "z": 1, "jam": 2, "dir": 3, "markov": 4,
              "part": 5, "h_init": 7}

    def __init__(self, loss_fn: Callable, spec: SweepSpec,
                 eval_fn: Optional[Callable] = None, eval_every: int = 1,
                 plan=None, *, device="cuda", force_plain: bool = False):
        _refuse_plan(plan)
        self.loss_fn = loss_fn
        self.spec = spec
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.device = resolve_device(device)
        self.force_plain = force_plain
        self._u = spec.num_workers
        self._sp = spec.stacked_params(self.device)
        # The draws the lanes consume and the route, fixed by the spec.
        self._noise, self._jam = spec.analog_noise, spec.analog_jamming
        self._markov, self._partial = spec.any_markov, spec.any_partial
        self._dir = spec.any_directional
        # Grouped dispatch: rows run in group order (`_perm`), results go
        # back to lane order (`_inverse`) in `run`.  Each group's rows, its
        # ScenarioParams and its defense kernel (None for the analog group)
        # are fixed here, so a round only indexes them.
        self._group_runs = None
        self._sp_exec = self._sp
        if spec.any_digital:
            groups = SC.build_lane_groups(spec.lane_codes)
            self._perm, self._inverse = (
                torch.as_tensor(ix, dtype=torch.long, device=self.device)
                for ix in (groups.perm, groups.inverse))
            self._sp_exec = SC.permute_lanes(self._sp, self._perm)
            self._group_runs = [
                (slice(start, end),
                 SC.permute_lanes(self._sp_exec, slice(start, end)),
                 None if code == SC._FLOA_CODE
                 else DEF.make_group_defense_kernel(
                     code, spec.gm_iters, masked=self._partial,
                     plain=force_plain))
                for code, start, end in groups.local_slices]

    def _wanted_draws(self, s: int, d: int, t: int) -> Dict[str, tuple]:
        """key -> (shape, dtype) of every draw round t consumes."""
        u, f32 = self._u, torch.float32
        want = {"h_abs": ((s, u), f32)}
        for key, on, shape in [("z", self._noise, (s, d)),
                               ("jam", self._jam, (s, d)),
                               ("part", self._partial, (s, u)),
                               ("h_init", self._markov and t == 0, (s, u, 2)),
                               ("markov", self._markov, (s, u, 2)),
                               ("dir", self._dir, (s, d))]:
            if on:
                want[key] = (shape, torch.bool if key == "part" else f32)
        return want

    def seeded_draws(self, d: int) -> Callable[[int], Dict[str, Tensor]]:
        """The default draw provider: per lane and per stream one generator
        on the engine's device, seeded from the lane's seed and the
        stream's slot (`_SLOTS`) alone.  Call the provider once per round,
        in round order."""
        dev, sp, s = self.device, self._sp, len(self.spec)
        gens = {}

        def generators(key: str) -> List[torch.Generator]:
            if key not in gens:
                gens[key] = []
                for c in self.spec.cases:
                    gens[key].append(
                        lane_generator(c.seed, self._SLOTS[key], dev))
            return gens[key]

        def normal(key: str, shape) -> Tensor:
            return torch.stack([torch.randn(shape, generator=g, device=dev)
                                for g in generators(key)])

        def draws(t: int) -> Dict[str, Optional[Tensor]]:
            want = self._wanted_draws(s, d, t)
            out = {"h_abs": SC.sample_gains(generators("h_abs"), sp),
                   "z": None, "jam": None}
            for key, (shape, _) in want.items():
                if key == "part":
                    scores = torch.stack([
                        torch.rand(self._u, generator=g, device=dev)
                        for g in generators(key)])
                    out[key] = SC.participation_mask(scores, sp.part_k)
                elif key != "h_abs":
                    out[key] = normal(key, shape[1:])
            return out

        return draws

    def _check_draw(self, draw, s: int, d: int, t: int) -> None:
        for key, (shape, dtype) in self._wanted_draws(s, d, t).items():
            x = draw.get(key)
            if (not isinstance(x, torch.Tensor) or tuple(x.shape) != shape
                    or x.dtype != dtype or x.device != self.device):
                raise ValueError(
                    f"draw {key!r} must be a {dtype} {shape} tensor on "
                    f"{self.device}, got "
                    f"{x if x is None else (x.dtype, tuple(x.shape), x.device)}")

    def _round(self, w: Tensor, batch, draw, grads_fn, loss_lanes):
        """One round over every lane, in execution order: (w [S, D]) ->
        (w_new, loss, gn)."""
        # 1. per-worker gradients, already flat: [S, U, D].
        grads = grads_fn(w, batch).contiguous()
        part = draw.get("part") if self._partial else None
        if self._group_runs is None:
            w_new, gagg = self._analog_step(w, grads, draw, self._sp, part)
        else:
            w_parts, g_parts = [], []
            for rows, spg, kernel in self._group_runs:
                part_g = None if part is None else part[rows]
                if kernel is None:
                    w_g, g_g = self._analog_step(
                        w[rows], grads[rows], SC.permute_lanes(draw, rows),
                        spg, part_g)
                else:
                    args = (_digital_flip(grads[rows], spg), spg.def_trim,
                            spg.def_f, spg.def_multi)
                    g_g = kernel(*args) if part_g is None else kernel(
                        *args, part_g)
                    w_g = w[rows] - spg.alpha[:, None] * g_g
                w_parts.append(w_g)
                g_parts.append(g_g)
            w_new, gagg = torch.cat(w_parts), torch.cat(g_parts)
        gn = torch.sqrt(torch.sum(gagg * gagg, dim=-1))
        loss = loss_lanes(w_new, batch)
        return w_new, loss, gn

    def _analog_step(self, w: Tensor, grads: Tensor, draw,
                     sp: SC.ScenarioParams, part: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
        """Steps 2-6 on analog lanes: (w [S_a, D], grads [S_a, U, D]) ->
        (w_new, gagg), with `draw`, `sp` and the participation masks
        `part` [S_a, U] (or None) for the same lanes."""
        plain = self.force_plain
        s, d = w.shape
        # 2. standardization handshake (eq. 3): per-worker stats, PS mean
        # over the participants.
        gbar_i, eps2_i = S.flat_scalar_stats(grads, plain=plain)
        if part is None:
            gbar, eps2 = S.global_stats(gbar_i, eps2_i)
        else:
            gbar, eps2 = S.masked_global_stats(gbar_i, eps2_i, part)
        eps = torch.sqrt(eps2)
        # 3+4. channel draw + branchless power/attack coefficients.
        coeff, bias_w, jam_std, noise_std, dir_w = SC.scenario_coefficients(
            draw["h_abs"], sp, gbar, eps2, part)
        # 5. receiver noise row (all-zero when no analog lane is noisy).
        if self._noise:
            noise_row = noise_std[:, None] * draw["z"]
        else:
            noise_row = torch.zeros((s, d), device=w.device)
        bias_row = bias_w * gbar
        # 6. OTA combine + PS update: fused, or the combine, then jamming
        # and the cohorts' direction, then the update.
        if not (self._jam or self._dir):
            return batched_floa_step(w, sp.alpha, coeff, grads, noise_row,
                                     bias_row, eps, plain=plain)
        gagg = batched_floa_combine(coeff, grads, noise_row, bias_row, eps,
                                    plain=plain)
        if self._jam:
            gagg = gagg + jam_std[:, None] * draw["jam"]
        if self._dir:
            gagg = gagg + dir_w[:, None] * self._direction(grads, draw, sp,
                                                           part)
        return w - sp.alpha[:, None] * gagg, gagg

    @staticmethod
    def _direction(grads: Tensor, draw, sp: SC.ScenarioParams,
                   part: Optional[Tensor]) -> Tensor:
        """The cohort's shared row [S_a, D]: COLLUDING lanes a unit-RMS
        random direction, every other lane the mean of its honest
        (participating) rows, which OMNISCIENT lanes transmit negated (the
        sign is in dir_w, 0 for other attacks)."""
        dvec = draw["dir"]
        rms = torch.sqrt(torch.mean(dvec * dvec, dim=-1, keepdim=True))
        dvec = dvec / torch.clamp_min(rms, 1e-20)
        honest = (~sp.byz_mask).float()
        if part is not None:
            honest = honest * part.float()
        cnt = torch.clamp_min(honest.sum(dim=-1), 1.0)
        hmean = torch.einsum("su,sud->sd", honest, grads) / cnt[:, None]
        return torch.where((sp.attack == SC._COLLUDING)[:, None], dvec,
                           hmean)

    def _fade(self, h: Tensor, draw) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One Gauss-Markov step of the [S, U, 2] gains (execution order),
        and the draw with each rho > 0 lane's |h| taken off it (rho = 0
        lanes keep the i.i.d. draw)."""
        sp = self._sp_exec
        h = CH.gauss_markov_step(h, sp.sigma[..., None] * draw["markov"],
                                 sp.chan_rho[:, None, None])
        h_abs = torch.where((sp.chan_rho > 0.0)[:, None],
                            CH.complex_gain_abs(h), draw["h_abs"])
        return h, {**draw, "h_abs": h_abs}

    @torch.no_grad()
    def _eval(self, w: Tensor, unflatten_row) -> Dict[str, Tensor]:
        rows = [self.eval_fn(unflatten_row(w[i])) for i in range(w.shape[0])]
        return {k: torch.stack([torch.as_tensor(r[k], device=w.device).float()
                                for r in rows]) for k in rows[0]}

    def run(self, params0: Dict[str, Tensor], batches: Dict[str, np.ndarray],
            draws: Optional[Callable[[int], Dict[str, Tensor]]] = None
            ) -> SweepResult:
        """params0: one init dict (JAX layout), broadcast to every lane.
        batches: dict of [R, U*B, ...] arrays shared by every lane.
        draws: optional per-round draw provider (module docstring); None
        uses `seeded_draws`."""
        dev, num, u = self.device, len(self.spec), self._u
        params0 = {k: torch.as_tensor(v, device=dev)
                   for k, v in params0.items()}
        w, _ = flatten_worker_grads(stack_params(params0, num), batch_dims=1)
        w = w.contiguous()                                     # [S, D] f32
        unflatten_row, _ = make_row_unflatten(params0)
        d = w.shape[1]
        batches = {k: as_device_array(v, dev) for k, v in batches.items()}
        rounds = next(iter(batches.values())).shape[0]
        if rounds < 1:
            raise ValueError("batches must hold at least one round")
        draws = self.seeded_draws(d) if draws is None else draws
        grouped = self._group_runs is not None
        if grouped:   # every lane starts from params0 anyway
            w = SC.permute_lanes(w, self._perm)

        loss_fn = self.loss_fn

        def flat_loss(w_row, batch):
            return loss_fn(unflatten_row(w_row), batch)

        grads_fn = vmap(lambda wr, b: per_worker_grads(flat_loss, wr, b, u),
                        in_dims=(0, None))
        loss_lanes = vmap(flat_loss, in_dims=(0, None))

        h = None   # the Gauss-Markov state [S, U, 2], execution order
        losses, gns, evals = [], [], []
        for t in range(rounds):
            batch = {k: v[t] for k, v in batches.items()}
            draw = draws(t)
            self._check_draw(draw, num, d, t)
            if grouped:
                draw = SC.permute_lanes(draw, self._perm)
            if self._markov:
                if t == 0:   # stationary: every marginal Rayleigh(sigma)
                    h = self._sp_exec.sigma[..., None] * draw["h_init"]
                h, draw = self._fade(h, draw)
            w, loss, gn = self._round(w, batch, draw, grads_fn, loss_lanes)
            losses.append(loss)
            gns.append(gn)
            due = t == rounds - 1 or (self.eval_every > 0
                                      and t % self.eval_every == 0)
            evals.append(self._eval(w, unflatten_row)
                         if due and self.eval_fn is not None else None)

        keys = next((e.keys() for e in evals if e is not None), ())
        nan = torch.full((num,), float("nan"), device=dev)
        # Back to lane order: execution row self._inverse[i] is lane i.
        inv = self._inverse if grouped else slice(None)

        def lanes(rows: List[Tensor]) -> np.ndarray:
            return SC.permute_lanes(torch.stack(rows, dim=1),
                                    inv).cpu().numpy()

        metrics = {k: lanes([nan if e is None else e[k] for e in evals])
                   for k in keys}
        w = SC.permute_lanes(w, inv)
        final = {k: v.clone() for k, v in unflatten_row(w).items()}
        return SweepResult(
            names=self.spec.names, params=final, loss=lanes(losses),
            grad_norm=lanes(gns), metrics=metrics)


def run_sweep(loss_fn: Callable, params0, batches, spec: SweepSpec,
              eval_fn: Optional[Callable] = None, eval_every: int = 1,
              plan=None, *, device="cuda", draws=None) -> SweepResult:
    """One-shot convenience wrapper around SweepEngine."""
    return SweepEngine(loss_fn, spec, eval_fn=eval_fn, eval_every=eval_every,
                       plan=plan, device=device).run(params0, batches,
                                                     draws=draws)

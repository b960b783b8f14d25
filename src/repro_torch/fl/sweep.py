"""Multi-scenario sweep engine on flat state: S scenarios x R rounds.

The paper's experimental section (Figs. 1-4) is a grid of scenarios — power
policy x attack x attacker count x learning rate — and the JAX package runs
each figure as one `SweepEngine` call (`repro/fl/sweep.py`).  This is its
port, restricted to the path every figure takes: analog lanes, flat [S, D]
state on one device, no chunking, no mesh, no defenses.  One round:

  1. per-worker gradients as one [S, U, D] slab (nested torch.func.vmap of
     torch.func.grad over lanes and workers);
  2. the eq. 3 stats off the slab (one `grad_stats` kernel launch);
  3. Rayleigh gains, 4. power/attack coefficients (core.scenario);
  5. a receiver-noise row;
  6. the fused OTA combine + PS update of eq. 7 + eq. 8 (one
     `floa_step_batched` kernel launch).  Sweeps with a GAUSSIAN-jamming
     lane take the combine-only kernel (`floa_aggregate_batched`), add the
     jamming row, then update — as the JAX engine does.

The reported loss is the loss of the UPDATED weights on the round's batch,
and the grad norm is that of the aggregate, as in the JAX engine.  Rounds are
a Python loop (PyTorch runs eagerly); eval runs on rounds with
t % eval_every == 0 and on the last round, NaN elsewhere.

Random draws.  JAX's threefry and PyTorch's Philox cannot give the same
numbers, so a round takes its draws as inputs: `run(..., draws=fn)` with
fn(t) -> {"h_abs": [S, U], "z": [S, D] or None, "jam": [S, D] or None}
(standard normal z / jam rows; the engine scales them).  By default each
lane draws from its own three torch.Generators (gains, noise, jamming) on
the engine's device, seeded from ScenarioCase.seed, so a lane's stream
depends only on its own seed, as in the JAX engine.

Out of this slice, and refused with NotImplementedError naming the
ROADMAP.md queue item: digital defenses, K-of-U participation, Gauss-Markov
fading, COLLUDING/OMNISCIENT attacks, and any non-default execution plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

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

Tensor = torch.Tensor

_Q_DEFENSES = "ROADMAP.md Queue 1 item 5 (digital defenses)"
_Q_ADAPTIVE = "ROADMAP.md Queue 1 item 6 (adaptive-adversary axes)"
_Q_PLAN = ("ROADMAP.md Queue 1 items 7-8 (execution plan, chunking, "
           "checkpointing, sharding)")

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


def resolve_device(device) -> torch.device:
    """The engine's device.  'cuda' without a card raises: the port never
    falls back to the CPU on its own (pass device='cpu' for that)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions "
                "on the CPU")
        if dev.index is None:   # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ScenarioCase:
    """One lane of the sweep: a frozen FLOAConfig plus its lr and seed.

    defense / participants mirror the JAX ScenarioCase; the port runs only
    the analog combine ("floa") under full participation (None)."""

    name: str
    floa: FLOAConfig
    alpha: float
    seed: int = 0
    defense: object = "floa"
    participants: Optional[int] = None


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
            defense = getattr(c.defense, "name", c.defense)
            if defense != "floa":
                raise NotImplementedError(
                    f"lane {c.name!r}: digital defense {defense!r} is not "
                    f"ported yet — {_Q_DEFENSES}")
            if c.participants is not None:
                raise NotImplementedError(
                    f"lane {c.name!r}: K-of-U participation is not ported "
                    f"yet — {_Q_ADAPTIVE}")
            if c.floa.channel.markov_rho > 0.0:
                raise NotImplementedError(
                    f"lane {c.name!r}: Gauss-Markov fading is not ported "
                    f"yet — {_Q_ADAPTIVE}")
            if c.floa.attack.attack in DIRECTIONAL_ATTACKS:
                raise NotImplementedError(
                    f"lane {c.name!r}: {c.floa.attack.attack.value} attack "
                    f"is not ported yet — {_Q_ADAPTIVE}")

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
        return SC.stack([SC.from_floa(c.floa, c.alpha) for c in self.cases],
                        device=device)

    # Which draws any lane consumes (the JAX engine's trace gates).
    @property
    def any_noise(self) -> bool:
        return any(c.floa.channel.noise_std > 0.0
                   and c.floa.power.policy != Policy.EF for c in self.cases)

    @property
    def any_jamming(self) -> bool:
        return any(c.floa.attack.attack == AttackType.GAUSSIAN
                   and c.floa.attack.num_attackers > 0
                   and c.floa.power.policy != Policy.EF for c in self.cases)


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


def _refuse_plan(plan) -> None:
    if plan is None:
        return
    bad = []
    for knob, default in _PLAN_DEFAULTS.items():
        got = getattr(plan, knob, default)
        if (got is not default) if default is None else (got != default):
            bad.append(f"{knob}={got!r}")
    if bad:
        raise NotImplementedError(
            f"execution plan {', '.join(bad)} is not ported yet — {_Q_PLAN}")


class SweepEngine:
    """The flat-state analog sweep for one (loss_fn, spec, eval_fn) triple.

    loss_fn(params_dict, batch) -> scalar; eval_fn(params_dict) -> dict of
    scalars.  device defaults to 'cuda' and raises without a card.
    force_plain=True sends every kernel wrapper to its plain PyTorch version
    even on the card; it exists so a test can hold the kernel route against
    the plain one from the same draws, and the figures never set it.
    """

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

    def seeded_draws(self, d: int) -> Callable[[int], Dict[str, Tensor]]:
        """The default draw provider: per lane, three generators (gains,
        noise, jamming) on the engine's device, seeded from the lane's seed
        alone.  Call the provider once per round, in round order."""
        dev, sp = self.device, self._sp

        def generators(slot: int) -> List[torch.Generator]:
            out = []
            for c in self.spec.cases:
                seed = np.random.SeedSequence([c.seed, slot]).generate_state(
                    1, np.uint64)[0]
                out.append(torch.Generator(dev).manual_seed(int(seed)))
            return out

        g_h, g_z, g_jam = generators(0), generators(1), generators(2)
        any_noise, any_jam = self.spec.any_noise, self.spec.any_jamming

        def normal_rows(gens):
            return torch.stack([torch.randn(d, generator=g, device=dev)
                                for g in gens])

        def draws(t: int) -> Dict[str, Optional[Tensor]]:
            return {"h_abs": SC.sample_gains(g_h, sp),
                    "z": normal_rows(g_z) if any_noise else None,
                    "jam": normal_rows(g_jam) if any_jam else None}

        return draws

    def _check_draw(self, draw, s: int, d: int) -> None:
        want = {"h_abs": (s, self._u),
                "z": (s, d) if self.spec.any_noise else None,
                "jam": (s, d) if self.spec.any_jamming else None}
        for key, shape in want.items():
            if shape is None:
                continue
            x = draw.get(key)
            if (not isinstance(x, torch.Tensor) or tuple(x.shape) != shape
                    or x.dtype != torch.float32 or x.device != self.device):
                raise ValueError(
                    f"draw {key!r} must be a float32 {shape} tensor on "
                    f"{self.device}, got "
                    f"{x if x is None else (x.dtype, tuple(x.shape), x.device)}")

    def _round(self, w: Tensor, batch, draw, grads_fn, loss_lanes):
        """One round over every lane: (w [S, D]) -> (w_new, loss, gn)."""
        sp, plain = self._sp, self.force_plain
        s, d = w.shape
        # 1. per-worker gradients, already flat: [S, U, D].
        grads = grads_fn(w, batch).contiguous()
        # 2. standardization handshake (eq. 3): per-worker stats, PS mean.
        gbar_i, eps2_i = S.flat_scalar_stats(grads, plain=plain)
        gbar, eps2 = S.global_stats(gbar_i, eps2_i)
        eps = torch.sqrt(eps2)
        # 3+4. channel draw + branchless power/attack coefficients.
        coeff, bias_w, jam_std, noise_std, _ = SC.scenario_coefficients(
            draw["h_abs"], sp, gbar, eps2)
        # 5. receiver noise row (all-zero when no lane is noisy).
        if self.spec.any_noise:
            noise_row = noise_std[:, None] * draw["z"]
        else:
            noise_row = torch.zeros((s, d), device=w.device)
        bias_row = bias_w * gbar
        # 6. OTA combine + PS update: fused, or combine + jam + update.
        if not self.spec.any_jamming:
            w_new, gagg = batched_floa_step(w, sp.alpha, coeff, grads,
                                            noise_row, bias_row, eps,
                                            plain=plain)
        else:
            gagg = batched_floa_combine(coeff, grads, noise_row, bias_row,
                                        eps, plain=plain)
            gagg = gagg + jam_std[:, None] * draw["jam"]
            w_new = w - sp.alpha[:, None] * gagg
        gn = torch.sqrt(torch.sum(gagg * gagg, dim=-1))
        loss = loss_lanes(w_new, batch)
        return w_new, loss, gn

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

        loss_fn = self.loss_fn

        def flat_loss(w_row, batch):
            return loss_fn(unflatten_row(w_row), batch)

        grads_fn = vmap(lambda wr, b: per_worker_grads(flat_loss, wr, b, u),
                        in_dims=(0, None))
        loss_lanes = vmap(flat_loss, in_dims=(0, None))

        losses, gns, evals = [], [], []
        for t in range(rounds):
            batch = {k: v[t] for k, v in batches.items()}
            draw = draws(t)
            self._check_draw(draw, num, d)
            w, loss, gn = self._round(w, batch, draw, grads_fn, loss_lanes)
            losses.append(loss)
            gns.append(gn)
            due = t == rounds - 1 or (self.eval_every > 0
                                      and t % self.eval_every == 0)
            evals.append(self._eval(w, unflatten_row)
                         if due and self.eval_fn is not None else None)

        keys = next((e.keys() for e in evals if e is not None), ())
        nan = torch.full((num,), float("nan"), device=dev)
        metrics = {k: torch.stack([nan if e is None else e[k] for e in evals],
                                  dim=1).cpu().numpy() for k in keys}
        final = {k: v.clone() for k, v in unflatten_row(w).items()}
        return SweepResult(
            names=self.spec.names, params=final,
            loss=torch.stack(losses, dim=1).cpu().numpy(),
            grad_norm=torch.stack(gns, dim=1).cpu().numpy(),
            metrics=metrics)


def run_sweep(loss_fn: Callable, params0, batches, spec: SweepSpec,
              eval_fn: Optional[Callable] = None, eval_every: int = 1,
              plan=None, *, device="cuda", draws=None) -> SweepResult:
    """One-shot convenience wrapper around SweepEngine."""
    return SweepEngine(loss_fn, spec, eval_fn=eval_fn, eval_every=eval_every,
                       plan=plan, device=device).run(params0, batches,
                                                     draws=draws)

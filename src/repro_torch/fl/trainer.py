"""Federated training loop (the paper's simulation harness, §IV).

One round =
  1. every worker computes a local SGD gradient on its own minibatch,
  2. scalar-stat standardization handshake,
  3. channel draw + power control + (optional) Byzantine attack,
  4. over-the-air aggregation (eq. 7),
  5. PS update w <- w - alpha * gagg (eq. 8).

`mode="floa"` uses the analog path (`core.aggregation.floa_grad`);
`mode="digital"` gathers the per-worker gradients and applies a screening
defense (`core.defenses.digital_aggregate`), with Byzantine workers
reporting sign-flipped gradients — the vanilla-FL comparison the paper
argues cannot be done over the air.

The port of `repro/fl/trainer.py`.  `run` is one eager Python round at a
time on a sampler, `run_scan` the same rounds on batches stacked up front
([R, ...] leaves), and `run_scan(flat=True)` hands the run to the sweep
engine as one lane (flat [D] state; in FLOA mode the `grad_stats` and
fused `floa_step_batched` kernels, in digital mode the sort kernels for
median and trimmed mean), whose round the card replays as a CUDA graph
(`fl/sweep.py`); the looped pytree routes stay eager (the reference jits
them: ROADMAP Queue 1 item 12).

Random draws.  Each round's draws are an input: `draws(t)` returns
{"h_abs": [U], "z": leaf dict or None, "jam": leaf dict or None}
(standard normals, `core.aggregation.round_draws`).  By default they come
from torch.Generators on the trainer's device: an int seed gives one
generator per stream (gains, noise, jamming), seeded like the sweep
engine's lane of that seed; a torch.Generator is used for every stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import aggregation as AGG
from repro_torch.core import defenses as DEF
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackType
from repro_torch.core.scenario import DefenseSpec
from repro_torch.device import resolve_device
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepSpec,
                                  lane_generator)
from repro_torch.launch.staging import as_device_array
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Draws = Callable[[int], Dict[str, object]]


@dataclasses.dataclass
class RoundLog:
    step: int
    loss: float
    accuracy: Optional[float] = None
    grad_norm: float = 0.0
    wall_s: float = 0.0


@dataclasses.dataclass
class FLTrainer:
    """loss_fn(params, batch) -> scalar; eval_fn(params) -> dict of
    metrics.  device defaults to 'cuda' and raises without a card.
    force_plain sends every kernel wrapper to its plain version even on
    the card (kernel-vs-plain checks only)."""

    loss_fn: Callable
    floa: FLOAConfig
    alpha: float                      # raw learning rate (eq. 8)
    mode: str = "floa"                # "floa" | "digital"
    defense: str = "mean"             # digital mode only
    defense_kwargs: Dict = dataclasses.field(default_factory=dict)
    eval_fn: Optional[Callable] = None
    device: Union[str, torch.device] = "cuda"
    force_plain: bool = False

    def __post_init__(self):
        if self.mode not in ("floa", "digital"):
            raise ValueError(f"mode must be 'floa' or 'digital', got "
                             f"{self.mode!r}")
        self.device = resolve_device(self.device)
        self.floa.validate()

    # ------------------------------------------------------------- a round

    def _round_step(self, params: Dict[str, Tensor], batch, draw):
        """One round: (params, batch, draw) -> (new params, loss, gn)."""
        floa, u = self.floa, self.floa.num_workers
        grads_u = AGG.per_worker_grads(self.loss_fn, params, batch, u)
        if self.mode == "floa":
            gagg, _ = AGG.aggregate(grads_u, floa, draws=draw)
        else:
            # digital attackers report sign-flipped gradients
            if (floa.attack.byzantine_mask
                    and floa.attack.attack != AttackType.NONE):
                sgn = torch.where(floa.attack.mask().to(self.device),
                                  -1.0, 1.0)
                grads_u = tree_map(
                    lambda g: g * sgn.reshape((-1,) + (1,) * (g.ndim - 1))
                    .to(g.dtype), grads_u)
            gagg = DEF.digital_aggregate(grads_u, self.defense,
                                         plain=self.force_plain,
                                         **self.defense_kwargs)
        with torch.no_grad():
            new_params = tree_map(lambda p, g: p - self.alpha * g.to(p.dtype),
                                  params, gagg)
            gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                for g in tree_leaves(gagg)))
            loss = self.loss_fn(new_params, batch)
        return new_params, loss, gn

    def _draw_provider(self, params: Dict[str, Tensor],
                       rng: Union[int, torch.Generator]) -> Draws:
        """The default draws of `run`: `round_draws` per round from the
        generators `rng` names (module docstring).  Digital rounds draw
        nothing."""
        if self.mode == "digital":
            return lambda t: None
        if isinstance(rng, torch.Generator):
            gens = (rng, rng, rng)
        else:
            gens = tuple(lane_generator(int(rng), slot, self.device)
                         for slot in (0, 1, 2))
        return lambda t: AGG.round_draws(self.floa, params, *gens)

    def _to_device(self, params) -> Dict[str, Tensor]:
        return tree_map(lambda v: torch.as_tensor(v, device=self.device)
                        .clone(), params)

    def _eval(self, params) -> dict:
        if self.eval_fn is None:
            return {}
        with torch.no_grad():
            return self.eval_fn(params)

    # ----------------------------------------------------------- the loops

    def _rounds(self, params: Dict[str, Tensor], batches, rng,
                draws: Optional[Draws]):
        """The round loop of `run` and `run_scan`: from device params, one
        round per batch of `batches` (device batch dicts), yielding (t,
        params, loss, gn, wall_s) after each."""
        draws = draws or self._draw_provider(params, rng)
        for t, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, loss, gn = self._round_step(params, batch, draws(t))
            yield t, params, loss, gn, time.perf_counter() - t0

    def run(self, params, sampler, rounds: int,
            rng: Union[int, torch.Generator] = 0, eval_every: int = 25,
            log_every: int = 0, draws: Optional[Draws] = None
            ) -> Tuple[Dict[str, Tensor], List[RoundLog]]:
        """`rounds` rounds on `sampler.next_round()` batches; logs on rounds
        with t % eval_every == 0 and on the last (eval_every=0: none).
        rng: an int seed or a torch.Generator for the default draws;
        draws: fn(t) -> the round's draws, overriding rng."""
        params = self._to_device(params)
        batches = ({k: as_device_array(v, self.device)
                    for k, v in sampler.next_round().items()}
                   for _ in range(rounds))
        logs: List[RoundLog] = []
        for t, params, loss, gn, wall in self._rounds(params, batches, rng,
                                                     draws):
            if eval_every and (t % eval_every == 0 or t == rounds - 1):
                metrics = self._eval(params)
                logs.append(RoundLog(
                    step=t, loss=float(loss),
                    accuracy=float(metrics.get("accuracy", np.nan)),
                    grad_norm=float(gn), wall_s=wall))
                if log_every:
                    print(f"  round {t:4d} loss {float(loss):8.4f} "
                          f"acc {logs[-1].accuracy:.4f}")
        return params, logs

    def run_scan(self, params, batches: Dict[str, np.ndarray],
                 rng: Union[int, torch.Generator] = 0, eval_every: int = 25,
                 flat: bool = False, draws: Optional[Draws] = None
                 ) -> Tuple[Dict[str, Tensor], List[RoundLog]]:
        """`run` on batches stacked up front ([R, ...] leaves, e.g.
        `FederatedSampler.stack_rounds(R)`).  Both run the same round loop,
        so with the same rng or draws the trajectory is `run`'s, bit for
        bit; only the log schedule changes: per-round loss and grad norm on
        `run`'s schedule, one eval of the final params, so logs carry the
        final accuracy only.

        flat=True runs the rounds as one lane of the sweep engine (flat
        [D] state; in digital mode the lane carries the defense, unless
        defense_kwargs do not fit a DefenseSpec, e.g. a geometric-median
        eps, which keeps the loop).  It equals that engine's lane exactly,
        and this trainer's loop on noiseless channels at fp rounding (the
        loop draws noise per leaf, the lane one [D] row).  Its rng must be
        an int seed (the lane's); draws in this trainer's format are
        flattened for the lane."""
        rounds = len(next(iter(batches.values())))
        if flat:
            defense = self._flat_defense()
            if defense is not None:
                return self._run_scan_flat(params, batches, rng, eval_every,
                                           rounds, defense, draws)
        params = self._to_device(params)
        stacked = {k: as_device_array(v, self.device)
                   for k, v in batches.items()}
        t0 = time.perf_counter()
        losses, gns = [], []
        for _, params, loss, gn, _ in self._rounds(
                params, ({k: v[t] for k, v in stacked.items()}
                         for t in range(rounds)), rng, draws):
            losses.append(loss)
            gns.append(gn)
        metrics = self._eval(params)
        loss = torch.stack(losses).cpu().numpy()
        gn = torch.stack(gns).cpu().numpy()
        wall = (time.perf_counter() - t0) / rounds
        return params, self._scan_logs(loss, gn, metrics.get("accuracy"),
                                       eval_every, wall)

    @staticmethod
    def _scan_logs(loss, gn, final_acc, eval_every: int, wall: float
                   ) -> List[RoundLog]:
        rounds = len(loss)
        acc = float("nan") if final_acc is None else float(final_acc)
        return [RoundLog(step=t, loss=float(loss[t]),
                         accuracy=acc if t == rounds - 1 else float("nan"),
                         grad_norm=float(gn[t]), wall_s=wall)
                for t in range(rounds)
                if eval_every and (t % eval_every == 0 or t == rounds - 1)]

    def _flat_defense(self) -> Optional[DefenseSpec]:
        """DefenseSpec of the flat lane, or None when defense_kwargs do not
        fit one (the loop then forwards them to the pytree defense)."""
        if self.mode != "digital":
            return DefenseSpec()
        try:
            return DefenseSpec.from_kwargs(self.defense,
                                           **self.defense_kwargs)
        except ValueError:
            return None

    def _lane_draws(self, draws: Draws) -> Draws:
        """This trainer's draws in the sweep's one-lane format: [1, U]
        gains, [1, D] rows flattened in the JAX package's leaf order."""
        def flat(x):
            if x is None:
                return None
            return torch.cat([v.reshape(-1) for v in tree_leaves(x)])[None]

        def lane(t):
            dr = draws(t) or {}
            h = dr.get("h_abs")
            u = self.floa.num_workers
            return {"h_abs": (torch.ones((1, u), device=self.device)
                              if h is None else h[None]),
                    "z": flat(dr.get("z")), "jam": flat(dr.get("jam"))}
        return lane

    def _run_scan_flat(self, params, batches, rng, eval_every: int,
                       rounds: int, defense: DefenseSpec,
                       draws: Optional[Draws]):
        """One-lane delegation to the sweep engine."""
        if draws is None and not isinstance(rng, (int, np.integer)):
            raise TypeError("run_scan(flat=True) needs an int seed (the "
                            "lane's) or explicit draws")
        spec = SweepSpec.build([ScenarioCase(
            "scan", self.floa, self.alpha,
            seed=int(rng) if draws is None else 0, defense=defense)])
        # eval_every=0: the final round only, run_scan's schedule
        engine = SweepEngine(self.loss_fn, spec, eval_fn=self.eval_fn,
                             eval_every=0, device=self.device,
                             force_plain=self.force_plain)
        if draws is not None:
            draws = self._lane_draws(draws)
        t0 = time.perf_counter()
        res = engine.run(params, batches, draws=draws)
        wall = (time.perf_counter() - t0) / rounds
        acc = res.metrics.get("accuracy")
        params_out = tree_map(lambda v: v[0], res.params)
        return params_out, self._scan_logs(
            res.loss[0], res.grad_norm[0],
            None if acc is None else acc[0, -1], eval_every, wall)

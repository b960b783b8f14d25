"""The paper's Figs. 1-4 (§IV) and the digital-defense grids as sweeps of
the port.

The port's counterpart of `benchmarks/common.py::run_figure`: MLP 784-64-10
(D = 50890), U = 10 workers, 3000 training samples i.i.d.-split, receive SNR
10 dB, Rayleigh CN(0,1) channels, the strongest attack (Thm 1), and the
learning rate set from the scaled alpha_hat = (Omega/omega) * alpha.  Each
figure is ONE `SweepEngine.run`: every experiment is a lane.

Two grids set the screening defenses the paper argues analog aggregation
cannot use beside FLOA-BEV, each one sweep under the grouped dispatch:
`defense_cases` / `run_defenses` (benchmarks/defenses_bench.py) and
`worker_grid` (benchmarks/sweep_bench.py, the large-U grid).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import PAPER_MLP
from repro_torch.core import theory
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig, noise_std_for_snr
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.data import FederatedSampler, make_dataset, worker_split
from repro_torch.device import resolve_device
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepResult,
                                  SweepSpec, as_device_array)
from repro_torch.models import init_mlp, mlp_accuracy, mlp_loss


@dataclasses.dataclass
class Experiment:
    name: str
    policy: Policy
    n_attackers: int = 0
    alpha_hat: float = 0.1
    attack: AttackType = AttackType.STRONGEST
    attacker_sigma: Optional[float] = None  # None = same as honest (1.0)
    rounds: int = 150
    seed: int = 42


def experiment_floa(exp: Experiment, mc=None) -> Tuple[FLOAConfig, float]:
    """Experiment -> (FLOAConfig, raw alpha) — the paper's §IV setup."""
    mc = mc or PAPER_MLP.full()
    u, d = mc.num_workers, mc.dim
    sigma = [exp.attacker_sigma if (exp.attacker_sigma is not None and
                                    i < exp.n_attackers) else mc.sigma
             for i in range(u)]
    tp = theory.TheoryParams(num_workers=u, num_attackers=exp.n_attackers,
                             dim=d, sigma=tuple(sigma), p_max=mc.p_max)
    pol = "ef" if exp.policy == Policy.EF else exp.policy.value
    alpha = theory.alpha_from_alpha_hat(tp, pol, exp.alpha_hat)

    zstd = (0.0 if exp.policy == Policy.EF
            else noise_std_for_snr(mc.p_max, d, mc.snr_db))
    floa = FLOAConfig(
        channel=ChannelConfig(num_workers=u, sigma=tuple(sigma),
                              noise_std=zstd),
        power=PowerConfig(num_workers=u, dim=d, p_max=mc.p_max,
                          policy=exp.policy),
        attack=AttackConfig(
            attack=exp.attack if exp.n_attackers else AttackType.NONE,
            byzantine_mask=first_n_mask(u, exp.n_attackers)),
    )
    return floa, alpha


def figure_setup(mc=None, device="cuda"):
    """Dataset + init + eval shared by every figure (and every lane).

    The init is the port's own He-normal draw from a seed-0 generator (JAX's
    PRNGKey(0) numbers cannot be reproduced; tests carry them across with
    `models.params_from_jax` instead)."""
    mc = mc or PAPER_MLP.full()
    dev = resolve_device(device)
    x, y = make_dataset(mc.train_samples, seed=0)
    xt, yt = make_dataset(mc.test_samples, seed=99)
    xt_t, yt_t = as_device_array(xt, dev), as_device_array(yt, dev)
    shards = worker_split(x, y, mc.num_workers)
    params = init_mlp(torch.Generator(dev).manual_seed(0), mc.d_in,
                      mc.d_hidden, mc.n_classes)
    eval_fn = lambda p: {"accuracy": mlp_accuracy(p, xt_t, yt_t)}  # noqa: E731
    return mc, shards, params, eval_fn


def cases_engine(cases: List[ScenarioCase], rounds: int,
                 eval_every: int = 10, mc=None, device="cuda",
                 force_plain: bool = False):
    """A sweep of `cases` on the figures' data and MLP, built but not run:
    (engine, params0, batches).

    Every lane uses the same dataset and batch sequence (sampler seed=1).
    force_plain is SweepEngine's test-only switch to the kernels' plain
    versions; the figures leave it off."""
    mc, shards, params, eval_fn = figure_setup(mc, device)
    batches = FederatedSampler(shards, mc.batch_per_worker,
                               seed=1).stack_rounds(rounds)
    engine = SweepEngine(mlp_loss, SweepSpec.build(cases), eval_fn=eval_fn,
                         eval_every=eval_every, device=device,
                         force_plain=force_plain)
    return engine, params, batches


def run_cases(cases: List[ScenarioCase], rounds: int, eval_every: int = 10,
              mc=None, device="cuda", force_plain: bool = False
              ) -> SweepResult:
    """`cases` as ONE sweep call on `device`, on the figures' data and MLP
    (mc sets U, which the cases must share)."""
    engine, params, batches = cases_engine(cases, rounds, eval_every, mc,
                                           device, force_plain)
    return engine.run(params, batches)


def figure_engine(exps: List[Experiment], eval_every: int = 10, mc=None,
                  device="cuda", force_plain: bool = False):
    """A figure's sweep, built but not run: (engine, params0, batches)."""
    mc = mc or PAPER_MLP.full()
    rounds = exps[0].rounds
    if any(e.rounds != rounds for e in exps):
        raise ValueError("one sweep, one R: experiments disagree on rounds")
    cases = [ScenarioCase(e.name, *experiment_floa(e, mc), seed=e.seed)
             for e in exps]
    return cases_engine(cases, rounds, eval_every, mc, device, force_plain)


def run_figure(exps: List[Experiment], eval_every: int = 10, mc=None,
               device="cuda", force_plain: bool = False) -> SweepResult:
    """All of a figure's experiments as ONE sweep call on `device`."""
    engine, params, batches = figure_engine(exps, eval_every, mc, device,
                                            force_plain)
    return engine.run(params, batches)


# benchmarks/defenses_bench.py's digital lanes, in its order.
DEFENSES = [
    ("mean", DefenseSpec(name="mean")),
    ("median", DefenseSpec(name="median")),
    ("trimmed_mean", DefenseSpec(name="trimmed_mean", trim=3)),
    ("krum", DefenseSpec(name="krum", num_byzantine=3)),
    ("geometric_median", DefenseSpec(name="geometric_median")),
]


def defense_cases(mc=None, n_attackers: int = 3) -> List[ScenarioCase]:
    """The digital-defense comparison: a FLOA-BEV lane under the strongest
    attack beside each screening defense of DEFENSES, whose lanes run in
    digital mode (EF power, noiseless, the same attackers reporting
    sign-flipped gradients)."""
    mc = mc or PAPER_MLP.full()
    u, d, n = mc.num_workers, mc.dim, n_attackers
    exp = Experiment(name=f"FLOA-BEV@N{n}", policy=Policy.BEV,
                     n_attackers=n, alpha_hat=0.1)
    cases = [ScenarioCase(exp.name, *experiment_floa(exp, mc), seed=exp.seed)]
    digital_floa = FLOAConfig(
        channel=ChannelConfig(num_workers=u, sigma=1.0, noise_std=0.0),
        power=PowerConfig(num_workers=u, dim=d, p_max=mc.p_max,
                          policy=Policy.EF),
        attack=AttackConfig(attack=AttackType.STRONGEST,
                            byzantine_mask=first_n_mask(u, n)))
    for name, spec in DEFENSES:
        cases.append(ScenarioCase(f"digital-{name}@N{n}", digital_floa, 0.1,
                                  seed=7, defense=spec))
    return cases


def run_defenses(rounds: int = 120, eval_every: int = 10, mc=None,
                 device="cuda", force_plain: bool = False) -> SweepResult:
    """The digital-defense comparison as ONE sweep call on `device`."""
    mc = mc or PAPER_MLP.full()
    return run_cases(defense_cases(mc), rounds, eval_every, mc, device,
                     force_plain)


def worker_grid(u: int, dim: int) -> List[ScenarioCase]:
    """Mixed-defense lanes at worker population U: one analog FLOA (BEV)
    lane plus median / trimmed-mean / Krum screening lanes, U//10 STRONGEST
    attackers (benchmarks/sweep_bench.py::worker_grid).  At U = 1000 the
    sorts take the bitonic kernel and Krum the blocked distances."""
    n_atk = max(1, u // 10)
    fams = [None,
            DefenseSpec(name="median"),
            DefenseSpec(name="trimmed_mean", trim=n_atk),
            DefenseSpec(name="krum", num_byzantine=n_atk)]
    cases = []
    for i, spec in enumerate(fams):
        floa = FLOAConfig(
            channel=ChannelConfig(num_workers=u, sigma=1.0,
                                  noise_std=0.05 if spec is None else 0.0),
            power=PowerConfig(num_workers=u, dim=dim, p_max=1.0,
                              policy=Policy.BEV if spec is None
                              else Policy.EF),
            attack=AttackConfig(attack=AttackType.STRONGEST,
                                byzantine_mask=first_n_mask(u, n_atk)))
        name = "floa" if spec is None else spec.name
        cases.append(ScenarioCase(f"{name}@U{u}", floa, 0.05, seed=400 + i,
                                  defense=spec or DefenseSpec()))
    return cases

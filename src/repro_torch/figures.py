"""The paper's Figs. 1-4 (§IV) and the digital-defense grids as sweeps of
the port.

The port's counterpart of `benchmarks/common.py::run_figure`: MLP 784-64-10
(D = 50890), U = 10 workers, 3000 training samples i.i.d.-split, receive SNR
10 dB, Rayleigh CN(0,1) channels, the strongest attack (Thm 1), and the
learning rate set from the scaled alpha_hat = (Omega/omega) * alpha.  Each
figure is ONE `SweepEngine.run`: every experiment is a lane.

`run_experiment` is the looped path of one experiment (`FLTrainer.run`,
benchmarks/common.py::run_experiment), the ground truth the sweep is held
against.

Three grids set the screening defenses the paper argues analog aggregation
cannot use beside FLOA, each one sweep under the grouped dispatch:
`defense_cases` / `run_defenses` (benchmarks/defenses_bench.py),
`worker_grid` (benchmarks/sweep_bench.py, the large-U grid), and the
Byzantine showdown `showdown_cases` / `run_showdown`
(examples/byzantine_showdown.py: BEV and CI beside every defense, with the
adaptive-adversary axes — Gauss-Markov fading, K-of-U participation,
colluding and omniscient cohorts — as lanes of the same sweep), with the
example's preemption-safe --checkpoint-dir / --resume as `run_showdown`'s
checkpoint_dir / resume.

The real-model LM lane (examples/train_floa_lm.py): `lm_lanes` /
`run_lm_lane` train the qwen3-shaped `lm_sweep` transformer (D = 2 950 528)
on the synthetic Markov token stream through ONE sweep: clean BEV, the
Thm-1 sign-flip attack on the same channel, and median screening of that
attack, at U = 8.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import PAPER_MLP, flat_param_dim, get_lm_sweep
from repro_torch.core import theory
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig, noise_std_for_snr
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.data import (FederatedSampler, make_dataset,
                              stack_token_rounds, worker_split)
from repro_torch.device import resolve_device
from repro_torch.fl.plan import ExecutionPlan
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepResult,
                                  SweepSpec)
from repro_torch.fl.trainer import FLTrainer, RoundLog
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.launch.staging import as_device_array
from repro_torch.models import init_mlp, mlp_accuracy, mlp_loss
from repro_torch.models.transformer import init_lm, lm_loss


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


def experiment_trainer(exp: Experiment, mc=None, device="cuda", **trainer_kw):
    """One experiment's looped run, built but not run: (FLTrainer, params0,
    sampler) on the figures' data and MLP (sampler seed=1).  trainer_kw go
    to FLTrainer (mode, defense, ...)."""
    mc, shards, params, eval_fn = figure_setup(mc, device)
    floa, alpha = experiment_floa(exp, mc)
    trainer = FLTrainer(loss_fn=mlp_loss, floa=floa, alpha=alpha,
                        eval_fn=eval_fn, device=device, **trainer_kw)
    return (trainer, params,
            FederatedSampler(shards, mc.batch_per_worker, seed=1))


def run_experiment(exp: Experiment, eval_every: int = 10, mc=None,
                   device="cuda") -> List[RoundLog]:
    """One experiment through the looped `FLTrainer.run` (draws seeded by
    exp.seed): its RoundLogs."""
    trainer, params, sampler = experiment_trainer(exp, mc, device)
    _, logs = trainer.run(params, sampler, exp.rounds, exp.seed,
                          eval_every=eval_every)
    return logs


def cases_engine(cases: List[ScenarioCase], rounds: int,
                 eval_every: int = 10, mc=None, device="cuda",
                 force_plain: bool = False, dirichlet: Optional[float] = None,
                 plan: Optional[ExecutionPlan] = None):
    """A sweep of `cases` on the figures' data and MLP, built but not run:
    (engine, params0, batches), under `plan` (default: the default plan).

    Every lane uses the same dataset and batch sequence (sampler seed=1),
    over the i.i.d. shards, or over a Dirichlet(dirichlet) label-skew split
    (`FederatedSampler.dirichlet`, seed 1).  force_plain is SweepEngine's
    test-only switch to the kernels' plain versions; the figures leave it
    off."""
    mc, shards, params, eval_fn = figure_setup(mc, device)
    if dirichlet is None:
        sampler = FederatedSampler(shards, mc.batch_per_worker, seed=1)
    else:
        x, y = make_dataset(mc.train_samples, seed=0)
        sampler = FederatedSampler.dirichlet(x, y, mc.num_workers, dirichlet,
                                             mc.batch_per_worker, seed=1)
    batches = sampler.stack_rounds(rounds)
    engine = SweepEngine(mlp_loss, SweepSpec.build(cases), eval_fn=eval_fn,
                         eval_every=eval_every, plan=plan, device=device,
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
                  device="cuda", force_plain: bool = False,
                  plan: Optional[ExecutionPlan] = None):
    """A figure's sweep, built but not run: (engine, params0, batches),
    under `plan` (default: the default plan)."""
    mc = mc or PAPER_MLP.full()
    rounds = exps[0].rounds
    if any(e.rounds != rounds for e in exps):
        raise ValueError("one sweep, one R: experiments disagree on rounds")
    cases = [ScenarioCase(e.name, *experiment_floa(e, mc), seed=e.seed)
             for e in exps]
    return cases_engine(cases, rounds, eval_every, mc, device, force_plain,
                        plan=plan)


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


# examples/byzantine_showdown.py's grid: attacker counts, the fading rho,
# K of K-of-U participation (7 of 10 meets every digital lane's bound:
# 2*trim < K, krum f <= K-3, m <= K) and the defense lanes, in its order.
SHOWDOWN_NS = (0, 1, 3, 4)
SHOWDOWN_MARKOV_RHO = 0.9
SHOWDOWN_PART_K = 7
SHOWDOWN_DIGITAL = [
    ("digital mean (no defense)", DefenseSpec(name="mean")),
    ("digital median", DefenseSpec(name="median")),
    ("digital trimmed-mean(3)", DefenseSpec(name="trimmed_mean", trim=3)),
    ("digital Krum(f=3)", DefenseSpec(name="krum", num_byzantine=3)),
    ("digital multi-Krum(f=3,m=3)",
     DefenseSpec(name="multi_krum", num_byzantine=3, multi=3)),
    ("digital geometric-median", DefenseSpec(name="geometric_median")),
]
SHOWDOWN_DIGITAL_PART = SHOWDOWN_DIGITAL[1:3]
SHOWDOWN_DIRECTIONAL = [("colluding", AttackType.COLLUDING),
                        ("omniscient", AttackType.OMNISCIENT)]


def _showdown_floa(mc, n_atk: int, policy: Policy, noise: float,
                   attack: AttackType = AttackType.STRONGEST,
                   markov_rho: float = 0.0) -> FLOAConfig:
    u, d = mc.num_workers, mc.dim
    return FLOAConfig(
        channel=ChannelConfig(num_workers=u, sigma=1.0, noise_std=noise,
                              markov_rho=markov_rho),
        power=PowerConfig(num_workers=u, dim=d, p_max=mc.p_max,
                          policy=policy),
        attack=AttackConfig(attack=attack if n_atk else AttackType.NONE,
                            byzantine_mask=first_n_mask(u, n_atk)))


def _showdown_alpha(mc, n: int, policy: Policy) -> float:
    tp = theory.TheoryParams(num_workers=mc.num_workers, num_attackers=n,
                             dim=mc.dim)
    return theory.alpha_from_alpha_hat(tp, policy.value, 0.1)


def showdown_cases(mc=None) -> List[ScenarioCase]:
    """The Byzantine showdown's 68 lanes, as
    examples/byzantine_showdown.py::build_cases builds them: per policy
    (BEV, CI) and attacker count, a plain, a Markov-fading and a K-of-U
    lane, then the colluding and omniscient cohorts; each digital defense
    per attacker count (EF, noiseless); median and trimmed mean under K-of-U
    participation."""
    mc = mc or PAPER_MLP.full()
    noise = noise_std_for_snr(mc.p_max, mc.dim, mc.snr_db)
    k, rho = SHOWDOWN_PART_K, SHOWDOWN_MARKOV_RHO
    cases = []
    for policy in (Policy.BEV, Policy.CI):
        pv = policy.value
        for n in SHOWDOWN_NS:
            alpha = _showdown_alpha(mc, n, policy)
            cases += [
                ScenarioCase(f"{pv}@N{n}",
                             _showdown_floa(mc, n, policy, noise), alpha,
                             seed=5),
                ScenarioCase(f"{pv}/markov@N{n}",
                             _showdown_floa(mc, n, policy, noise,
                                            markov_rho=rho), alpha, seed=5),
                ScenarioCase(f"{pv}/K{k}@N{n}",
                             _showdown_floa(mc, n, policy, noise), alpha,
                             seed=5, participants=k)]
        for tag, atk in SHOWDOWN_DIRECTIONAL:
            for n in SHOWDOWN_NS[1:]:
                cases.append(ScenarioCase(
                    f"{pv}/{tag}@N{n}",
                    _showdown_floa(mc, n, policy, noise, attack=atk),
                    _showdown_alpha(mc, n, policy), seed=5))
    for label, defense in SHOWDOWN_DIGITAL:
        for n in SHOWDOWN_NS:
            cases.append(ScenarioCase(
                f"{label}@N{n}", _showdown_floa(mc, n, Policy.EF, 0.0), 0.1,
                seed=5, defense=defense))
    for label, defense in SHOWDOWN_DIGITAL_PART:
        for n in SHOWDOWN_NS:
            cases.append(ScenarioCase(
                f"{label}/K{k}@N{n}", _showdown_floa(mc, n, Policy.EF, 0.0),
                0.1, seed=5, defense=defense, participants=k))
    return cases


def showdown_engine(rounds: int, dirichlet: Optional[float] = None, mc=None,
                    device="cuda", force_plain: bool = False,
                    checkpoint_dir: Optional[str] = None):
    """The showdown sweep, built but not run: (engine, params0, batches).
    Eval on round 0 and the last (the example's eval_every=R).  With a
    checkpoint directory the example's plan: chunks of max(1, R // 4)
    rounds, a checkpoint at each chunk boundary."""
    mc = mc or PAPER_MLP.full()
    plan = (ExecutionPlan() if checkpoint_dir is None
            else ExecutionPlan(chunk_rounds=max(1, rounds // 4),
                               checkpoint_dir=checkpoint_dir))
    return cases_engine(showdown_cases(mc), rounds, eval_every=rounds,
                        mc=mc, device=device, force_plain=force_plain,
                        dirichlet=dirichlet, plan=plan)


def run_showdown(rounds: int = 100, dirichlet: Optional[float] = None,
                 mc=None, device="cuda", force_plain: bool = False,
                 checkpoint_dir: Optional[str] = None, resume: bool = False
                 ) -> SweepResult:
    """The Byzantine showdown as ONE sweep call on `device`: i.i.d. shards,
    or a Dirichlet(dirichlet) label-skew split.  As the example's
    --checkpoint-dir / --resume: `checkpoint_dir` snapshots the sweep at
    chunk boundaries (`showdown_engine`), and resume=True continues a killed
    run from its latest checkpoint, bitwise as the uninterrupted run (a
    fresh run when there is none yet)."""
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    engine, params, batches = showdown_engine(rounds, dirichlet, mc, device,
                                              force_plain, checkpoint_dir)
    return engine.run(params, batches, resume=resume)


def lm_lanes(u: int, dim: int, n_atk: int, lr: float) -> List[ScenarioCase]:
    """The LM lane's three lanes (examples/train_floa_lm.py::lm_lanes):
    no-attack BEV FLOA (noise 0.05, seed 11), the Thm-1 sign-flip attack
    on the same channel (seed 12), and median screening of that attack
    (EF, noiseless, seed 13)."""
    def floa(policy, attack, n, noise=0.05):
        return FLOAConfig(
            channel=ChannelConfig(num_workers=u, sigma=1.0,
                                  noise_std=0.0 if policy == Policy.EF
                                  else noise),
            power=PowerConfig(num_workers=u, dim=dim, p_max=1.0,
                              policy=policy),
            attack=AttackConfig(attack=attack if n else AttackType.NONE,
                                byzantine_mask=first_n_mask(u, n)))

    return [
        ScenarioCase("bev-clean", floa(Policy.BEV, AttackType.NONE, 0),
                     lr, seed=11),
        ScenarioCase("bev-signflip",
                     floa(Policy.BEV, AttackType.STRONGEST, n_atk),
                     lr, seed=12),
        ScenarioCase("median-signflip",
                     floa(Policy.EF, AttackType.STRONGEST, n_atk, noise=0.0),
                     lr, seed=13, defense=DefenseSpec(name="median")),
    ]


def lm_lane_engine(rounds: int, *, cfg=None, workers: int = 8,
                   batch: int = 2, seq: int = 64, byzantine: int = 2,
                   lr: float = 0.2, chunk_rounds: Optional[int] = None,
                   checkpoint_dir: Optional[str] = None, device="cuda",
                   plain: bool = False, model_shards: int = 1):
    """The LM lane's sweep, built but not run: (engine, params0, batches).
    cfg defaults to `configs.get_lm_sweep()`; the weights are the port's
    own draw from a seed-0 generator; the batches one Markov token batch a
    round, [R, U*B, seq+1] (`stack_token_rounds(..., seed=0)`), which
    `per_worker_grads` splits into U workers of B sequences.  As the
    example: a checkpoint directory without chunk_rounds takes chunks of
    max(1, R // 4); model_shards > 1 shards the flat state's D over the
    ("model",) mesh of every rank of the process group
    (`make_sweep_mesh(model_shards=...)`, as the example's
    --model-shards), so every rank calls it.  plain=True is SweepEngine's
    force_plain (kernel-vs-plain checks)."""
    mesh = (make_sweep_mesh(model_shards=model_shards) if model_shards > 1
            else None)
    cfg = cfg or get_lm_sweep()
    dev = resolve_device(device)
    dim = flat_param_dim(cfg)
    spec = SweepSpec.build(lm_lanes(workers, dim, byzantine, lr))
    batches = {"tokens": stack_token_rounds(
        rounds, workers * batch, seq + 1, cfg.vocab_size, seed=0)}
    params0 = init_lm(torch.Generator(dev).manual_seed(0), cfg, dev)
    if checkpoint_dir is not None and chunk_rounds is None:
        chunk_rounds = max(1, rounds // 4)
    plan = ExecutionPlan(mesh=mesh, chunk_rounds=chunk_rounds,
                         checkpoint_dir=checkpoint_dir)
    engine = SweepEngine(lambda p, b: lm_loss(p, b, cfg), spec, plan=plan,
                         device=dev, force_plain=plain)
    return engine, params0, batches


def run_lm_lane(rounds: int, *, cfg=None, workers: int = 8, batch: int = 2,
                seq: int = 64, byzantine: int = 2, lr: float = 0.2,
                chunk_rounds: Optional[int] = None,
                checkpoint_dir: Optional[str] = None, resume: bool = False,
                device="cuda", plain: bool = False, draws=None,
                model_shards: int = 1) -> SweepResult:
    """examples/train_floa_lm.py as ONE sweep call on `device`
    (`lm_lane_engine`); resume=True continues from checkpoint_dir's latest
    checkpoint (a fresh run when there is none yet); draws overrides the
    lanes' seeded draws (`SweepEngine.run`); model_shards > 1 runs on every
    rank of the process group, each returning the full result."""
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True requires checkpoint_dir")
    engine, params, batches = lm_lane_engine(
        rounds, cfg=cfg, workers=workers, batch=batch, seq=seq,
        byzantine=byzantine, lr=lr, chunk_rounds=chunk_rounds,
        checkpoint_dir=checkpoint_dir, device=device, plain=plain,
        model_shards=model_shards)
    return engine.run(params, batches, draws=draws, resume=resume)

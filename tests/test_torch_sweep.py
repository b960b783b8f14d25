"""The port's sweep (`repro_torch.fl.sweep`, `repro_torch.figures`) against
the JAX `SweepEngine`, plus the port's own contracts.

Parity: the lanes of Figs. 1-4 (EF / CI / BEV benign; CI / BEV x alpha_hat
under one weak or strong attacker; CI / BEV under 1-4 attackers) and a
GAUSSIAN-jamming sweep (the combine-only route) run through both engines from the same weights (carried across
with `params_from_jax`), the same batches, and the same random draws: a
replay provider re-derives the JAX engine's per-round key schedule
(`split(keys)` -> subkeys -> `split(sub, 3)`: slot 0 gains, 1 noise, 2
jamming) in this process, under the same `jax_threefry_partitionable`
setting as the reference run.  Smoke-size data, a narrow MLP (d_hidden=16),
5 rounds.  Tolerance: rtol 1e-5 on loss / grad norm / final state.  The two
frameworks sum the per-worker gradients and the combine in different
orders, and a CI lane's 1/|h| channel inversion and the strongest
attacker's 1/(gbar^2 + eps^2) amplitude scale those ulp-level differences
up round by round; measured here they stay near 1e-7.

The digital-defense grids (FLOA-BEV beside mean / median / trimmed mean /
Krum / geometric median, and the mixed large-U worker grid at U = 70 on
sweep_bench's tiny MLP, where Krum takes the blocked distances) run the
same way under the grouped dispatch, the default plan on both sides.
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core as JC
    import repro.fl as JFL
    from repro.configs import PAPER_MLP as JPAPER
    from repro.data import FederatedSampler, make_dataset, worker_split
    from repro.models import init_mlp, mlp_accuracy
    from repro.models import mlp_loss as jmlp_loss
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmarks.defenses_bench import DEFENSES as JDEFENSES
    from benchmarks.sweep_bench import worker_grid as jworker_grid

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP as TPAPER
from repro_torch.core.attacks import AttackType
from repro_torch.core.power_control import Policy
from repro_torch.fl import sweep as TS
from repro_torch.kernels import ops as tops
from repro_torch.models import mlp as TM
from torch_parity import (assert_sweeps_match, jax_case, jax_floa,
                          replay_sweep_draws)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ROUNDS = 5
RTOL = 1e-5
MC = dataclasses.replace(JPAPER.smoke(), d_hidden=16)
TPAPER_SMOKE = dataclasses.replace(TPAPER.smoke(), d_hidden=16)

LANES = {
    "fig1": [TF.Experiment(n, p, rounds=ROUNDS)
             for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                          ("BEV", Policy.BEV)]],
    "fig2": [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                           attacker_sigma=0.3, rounds=ROUNDS)
             for ah in (0.1, 1.0, 2.0) for n, p in [("CI", Policy.CI),
                                                    ("BEV", Policy.BEV)]],
    "fig3": [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                           attacker_sigma=3.0, rounds=ROUNDS)
             for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                               ("BEV", Policy.BEV)]],
    "fig4": [TF.Experiment(f"{n}@N{k}", p, n_attackers=k, rounds=ROUNDS)
             for k in (1, 2, 3, 4) for n, p in [("CI", Policy.CI),
                                                ("BEV", Policy.BEV)]],
    "gaussian": [TF.Experiment("BEV-gauss", Policy.BEV, n_attackers=2,
                               attack=AttackType.GAUSSIAN, rounds=ROUNDS,
                               seed=7),
                 TF.Experiment("CI-strong", Policy.CI, n_attackers=1,
                               rounds=ROUNDS, seed=8)],
}


_jax_floa, _jax_case = jax_floa, jax_case
# the JAX engine's draws (split slots and fold_in side channels), replayed
_replay_draws = replay_sweep_draws


@pytest.mark.parametrize("fig", sorted(LANES))
def test_sweep_matches_jax_engine(fig):
    exps = LANES[fig]
    tcases = [TS.ScenarioCase(e.name, *TF.experiment_floa(e, MC), seed=e.seed)
              for e in exps]
    jcases = [JFL.ScenarioCase(c.name, _jax_floa(c.floa), c.alpha,
                               seed=c.seed) for c in tcases]
    tspec, jspec = TS.SweepSpec.build(tcases), JFL.SweepSpec.build(jcases)
    # all-analog lanes: the port's analog gates are the JAX engine's
    assert (tspec.analog_noise, tspec.analog_jamming) == (jspec.any_noise,
                                                          jspec.any_jamming)
    x, y = make_dataset(MC.train_samples, seed=0)
    xt, yt = make_dataset(MC.test_samples, seed=99)
    batches = FederatedSampler(worker_split(x, y, MC.num_workers),
                               MC.batch_per_worker,
                               seed=1).stack_rounds(ROUNDS)
    jp = init_mlp(jax.random.PRNGKey(0), d_hidden=MC.d_hidden)
    xt_j, yt_j = jnp.asarray(xt), jnp.asarray(yt)
    want = JFL.SweepEngine(
        jmlp_loss, jspec, eval_every=2,
        eval_fn=lambda p: {"accuracy": mlp_accuracy(p, xt_j, yt_j)},
    ).run(jp, batches)

    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    xt_t = torch.from_numpy(xt.astype(np.float32))
    yt_t = torch.from_numpy(yt)
    d = sum(int(v.size) for v in jp.values())
    got = TS.SweepEngine(
        TM.mlp_loss, tspec, eval_every=2, device="cpu",
        eval_fn=lambda p: {"accuracy": TM.mlp_accuracy(p, xt_t, yt_t)},
    ).run(tp, batches, draws=_replay_draws(jspec, ROUNDS, d))

    assert got.names == want.names
    np.testing.assert_allclose(got.loss, want.loss, rtol=RTOL)
    np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=RTOL)
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(want.params[k]), rtol=RTOL,
                                   atol=1e-7)
    acc_t, acc_j = got.metrics["accuracy"], want.metrics["accuracy"]
    assert np.array_equal(np.isnan(acc_t), np.isnan(acc_j))
    assert np.isnan(acc_t[:, 1]).all() and not np.isnan(acc_t[:, -1]).any()
    np.testing.assert_allclose(acc_t[~np.isnan(acc_t)],
                               acc_j[~np.isnan(acc_j)], atol=0.011)


_assert_sweeps_match = assert_sweeps_match


def _tiny_mlp_problem(u):
    """benchmarks/sweep_bench.py::bench_workers' model: relu(x w1) w2, MSE,
    d_in 16, d_h 4 (D = 68), one sample per worker per round."""
    d_in, d_h = 16, 4
    k = jax.random.PRNGKey(0)
    jp = {"w1": jax.random.normal(k, (d_in, d_h)),
          "w2": jax.random.normal(k, (d_h, 1))}
    rng = np.random.default_rng(u)
    batches = {"x": rng.normal(size=(ROUNDS, u, d_in)).astype(np.float32),
               "y": rng.normal(size=(ROUNDS, u, 1)).astype(np.float32)}

    def jloss(params, b):
        pred = jax.nn.relu(b["x"] @ params["w1"]) @ params["w2"]
        return jnp.mean((pred - b["y"]) ** 2)

    def tloss(params, b):
        pred = torch.relu(b["x"] @ params["w1"]) @ params["w2"]
        return torch.mean((pred - b["y"]) ** 2)

    return jp, batches, jloss, tloss, d_in * d_h + d_h


@pytest.mark.parametrize("grid", ["defenses", "worker_grid_u70"])
def test_grouped_sweep_matches_jax_engine(grid):
    """The digital-defense grids through both engines' grouped dispatch,
    from the same weights, batches and draws."""
    if grid == "defenses":
        tcases = TF.defense_cases(TPAPER_SMOKE)
        x, y = make_dataset(MC.train_samples, seed=0)
        batches = FederatedSampler(worker_split(x, y, MC.num_workers),
                                   MC.batch_per_worker,
                                   seed=1).stack_rounds(ROUNDS)
        jp = init_mlp(jax.random.PRNGKey(0), d_hidden=MC.d_hidden)
        jloss, tloss = jmlp_loss, TM.mlp_loss
        d = sum(int(v.size) for v in jp.values())
    else:
        # lr 0.01, not the grid's 0.05: at 0.05 the analog BEV lane of this
        # MSE regression diverges to NaN by round 3 in both engines
        jp, batches, jloss, tloss, d = _tiny_mlp_problem(70)
        tcases = [dataclasses.replace(c, alpha=0.01)
                  for c in TF.worker_grid(70, d)]
    jspec = JFL.SweepSpec.build([_jax_case(c) for c in tcases])
    tspec = TS.SweepSpec.build(tcases)
    for gate in ("lane_codes", "digital_codes", "any_digital", "all_digital",
                 "analog_noise", "analog_jamming", "gm_iters"):
        assert getattr(tspec, gate) == getattr(jspec, gate), gate
    want = JFL.SweepEngine(jloss, jspec).run(jp, batches)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    tops.reset_launches()
    got = TS.SweepEngine(tloss, tspec, device="cpu").run(
        tp, batches, draws=_replay_draws(jspec, ROUNDS, d))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    _assert_sweeps_match(got, want)


def test_defense_grids_mirror_the_benchmarks():
    """figures.defense_cases / worker_grid are benchmarks/defenses_bench.py's
    and sweep_bench.py's grids: the same defenses, hyper-parameters,
    attackers, policies, noise and seeds."""
    assert [(n, dataclasses.asdict(s)) for n, s in TF.DEFENSES] == [
        (n, dataclasses.asdict(s)) for n, s in JDEFENSES]
    for u in (10, 1000):
        got = [_jax_case(c) for c in TF.worker_grid(u, 68)]
        assert got == jworker_grid(u, 68)
    cases = TF.defense_cases(TPAPER_SMOKE)
    assert [c.name for c in cases] == ["FLOA-BEV@N3"] + [
        f"digital-{n}@N3" for n, _ in JDEFENSES]
    assert all(c.floa.attack.byzantine_mask[:4] == (True, True, True, False)
               for c in cases)


def test_run_figure_on_cpu_learns_and_is_deterministic():
    """The figures' entry point end to end at smoke size on the CPU: the
    plain route, no kernel launched, losses fall, two runs agree exactly
    (the draws come from per-lane seeded generators)."""
    exps = [TF.Experiment(n, p, rounds=6)
            for n, p in [("EF", Policy.EF), ("BEV", Policy.BEV)]]
    tops.reset_launches()
    r1 = TF.run_figure(exps, eval_every=3, mc=TPAPER_SMOKE, device="cpu")
    r2 = TF.run_figure(exps, eval_every=3, mc=TPAPER_SMOKE, device="cpu")
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert r1.loss.shape == r1.grad_norm.shape == (2, 6)
    assert np.isfinite(r1.loss).all()
    assert (r1.loss[:, -1] < r1.loss[:, 0]).all()
    assert np.array_equal(r1.loss, r2.loss)
    assert all(torch.equal(r1.params[k], r2.params[k]) for k in r1.params)
    acc = r1.metrics["accuracy"]
    assert np.isnan(acc[:, [1, 2, 4]]).all() and np.isfinite(
        acc[:, [0, 3, 5]]).all()
    assert r1.index("BEV") == 1


def test_port_imports_no_jax():
    code = ("import sys, repro_torch.fl.sweep, repro_torch.figures, "
            "repro_torch.kernels.ops, repro_torch.core.defenses, "
            "repro_torch.kernels.defense_sort, repro_torch.fl.trainer, "
            "repro_torch.data.pipeline, repro_torch.fl.plan, "
            "repro_torch.checkpoint, repro_torch.launch.staging, "
            "repro_torch.tree, repro_torch.optim, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.models.transformer, repro_torch.configs.registry, "
            "repro_torch.launch.distributed, repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_default_device_raises_without_a_card(monkeypatch):
    """Entry points default to 'cuda' and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exps = LANES["fig1"]
    spec = TS.SweepSpec.build([TS.ScenarioCase(
        e.name, *TF.experiment_floa(e, MC)) for e in exps])
    with pytest.raises(RuntimeError, match="cuda"):
        TS.SweepEngine(TM.mlp_loss, spec)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.run_sweep(TM.mlp_loss, {}, {}, spec)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.run_figure(exps, mc=TPAPER_SMOKE)


def _case(**kw):
    e = TF.Experiment("lane", Policy.BEV, n_attackers=1)
    floa, alpha = TF.experiment_floa(e, MC)
    if "attack" in kw:
        floa = dataclasses.replace(floa, attack=dataclasses.replace(
            floa.attack, attack=kw.pop("attack")))
    if "markov_rho" in kw:
        floa = dataclasses.replace(floa, channel=dataclasses.replace(
            floa.channel, markov_rho=kw.pop("markov_rho")))
    return TS.ScenarioCase("lane", floa, alpha, **kw)


def _mesh(**axes):
    """A stand-in for a JAX sweep mesh: its axis names and shape."""
    return SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


# Plans whose mesh is a stand-in with the reference mesh's axis names and
# shape but no process groups: the engine refuses them (a sharded sweep
# needs a `launch.mesh.SweepMesh`, tests/test_torch_sharded.py), and the
# single-device plans the port runs since the execution-plan slice.
REFUSED_PLANS = {
    "mesh": lambda: TS.ExecutionPlan(mesh=_mesh(data=2)),
    "worker_shards": lambda: TS.ExecutionPlan(mesh=_mesh(workers=2)),
    "model_shards": lambda: TS.ExecutionPlan(mesh=_mesh(model=2)),
    "mesh_3d": lambda: TS.ExecutionPlan(mesh=_mesh(data=1, workers=2,
                                                   model=2)),
}
ACCEPTED_PLANS = {
    "chunk_rounds": dict(chunk_rounds=4),
    "checkpoint_dir": dict(chunk_rounds=4, checkpoint_dir="/nonexistent"),
    "strict_numerics": dict(strict_numerics=True),
    "tree_state": dict(flat_state=False),
    "switch_dispatch": dict(grouped_dispatch=False),
}


def test_spec_validates_digital_lanes():
    """SweepSpec checks each digital lane's DefenseSpec against U and makes
    the geometric-median lanes share gm_iters, as the JAX spec does."""
    gm = lambda it: _case(defense=TF.DefenseSpec(  # noqa: E731
        name="geometric_median", gm_iters=it))
    with pytest.raises(ValueError, match="gm_iters"):
        TS.SweepSpec.build([gm(4), gm(8)])
    assert TS.SweepSpec.build([gm(4), gm(4)]).gm_iters == 4
    with pytest.raises(ValueError, match="trim"):
        TS.SweepSpec.build([_case(defense=TF.DefenseSpec(
            name="trimmed_mean", trim=MC.num_workers // 2))])
    with pytest.raises(TypeError, match="DefenseSpec"):
        TS.SweepSpec.build([_case(defense="median")])


@pytest.mark.parametrize("name", sorted(REFUSED_PLANS))
def test_non_default_plans_are_refused(name):
    """A mesh, worker shards or model shards on a stand-in mesh without
    process groups: refused at construction, naming the mesh type the
    engine needs."""
    spec = TS.SweepSpec.build([_case()])
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        TS.SweepEngine(TM.mlp_loss, spec, plan=REFUSED_PLANS[name](),
                       device="cpu")
    TS.SweepEngine(TM.mlp_loss, spec, plan=TS.ExecutionPlan(), device="cpu")


@pytest.mark.parametrize("name", sorted(ACCEPTED_PLANS))
def test_single_device_plans_are_accepted(name):
    """Every knob one device can express builds an engine that mirrors it."""
    spec = TS.SweepSpec.build([_case()])
    plan = TS.ExecutionPlan(**ACCEPTED_PLANS[name])
    engine = TS.SweepEngine(TM.mlp_loss, spec, plan=plan, device="cpu")
    assert engine.plan == plan
    for knob, value in ACCEPTED_PLANS[name].items():
        assert getattr(engine, knob) == value


def test_bad_draws_are_rejected():
    engine, params, batches = TF.figure_engine(
        [TF.Experiment("lane", Policy.BEV, rounds=1)], mc=TPAPER_SMOKE,
        device="cpu")
    with pytest.raises(ValueError, match="h_abs"):
        engine.run(params, batches,
                   draws=lambda t: {"h_abs": torch.ones(1, 3), "z": None,
                                    "jam": None})

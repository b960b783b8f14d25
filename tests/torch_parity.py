"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
port's configs as the JAX package's, replays of the JAX engines' key
schedules as the port's draws, the tiny regression MLP in both frameworks,
and the sweep comparison.

Replays: threefry and Philox cannot give the same numbers, so the JAX
engines' draws are re-derived here from their key schedules and handed to
the port as inputs.

  - `replay_sweep_draws`: the sweep (repro/fl/sweep.py) splits each lane's
    key per round (`split(keys)` -> subkeys), then `split(sub, 3)` for
    gains / noise / jamming, and draws the adaptive axes from fold_in side
    channels: 3 the colluding direction, 4 the fading innovation, 5 the
    participation mask, and 7, on the lane's base key, the initial gains.
  - `replay_trainer_draws`: the looped trainer (repro/fl/trainer.py) splits
    its key per round, then `split(sub, 3)` in `aggregate`, and draws
    noise and jamming per leaf with `fold_in(k, i)` in `tree_flatten`
    order (sorted dict keys).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core as JC
    import repro.fl as JFL
    from repro.core import scenario as JSC
    from repro.core.channel import rayleigh_gains
    from sweep_testlib import U

from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.fl import sweep as TS
from repro_torch.tree import tree_leaves, tree_paths

RTOL = 1e-5

# The JAX sweep's fold_in constants (repro/fl/sweep.py).
FOLD_COLLUDE, FOLD_MARKOV, FOLD_PART, FOLD_H_INIT = 3, 4, 5, 7


def jax_floa(cfg):
    """The port's FLOAConfig as the JAX package's."""
    return JC.FLOAConfig(
        channel=JC.ChannelConfig(cfg.channel.num_workers, cfg.channel.sigma,
                                 cfg.channel.noise_std,
                                 cfg.channel.markov_rho),
        power=JC.PowerConfig(cfg.power.num_workers, cfg.power.dim,
                             cfg.power.p_max, JC.Policy(cfg.power.policy.value)),
        attack=JC.AttackConfig(JC.AttackType(cfg.attack.attack.value),
                               cfg.attack.byzantine_mask))


def jax_case(c):
    """The port's ScenarioCase as the JAX package's."""
    return JFL.ScenarioCase(c.name, jax_floa(c.floa), c.alpha, seed=c.seed,
                            defense=JC.DefenseSpec(
                                **dataclasses.asdict(c.defense)),
                            participants=c.participants)


def port_floa(cfg):
    """The JAX package's FLOAConfig as the port's (`jax_floa`'s inverse)."""
    return FLOAConfig(
        channel=ChannelConfig(cfg.channel.num_workers, cfg.channel.sigma,
                              cfg.channel.noise_std, cfg.channel.markov_rho),
        power=PowerConfig(cfg.power.num_workers, cfg.power.dim,
                          cfg.power.p_max, Policy(cfg.power.policy.value)),
        attack=AttackConfig(AttackType(cfg.attack.attack.value),
                            cfg.attack.byzantine_mask))


def port_case(c):
    """The JAX package's ScenarioCase as the port's (`jax_case`'s
    inverse)."""
    return TS.ScenarioCase(c.name, port_floa(c.floa), c.alpha, seed=c.seed,
                           defense=DefenseSpec(
                               **dataclasses.asdict(c.defense)),
                           participants=c.participants)


def _t(x):
    return torch.from_numpy(np.array(x))


def replay_sweep_draws(jspec, rounds, d):
    """The JAX sweep's per-round draws for every lane of `jspec`, in the
    port's draw format (fl/sweep.py); the grouped engines consume the
    analog lanes' channel draws."""
    sp, keys = jspec.stacked_params(), jspec.keys()
    u = jspec.num_workers

    def normal(shape, fold=None):
        def one(k):
            k = k if fold is None else jax.random.fold_in(k, fold)
            return jax.random.normal(k, shape, jnp.float32)
        return jax.vmap(one)

    h_init = normal((u, 2), FOLD_H_INIT)(keys)
    out = []
    for t in range(rounds):
        split = jax.vmap(jax.random.split)(keys)
        keys, subs = split[:, 0], split[:, 1]
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(subs)
        draw = {
            "h_abs": _t(jax.vmap(JSC.sample_gains)(ks[:, 0], sp)),
            "z": _t(normal((d,))(ks[:, 1])) if jspec.any_noise else None,
            "jam": _t(normal((d,))(ks[:, 2])) if jspec.any_jamming else None}
        if jspec.any_partial:
            draw["part"] = _t(jax.vmap(lambda k, pk: JSC.participation_mask(
                jax.random.fold_in(k, FOLD_PART), pk, u))(subs, sp.part_k))
        if jspec.any_markov:
            draw["markov"] = _t(normal((u, 2), FOLD_MARKOV)(subs))
            if t == 0:
                draw["h_init"] = _t(h_init)
        if jspec.any_directional:
            draw["dir"] = _t(normal((d,), FOLD_COLLUDE)(subs))
        out.append(draw)
    return lambda t: out[t]


def replay_numpy_draws(jspec, rounds, d):
    """`replay_sweep_draws` as a list (by round) of dicts of numpy arrays:
    what the multi-process drivers load (`run_ranks`)."""
    draws = replay_sweep_draws(jspec, rounds, d)
    return [{k: None if v is None else v.numpy() for k, v in draws(t).items()}
            for t in range(rounds)]


# ------------------------------------------ multi-process runs of the port

DRIVER = Path(__file__).resolve().parent / "torch_dist_driver.py"
SPAWN_TIMEOUT_S = 300


def run_ranks(jobs, world, workdir):
    """Run `jobs` (tests/torch_dist_driver.py's job dicts: the sweep kinds
    and the LM-step kinds train_step, prefill, decode, serve, seq_partial
    and refusals) on `world` CPU ranks of a gloo process group (a
    FileStore in `workdir`, no ports); every rank's exit must be 0.
    Returns {file stem: result dict}, one stem per job and rank
    (`<name>.r<rank>`), and the `.base` and `.resumed.r<rank>` runs the
    jobs ask for."""
    workdir = Path(workdir)
    out = workdir / "out"
    out.mkdir(parents=True)
    with open(workdir / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(DRIVER), str(r), str(world),
         str(workdir / "store"), str(workdir / "jobs.pkl"), str(out)],
        env=env, cwd=root, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        text = (workdir / f"rank{r}.log").read_text()
        assert p.returncode == 0 and f"TORCH_DIST_OK rank={r}" in text, (
            f"rank {r} exited {p.returncode}:\n{text[-4000:]}")
    return {f.name[:-len(".pt")]: torch.load(f, weights_only=False)
            for f in out.glob("*.pt")}


def numpy_problem(problem):
    """A JAX test problem (loss, params, dim, batches) with numpy leaves."""
    loss, params, dim, batches = problem
    return (loss, jax.tree_util.tree_map(np.asarray, params), dim,
            {k: np.asarray(v) for k, v in batches.items()})


def sweep_job(name, jcases, problem, mesh, plan=None, seeded=False,
              **options):
    """A tiny-MLP sweep job for tests/torch_dist_driver.py: the JAX lanes
    `jcases` as the port's, `problem` (`numpy_problem`), the mesh's
    (num_devices, worker_shards, model_shards), the other plan knobs, and
    the JAX engine's replayed draws (None with seeded=True: the port's
    seeded draws)."""
    _, params, dim, batches = problem
    rounds = next(iter(batches.values())).shape[0]
    draws = None if seeded else replay_numpy_draws(
        JFL.SweepSpec.build(jcases), rounds, dim)
    return dict(name=name, kind="sweep", mesh=mesh, plan=dict(plan or {}),
                loss="mlp", cases=[port_case(c) for c in jcases],
                params=params, batches=batches, draws=draws, eval=True,
                **options)


def port_sweep(job, mesh=None, plan=None, resume=False):
    """The port's own run of a sweep job's lanes and draws in this process,
    under the plan knobs `plan` (default: the job's): (engine, result)."""
    import torch_dist_driver as DRV
    engine = TS.SweepEngine(
        DRV.mlp_loss, TS.SweepSpec.build(job["cases"]),
        eval_fn=DRV.pnorm_eval,
        plan=TS.ExecutionPlan(mesh=mesh, **(job["plan"] if plan is None
                                            else plan)),
        device="cpu")
    params = {k: torch.from_numpy(np.array(v))
              for k, v in job["params"].items()}
    return engine, engine.run(params, job["batches"],
                              draws=DRV._draws(job["draws"]), resume=resume)


def as_result(d):
    """A driver's result dict as a port SweepResult."""
    return TS.SweepResult(names=tuple(d["names"]), params=d["params"],
                          loss=d["loss"], grad_norm=d["grad_norm"],
                          metrics=d["metrics"])


def assert_ranks_agree(results, name, world, skip=()):
    """Every rank returned the same full result, bitwise: a sweep result
    (`as_result`), or an LM-step job's dict of tensors, lists and values
    (tests/torch_dist_driver.py::run_lm_job), keys in `skip` aside (a
    rank's own worker index, say)."""
    first = results[f"{name}.r0"]
    for r in range(1, world):
        got = results[f"{name}.r{r}"]
        if "names" in first:
            assert_bitwise(as_result(got), as_result(first))
        else:
            assert sorted(got) == sorted(first)
            for k in first:
                if k not in skip:
                    assert_trees_equal(got[k], first[k], f"rank {r} {k}")


def assert_trees_equal(got, want, where=""):
    """Nested dicts / lists of tensors and plain values, equal bit for
    bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def assert_bitwise(got, want):
    assert got.names == want.names
    np.testing.assert_array_equal(got.loss, want.loss)
    np.testing.assert_array_equal(got.grad_norm, want.grad_norm)
    assert sorted(got.metrics) == sorted(want.metrics)
    for k in want.metrics:
        np.testing.assert_array_equal(got.metrics[k], want.metrics[k])
    for path, g, w in zip(tree_paths(got.params), tree_leaves(got.params),
                          tree_leaves(want.params)):
        assert torch.equal(g, w), path


def assert_port_close(got, want, rtol, atol):
    """Two port results at (rtol, atol): trajectories, metrics, params."""
    assert got.names == want.names
    for a, b in ((got.loss, want.loss), (got.grad_norm, want.grad_norm)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for k in want.metrics:
        np.testing.assert_allclose(got.metrics[k], want.metrics[k],
                                   rtol=rtol, atol=atol)
    for path, g, w in zip(tree_paths(got.params), tree_leaves(got.params),
                          tree_leaves(want.params)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=path)


def replay_trainer_draws(key, rounds, sigmas, shapes):
    """The JAX FLTrainer's per-round draws (`aggregate`'s gains, and noise
    and jamming per leaf), in the port's format ({"h_abs": [U], "z": dict,
    "jam": dict}); shapes: {leaf name: shape}."""
    names = sorted(shapes)

    def leaves(k):
        return {n: _t(jax.random.normal(jax.random.fold_in(k, i), shapes[n],
                                        jnp.float32))
                for i, n in enumerate(names)}

    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        k_ch, k_z, k_jam = jax.random.split(sub, 3)
        out.append({"h_abs": _t(rayleigh_gains(k_ch, jnp.asarray(sigmas))),
                    "z": leaves(k_z), "jam": leaves(k_jam)})
    return lambda t: out[t]


def tiny_torch_loss(params, b):
    """tests/sweep_testlib.py::tiny_problem's loss in PyTorch."""
    pred = torch.relu(b["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - b["y"]) ** 2)


def torch_params(jparams):
    return {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}


class Replay:
    """Sampler stand-in that replays a pre-stacked batch dict round by
    round."""

    def __init__(self, batches):
        self.batches, self.t = batches, 0

    def next_round(self):
        out = {k: v[self.t] for k, v in self.batches.items()}
        self.t += 1
        return out


def assert_sweeps_match(got, want, rtol=RTOL, atol=1e-7):
    """Every lane finite in both engines (NaN == NaN would pass
    assert_allclose without checking anything), then equal at rtol (the
    final params leaf by leaf, nested trees in the JAX package's leaf
    order, with `atol`)."""
    got_leaves = tree_leaves(got.params)
    want_leaves = jax.tree_util.tree_leaves(want.params)
    for run, leaves in ((got, got_leaves), (want, want_leaves)):
        assert np.isfinite(run.loss).all() and np.isfinite(run.grad_norm).all()
        assert all(np.isfinite(np.asarray(v)).all() for v in leaves)
    assert got.names == want.names
    np.testing.assert_allclose(got.loss, want.loss, rtol=rtol)
    np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=rtol)
    assert len(got_leaves) == len(want_leaves)
    for path, g, w in zip(tree_paths(got.params), got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=path)


# ------------------------------------ tiny grids (U = 4, sweep_testlib)

def floa(dim, policy, n_atk, noise=0.05, attack=AttackType.STRONGEST,
         rho=0.0):
    """sweep_testlib.floa in the port, with the fading rho."""
    return FLOAConfig(
        channel=ChannelConfig(num_workers=U, sigma=1.0,
                              noise_std=0.0 if policy == Policy.EF else noise,
                              markov_rho=rho),
        power=PowerConfig(num_workers=U, dim=dim, p_max=1.0, policy=policy),
        attack=AttackConfig(attack=attack if n_atk else AttackType.NONE,
                            byzantine_mask=first_n_mask(U, n_atk)))


def lane(name, dim, policy, n_atk, seed, **kw):
    case_kw = {k: kw.pop(k) for k in ("defense", "participants") if k in kw}
    return TS.ScenarioCase(name, floa(dim, policy, n_atk, **kw), 0.05,
                           seed=seed, **case_kw)


def digital(name, dim, n_atk, seed, defense, participants=None):
    return TS.ScenarioCase(name, floa(dim, Policy.EF, n_atk, 0.0), 0.05,
                           seed=seed, defense=defense,
                           participants=participants)


def axis_grids(dim):
    """The adaptive-axes grids of tests/test_torch_axes.py (U = 4): name ->
    lanes."""
    col, omni = AttackType.COLLUDING, AttackType.OMNISCIENT
    return {
        "markov": [
            lane("legacy-bev", dim, Policy.BEV, 2, 300),
            lane("markov-bev", dim, Policy.BEV, 1, 301, rho=0.9),
            lane("markov-ci", dim, Policy.CI, 0, 302, rho=0.5),
            lane("rho0", dim, Policy.BEV, 1, 303, rho=0.0)],
        "partial_analog": [
            lane("bev-k3", dim, Policy.BEV, 1, 310, participants=3),
            lane("ci-k2", dim, Policy.CI, 2, 311, participants=2),
            lane("ef-k3", dim, Policy.EF, 1, 312, participants=3),
            lane("tci-k3", dim, Policy.TRUNCATED_CI, 1, 313, participants=3),
            lane("bev-full", dim, Policy.BEV, 1, 314)],
        "partial_digital": [
            lane("bev-k3", dim, Policy.BEV, 1, 320, participants=3),
            digital("median-k3", dim, 1, 321, DefenseSpec(name="median"), 3),
            digital("trimmed-k3", dim, 2, 322,
                    DefenseSpec(name="trimmed_mean", trim=1), 3),
            digital("krum-k3", dim, 1, 323,
                    DefenseSpec(name="krum", num_byzantine=0), 3),
            digital("gm-k3", dim, 1, 324,
                    DefenseSpec(name="geometric_median"), 3),
            digital("mean-k2", dim, 1, 325, DefenseSpec(name="mean"), 2),
            digital("median-full", dim, 1, 326, DefenseSpec(name="median"))],
        "colluding": [
            lane("collude-ci", dim, Policy.CI, 2, 330, attack=col),
            lane("collude-bev", dim, Policy.BEV, 1, 331, attack=col),
            lane("legacy-bev", dim, Policy.BEV, 1, 332)],
        "omniscient": [
            lane("omni-bev", dim, Policy.BEV, 1, 340, attack=omni),
            lane("omni-ci", dim, Policy.CI, 2, 341, attack=omni),
            lane("legacy-ci", dim, Policy.CI, 1, 342)],
        "mixed": [
            lane("legacy-bev", dim, Policy.BEV, 2, 350),
            lane("legacy-ci", dim, Policy.CI, 1, 351),
            lane("jam", dim, Policy.BEV, 2, 352, attack=AttackType.GAUSSIAN),
            lane("markov", dim, Policy.BEV, 1, 353, rho=0.9),
            lane("collude", dim, Policy.CI, 2, 354, attack=col),
            lane("omni", dim, Policy.BEV, 1, 355, attack=omni),
            lane("part3", dim, Policy.BEV, 1, 356, participants=3),
            lane("markov+collude+part", dim, Policy.CI, 2, 357, attack=col,
                 rho=0.5, participants=3),
            digital("median-part", dim, 1, 358, DefenseSpec(name="median"),
                    3),
            digital("trimmed-part", dim, 2, 359,
                    DefenseSpec(name="trimmed_mean", trim=1), 3),
            digital("krum", dim, 1, 360,
                    DefenseSpec(name="krum", num_byzantine=1))],
    }

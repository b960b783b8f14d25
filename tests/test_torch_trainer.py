"""The port's looped trainer (`repro_torch.fl.trainer.FLTrainer`) and its
branching pytree path against the JAX package, plus the port's own
contracts.

Parity: the JAX `FLTrainer.run` and the port's on the same weights and
batches (tests/sweep_testlib.py's tiny regression MLP, U = 4, D = 35,
5 rounds), with the port's draws replayed from the reference's key schedule
(`torch_parity.replay_trainer_draws`: split per round, split(sub, 3),
fold_in per leaf in sorted-key order).  FLOA mode: EF, CI, BEV and
truncated CI, with no attack, STRONGEST, GAUSSIAN and
SIGN_FLIP_PROTOCOL_POWER; digital mode: mean, median, trimmed mean, Krum,
multi-Krum and the geometric median.  Tolerance: rtol 1e-5, not bitwise —
the reference's own trainer and engine differ by up to 1.06e-6.

Within the port: `run_scan` equals `run` bitwise; `run_scan(flat=True)`
equals the sweep engine's lane bitwise, and `run` on noiseless channels at
fp rounding; `SweepResult.logs` follows the `run` schedule.  The pytree
defenses and `aggregate` are held against the reference's directly.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.core import aggregation as JAGG
    from repro.core import defenses as JDEF
    from repro.core import standardize as JSTD
    from repro.core.channel import rayleigh_gains
    from repro.fl import FLTrainer as JTrainer
    from sweep_testlib import U, tiny_problem

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP as TPAPER
from repro_torch.core import aggregation as TAGG
from repro_torch.core import defenses as TDEF
from repro_torch.core import standardize as TSTD
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.fl import sweep as TS
from repro_torch.fl.trainer import FLTrainer, RoundLog
from repro_torch.kernels import ops as tops
from torch_parity import (RTOL, Replay, jax_floa, replay_trainer_draws,
                          tiny_torch_loss, torch_params)

ROUNDS = 5
ALPHA = 0.05


def floa(dim, policy, n_atk, attack=AttackType.STRONGEST, noise=0.05,
         sigma=1.0):
    return FLOAConfig(
        channel=ChannelConfig(num_workers=U, sigma=sigma,
                              noise_std=0.0 if policy == Policy.EF else noise),
        power=PowerConfig(num_workers=U, dim=dim, p_max=1.0, policy=policy),
        attack=AttackConfig(attack=attack if n_atk else AttackType.NONE,
                            byzantine_mask=first_n_mask(U, n_atk)))


FLOA_CASES = {
    "ef": (Policy.EF, 0, AttackType.NONE),
    "ef-strongest": (Policy.EF, 2, AttackType.STRONGEST),
    "ci": (Policy.CI, 0, AttackType.NONE),
    "ci-strongest": (Policy.CI, 1, AttackType.STRONGEST),
    "bev-strongest": (Policy.BEV, 1, AttackType.STRONGEST),
    "bev-gaussian": (Policy.BEV, 2, AttackType.GAUSSIAN),
    "bev-signflip": (Policy.BEV, 1, AttackType.SIGN_FLIP_PROTOCOL_POWER),
    "tci-strongest": (Policy.TRUNCATED_CI, 1, AttackType.STRONGEST),
    "tci-signflip": (Policy.TRUNCATED_CI, 2,
                     AttackType.SIGN_FLIP_PROTOCOL_POWER),
}
DIGITAL_CASES = {
    "mean": ("mean", {}),
    "median": ("median", {}),
    "trimmed_mean": ("trimmed_mean", {"trim": 1}),
    "krum": ("krum", {"num_byzantine": 1}),
    "multi_krum": ("krum", {"num_byzantine": 1, "multi": 2}),
    "geometric_median": ("geometric_median", {}),
}


def _shapes(jp):
    return {k: tuple(v.shape) for k, v in jp.items()}


def _assert_runs_match(got, want):
    (tp, tlogs), (jp, jlogs) = got, want
    assert [lg.step for lg in tlogs] == [lg.step for lg in jlogs]
    for name in ("loss", "grad_norm"):
        t = np.array([getattr(lg, name) for lg in tlogs])
        j = np.array([getattr(lg, name) for lg in jlogs])
        assert np.isfinite(t).all() and np.isfinite(j).all()
        np.testing.assert_allclose(t, j, rtol=RTOL)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=1e-7)


def _both(cfg, loss, jp, batches, key, **kw):
    """The JAX trainer and the port's on the same inputs and draws."""
    sigmas = np.asarray(jax_floa(cfg).channel.sigmas())
    want = JTrainer(loss_fn=loss, floa=jax_floa(cfg),
                    alpha=ALPHA, **kw).run(dict(jp), Replay(batches), ROUNDS,
                                           key, eval_every=1)
    tr = FLTrainer(loss_fn=tiny_torch_loss, floa=cfg, alpha=ALPHA,
                   device="cpu", **kw)
    got = tr.run(torch_params(jp), Replay(batches), ROUNDS, eval_every=1,
                 draws=replay_trainer_draws(key, ROUNDS, sigmas,
                                            _shapes(jp)))
    return got, want


@pytest.mark.parametrize("name", sorted(FLOA_CASES))
def test_floa_trainer_matches_jax(name):
    policy, n_atk, attack = FLOA_CASES[name]
    loss, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    cfg = floa(dim, policy, n_atk, attack)
    tops.reset_launches()
    got, want = _both(cfg, loss, jp, batches, jax.random.PRNGKey(11))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    _assert_runs_match(got, want)


@pytest.mark.parametrize("name", sorted(DIGITAL_CASES))
def test_digital_trainer_matches_jax(name):
    defense, kw = DIGITAL_CASES[name]
    loss, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    cfg = floa(dim, Policy.EF, 1)
    got, want = _both(cfg, loss, jp, batches, jax.random.PRNGKey(12),
                      mode="digital", defense=defense, defense_kwargs=kw)
    _assert_runs_match(got, want)


# ------------------------------------------------------ within the port

def _trainer(dim, **kw):
    floa_kw = {k: kw.pop(k) for k in ("policy", "n_atk", "attack", "noise")
               if k in kw}
    cfg = floa(dim, floa_kw.pop("policy", Policy.BEV),
               floa_kw.pop("n_atk", 1), **floa_kw)
    return FLTrainer(loss_fn=tiny_torch_loss, floa=cfg, alpha=ALPHA,
                     device="cpu", **kw)


SCAN_CASES = {
    "bev-gaussian": dict(attack=AttackType.GAUSSIAN, n_atk=2),
    "ci-strongest": dict(policy=Policy.CI),
    "digital-median": dict(mode="digital", defense="median"),
}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_run_scan_matches_run_bitwise(name):
    """The stacked batches and the sampler's, the same seeded draws: the
    same trajectory bit for bit; only the logs' accuracy schedule differs."""
    _, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    tr = _trainer(dim, **SCAN_CASES[name],
                  eval_fn=lambda p: {"accuracy": p["w2"].sum() * 0 + 0.5})
    p_loop, logs_loop = tr.run(torch_params(jp), Replay(batches), ROUNDS, 3,
                               eval_every=1)
    p_scan, logs_scan = tr.run_scan(torch_params(jp), batches, 3,
                                    eval_every=1)
    assert all(torch.equal(p_loop[k], p_scan[k]) for k in p_loop)
    assert [lg.loss for lg in logs_loop] == [lg.loss for lg in logs_scan]
    assert ([lg.grad_norm for lg in logs_loop]
            == [lg.grad_norm for lg in logs_scan])
    assert np.isnan([lg.accuracy for lg in logs_scan[:-1]]).all()
    assert logs_scan[-1].accuracy == 0.5
    # a torch.Generator draws every stream, and replays from its seed
    g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    pa, _ = tr.run(torch_params(jp), Replay(batches), ROUNDS, g())
    pb, _ = tr.run_scan(torch_params(jp), batches, g())
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("mode", ["floa", "digital-median",
                                  "digital-trimmed_mean"])
def test_run_scan_flat_matches_sweep_lane_bitwise(mode):
    """run_scan(flat=True) is one lane of the port's SweepEngine: the same
    trajectory bit for bit, with the lane seeded by the trainer's seed."""
    _, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    kw, defense = {}, DefenseSpec()
    if mode != "floa":
        name = mode.split("-")[1]
        kw = dict(mode="digital", defense=name)
        defense = DefenseSpec(name=name)
    tr = _trainer(dim, **kw)
    p_flat, logs = tr.run_scan(torch_params(jp), batches, 7, eval_every=1,
                               flat=True)
    res = TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build([
        TS.ScenarioCase("scan", tr.floa, ALPHA, seed=7, defense=defense)]),
        eval_every=0, device="cpu").run(torch_params(jp), batches)
    assert np.array_equal([lg.loss for lg in logs], res.loss[0])
    assert np.array_equal([lg.grad_norm for lg in logs], res.grad_norm[0])
    assert all(torch.equal(p_flat[k], res.params[k][0]) for k in p_flat)


@pytest.mark.parametrize("draws", ["seeded", "replayed"])
def test_run_scan_flat_matches_loop_noiseless(draws):
    """On a noiseless channel the flat lane replays the loop to fp rounding,
    from the trainer's seed (the lane's gain stream is the loop's) or from
    the same explicit draws."""
    _, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    tr = _trainer(dim, noise=0.0)
    kw = {}
    if draws == "replayed":
        kw["draws"] = replay_trainer_draws(jax.random.PRNGKey(4), ROUNDS,
                                           np.ones(U, np.float32),
                                           _shapes(jp))
    p_loop, logs_loop = tr.run(torch_params(jp), Replay(batches), ROUNDS, 9,
                               eval_every=1, **kw)
    p_flat, logs_flat = tr.run_scan(torch_params(jp), batches, 9,
                                    eval_every=1, flat=True, **kw)
    np.testing.assert_allclose([lg.loss for lg in logs_loop],
                               [lg.loss for lg in logs_flat], rtol=1e-6,
                               atol=1e-7)
    for k in p_loop:
        np.testing.assert_allclose(p_loop[k], p_flat[k], rtol=1e-5,
                                   atol=1e-6)


def test_flat_scan_keeps_the_loop_for_unlaned_kwargs():
    """A geometric-median eps has no DefenseSpec field: flat=True keeps the
    loop, which forwards it to the pytree defense."""
    _, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    tr = _trainer(dim, mode="digital", defense="geometric_median",
                  defense_kwargs={"eps": 1e-6})
    assert tr._flat_defense() is None
    pa, la = tr.run_scan(torch_params(jp), batches, 1, flat=True)
    pb, lb = tr.run_scan(torch_params(jp), batches, 1)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    with pytest.raises(TypeError, match="seed"):
        _trainer(dim).run_scan(torch_params(jp), batches,
                               torch.Generator(), flat=True)


def test_sweep_result_logs_follow_the_run_schedule():
    _, jp, dim, batches = tiny_problem(rounds=6)
    spec = TS.SweepSpec.build([
        TS.ScenarioCase("a", floa(dim, Policy.BEV, 1), ALPHA, seed=0),
        TS.ScenarioCase("b", floa(dim, Policy.BEV, 0), ALPHA, seed=1)])
    res = TS.SweepEngine(
        tiny_torch_loss, spec, eval_every=2, device="cpu",
        eval_fn=lambda p: {"accuracy": p["w1"].mean() * 0 + 0.5},
    ).run(torch_params(jp), batches)
    logs = res.logs("b", eval_every=2)
    assert all(isinstance(lg, RoundLog) for lg in logs)
    assert [lg.step for lg in logs] == [0, 2, 4, 5]
    assert logs[-1].accuracy == 0.5
    assert [lg.loss for lg in logs] == [float(res.loss[1, t])
                                        for t in (0, 2, 4, 5)]
    assert [lg.step for lg in res.logs(0, eval_every=0)] == []
    assert np.isnan(res.logs(0, eval_every=1)[1].accuracy)


# ----------------------------------------------------- the pytree path

def _grads(seed, u=7):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(u, 6, 5)).astype(np.float32),
            "b1": rng.normal(size=(u, 5)).astype(np.float32),
            "w2": rng.normal(size=(u, 5, 1)).astype(np.float32)}


PYTREE_DEFENSES = {
    "mean": {}, "median": {}, "trimmed_mean": {"trim": 2},
    "krum": {"num_byzantine": 2}, "multi_krum": {"num_byzantine": 1,
                                                 "multi": 3},
    "geometric_median": {"iters": 5, "eps": 1e-6},
}


@pytest.mark.parametrize("name", sorted(PYTREE_DEFENSES))
def test_pytree_defenses_match_jax(name):
    kw = PYTREE_DEFENSES[name]
    defense = "krum" if name == "multi_krum" else name
    g = _grads(sorted(PYTREE_DEFENSES).index(name))
    want = JDEF.digital_aggregate({k: jnp.asarray(v) for k, v in g.items()},
                                  defense, **kw)
    got = TDEF.digital_aggregate({k: torch.from_numpy(v)
                                  for k, v in g.items()}, defense, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(FLOA_CASES))
def test_aggregate_matches_jax(name):
    """`aggregate` on one round's grads, from the draws of the reference's
    key, and its aux; `per_worker_scalar_stats` per leaf."""
    policy, n_atk, attack = FLOA_CASES[name]
    cfg = floa(35, policy, n_atk, attack, sigma=(1.0, 0.5, 2.0, 1.5))
    g = _grads(5, U)
    key = jax.random.PRNGKey(21)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want, waux = JAGG.aggregate(jg, key, jax_floa(cfg))
    # the draws of the key aggregate is given: split(key, 3), fold_in per
    # leaf in sorted order
    k_ch, k_z, k_jam = jax.random.split(key, 3)
    names = sorted(g)
    d0 = {"h_abs": torch.from_numpy(np.array(rayleigh_gains(
        k_ch, jnp.asarray(cfg.channel.sigmas().numpy()))))}
    for slot, k in (("z", k_z), ("jam", k_jam)):
        d0[slot] = {n: torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(k, i), g[n].shape[1:], jnp.float32)))
            for i, n in enumerate(names)}
    got, aux = TAGG.aggregate({k: torch.from_numpy(v) for k, v in g.items()},
                              cfg, draws=d0)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    for k in ("coeffs", "gbar", "eps2", "bias_w", "h_abs"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   rtol=1e-6, atol=1e-7)
    gb, e2 = TSTD.per_worker_scalar_stats({k: torch.from_numpy(v)
                                           for k, v in g.items()})
    jgb, je2 = JSTD.per_worker_scalar_stats(jg)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-6)
    np.testing.assert_allclose(e2.numpy(), np.asarray(je2), rtol=1e-6)


def test_aggregate_default_draws_are_seeded():
    """Without draws, `aggregate` draws from its generator: the same seed
    gives the same aggregate, another seed another one."""
    cfg = floa(35, Policy.BEV, 1, AttackType.GAUSSIAN)
    g = {k: torch.from_numpy(v) for k, v in _grads(6, U).items()}
    run = lambda s: TAGG.aggregate(  # noqa: E731
        g, cfg, generator=torch.Generator().manual_seed(s))[0]
    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    mean = TAGG.mean_aggregate(g)
    assert all(torch.equal(mean[k], g[k].mean(dim=0)) for k in g)


def test_run_experiment_on_cpu_learns_and_is_deterministic():
    """figures.run_experiment (the looped figure path) at smoke size: the
    losses fall, two runs agree, no kernel launches on the CPU."""
    mc = dataclasses.replace(TPAPER.smoke(), d_hidden=16)
    exp = TF.Experiment("BEV", Policy.BEV, n_attackers=1, rounds=8)
    tops.reset_launches()
    a = TF.run_experiment(exp, eval_every=4, mc=mc, device="cpu")
    b = TF.run_experiment(exp, eval_every=4, mc=mc, device="cpu")
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert [lg.step for lg in a] == [0, 4, 7]
    assert [lg.loss for lg in a] == [lg.loss for lg in b]
    assert a[-1].loss < a[0].loss
    assert all(np.isfinite(lg.accuracy) for lg in a)


def test_trainer_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = dataclasses.replace(TPAPER.smoke(), d_hidden=16)
    with pytest.raises(RuntimeError, match="cuda"):
        FLTrainer(loss_fn=tiny_torch_loss, floa=floa(35, Policy.BEV, 1),
                  alpha=ALPHA)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.run_experiment(TF.Experiment("BEV", Policy.BEV, rounds=1), mc=mc)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.run_showdown(1, mc=mc)
    with pytest.raises(ValueError, match="mode"):
        FLTrainer(loss_fn=tiny_torch_loss, floa=floa(35, Policy.BEV, 1),
                  alpha=ALPHA, mode="analog", device="cpu")

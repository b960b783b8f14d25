"""The port's adaptive-adversary axes (Gauss-Markov fading, K-of-U
participation, colluding / omniscient cohorts) against the JAX package.

Parity: sweeps that use the axes run through the JAX `SweepEngine` and the
port's from the same weights, batches and draws (`torch_parity.
replay_sweep_draws` replays the JAX engine's split slots and fold_in side
channels), on tests/sweep_testlib.py's tiny regression MLP (U = 4, D = 35),
5 rounds, under the grouped dispatch where a grid has digital lanes.
Tolerance: rtol 1e-5, after asserting every lane finite.

Then the contracts of tests/test_scenario_axes.py, restated within the port
on its own seeded draws: rho = 0 lanes equal the i.i.d. lanes bitwise, new
axes leave legacy lanes bitwise unchanged, one omniscient attacker equals
STRONGEST at rtol, and K = U equals participants=None at rtol only (the
reference's own K = U contract is not bitwise on this tree).  The port's
Philox streams are checked statistically, like tests/test_stat_contracts.py.
Last, the masked flat defenses against the JAX ones, the Dirichlet split
against the reference's bytes, and the showdown grid against the example's.
"""
import dataclasses
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core.defenses as JDEF
    import repro.fl as JFL
    from repro.core import scenario as JSC
    from repro.data.pipeline import FederatedSampler as JSampler
    from repro.data.pipeline import dirichlet_worker_split as jdirichlet
    from repro.data.synthetic_digits import make_dataset
    from sweep_testlib import U, tiny_problem
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "examples"))
    import byzantine_showdown as JSHOW

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP as TPAPER
from repro_torch.core import channel as CH
from repro_torch.core import defenses as TDEF
from repro_torch.core import scenario as TSC
from repro_torch.core.attacks import AttackType
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import Policy
from repro_torch.core.scenario import DefenseSpec
from repro_torch.data.pipeline import FederatedSampler as TSampler
from repro_torch.data.pipeline import dirichlet_worker_split as tdirichlet
from repro_torch.fl import sweep as TS
from repro_torch.kernels import ops as tops
from torch_parity import (assert_sweeps_match, digital, floa, jax_case,
                          jax_floa, lane, replay_sweep_draws, tiny_torch_loss,
                          torch_params)
from torch_parity import axis_grids as _grids

ROUNDS = 5


GRIDS = sorted(_grids(35))


@pytest.mark.parametrize("grid", GRIDS)
def test_adaptive_axes_match_jax_engine(grid):
    loss, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    tcases = _grids(dim)[grid]
    tspec = TS.SweepSpec.build(tcases)
    jspec = JFL.SweepSpec.build([jax_case(c) for c in tcases])
    for gate in ("lane_codes", "any_digital", "analog_noise",
                 "analog_jamming", "any_markov", "any_partial",
                 "any_directional"):
        assert getattr(tspec, gate) == getattr(jspec, gate), gate
    want = JFL.SweepEngine(loss, jspec).run(jp, batches)
    tops.reset_launches()
    got = TS.SweepEngine(tiny_torch_loss, tspec, device="cpu").run(
        torch_params(jp), batches, draws=replay_sweep_draws(jspec, ROUNDS,
                                                            dim))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert_sweeps_match(got, want)


# ------------------------------------------ restated contracts (the port)

def _run(cases, batches=None):
    _, jp, dim, b = tiny_problem(rounds=ROUNDS)
    return TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(cases),
                          device="cpu").run(torch_params(jp),
                                            b if batches is None else batches)


def _legacy(dim, num):
    return [lane(f"{p.value}@N{n}#{i}", dim, p, n, 100 + i)
            for i, (p, n) in enumerate([(Policy.CI, 0), (Policy.BEV, 1),
                                        (Policy.CI, 2)][:num])]


def _assert_lanes_bitwise(a, b, rows=slice(None)):
    assert np.array_equal(a.loss[rows], b.loss)
    assert np.array_equal(a.grad_norm[rows], b.grad_norm)
    for k in b.params:
        assert torch.equal(a.params[k][rows], b.params[k])


def test_markov_rho0_lanes_bitwise_equal_iid():
    """Legacy lanes beside a rho > 0 lane are bitwise unchanged: the fading
    carry draws from its own streams and keeps rho = 0 lanes on the i.i.d.
    gains."""
    dim = 35
    legacy = _legacy(dim, 2)
    ref = _run(legacy)
    got = _run(legacy + [lane("markov", dim, Policy.BEV, 1, 999, rho=0.9)])
    _assert_lanes_bitwise(got, ref, slice(0, 2))
    assert np.isfinite(got.loss[2]).all()


def test_markov_rho0_lane_bitwise_equal_explicit():
    dim = 35
    base = _legacy(dim, 3)
    zeroed = [dataclasses.replace(c, floa=dataclasses.replace(
        c.floa, channel=dataclasses.replace(c.floa.channel, markov_rho=0.0)))
        for c in base]
    _assert_lanes_bitwise(_run(zeroed), _run(base))


def test_markov_lane_differs_from_iid():
    dim = 35
    a = _run([lane("l", dim, Policy.BEV, 1, 42)])
    b = _run([lane("l", dim, Policy.BEV, 1, 42, rho=0.9)])
    assert not np.allclose(a.loss, b.loss)
    assert np.isfinite(b.loss).all()


@pytest.mark.parametrize("attack", [AttackType.COLLUDING,
                                    AttackType.OMNISCIENT])
def test_directional_attacks_leave_legacy_lanes_bitwise(attack):
    """A cohort lane switches the analog route to combine + update and
    draws its direction from a stream of its own; the legacy lanes'
    trajectories do not move."""
    dim = 35
    legacy = _legacy(dim, 2)
    ref = _run(legacy)
    got = _run(legacy + [lane("co", dim, Policy.CI, 2, 888, attack=attack)])
    _assert_lanes_bitwise(got, ref, slice(0, 2))


def test_cohort_of_one_omniscient_matches_strongest():
    """On identical worker shards and a noiseless channel the honest mean
    is the common gradient, so one OMNISCIENT attacker transmits the eq. 18
    STRONGEST vector; only the order of the additions differs."""
    _, _, dim, batches = tiny_problem(rounds=ROUNDS)
    tiled = {k: np.tile(v[:, :v.shape[1] // U], (1, U, 1))
             for k, v in batches.items()}
    res = _run([lane("s", dim, Policy.CI, 1, 70, noise=0.0),
                lane("o", dim, Policy.CI, 1, 70, noise=0.0,
                     attack=AttackType.OMNISCIENT)], tiled)
    np.testing.assert_allclose(res.loss[0], res.loss[1], rtol=2e-5)
    np.testing.assert_allclose(res.grad_norm[0], res.grad_norm[1], rtol=2e-5)


def test_participants_full_u_matches_none():
    """participants=U runs the masked stats, coefficients and defenses;
    at a full mask they equal the unmasked lanes at rtol (not claimed
    bitwise, as the reference's own contract fails bitwise on this tree)."""
    dim = 35
    base = _legacy(dim, 3) + [
        digital("med", dim, 1, 50, DefenseSpec(name="median")),
        digital("krum", dim, 1, 51, DefenseSpec(name="krum",
                                                num_byzantine=1)),
        digital("gm", dim, 1, 52, DefenseSpec(name="geometric_median"))]
    full = [dataclasses.replace(c, participants=U) for c in base]
    a, b = _run(base), _run(full)
    np.testing.assert_allclose(a.loss, b.loss, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=1e-6,
                               atol=1e-7)
    for k in a.params:
        np.testing.assert_allclose(a.params[k], b.params[k], rtol=1e-6,
                                   atol=1e-7)


def test_partial_lanes_run_and_differ():
    dim = 35
    a = _run([lane("f", dim, Policy.BEV, 1, 60)])
    b = _run([lane("f", dim, Policy.BEV, 1, 60, participants=2)])
    assert not np.allclose(a.loss, b.loss)
    assert np.isfinite(b.loss).all()


def test_participants_validation():
    dim = 35
    with pytest.raises(ValueError, match="participants"):
        TS.SweepSpec.build([lane("b", dim, Policy.BEV, 1, 1,
                                 participants=U + 1)])
    with pytest.raises(ValueError, match="participants"):
        TS.SweepSpec.build([lane("b", dim, Policy.BEV, 1, 1,
                                 participants=0)])
    with pytest.raises(ValueError, match="trim"):
        TS.SweepSpec.build([digital("t", dim, 1, 2, DefenseSpec(
            name="trimmed_mean", trim=1), 2)])
    with pytest.raises(ValueError, match="participants"):
        TS.SweepSpec.build([digital("k", dim, 1, 3, DefenseSpec(
            name="krum", num_byzantine=1), 3)])
    with pytest.raises(ValueError, match="markov_rho"):
        ChannelConfig(num_workers=U, markov_rho=1.0)


def test_bad_axis_draws_are_rejected():
    """A spec with the axes needs their draws: a provider without them is
    refused with the missing key's name."""
    _, jp, dim, batches = tiny_problem(rounds=1)
    spec = TS.SweepSpec.build([lane("m", dim, Policy.BEV, 1, 1, rho=0.5,
                                    participants=3)])
    engine = TS.SweepEngine(tiny_torch_loss, spec, device="cpu")
    good = engine.seeded_draws(dim)(0)
    for key in ("part", "h_init", "markov"):
        with pytest.raises(ValueError, match=key):
            engine.run(torch_params(jp), batches, draws=lambda t, k=key: {
                **good, k: None})


# ----------------------------------------- the port's Philox, statistically

def _engine(cases):
    return TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(cases),
                          device="cpu")


def test_participation_draws_exactly_k_and_uniform():
    """Every round's mask holds exactly K of U workers, and each worker
    participates K/U of the time (8 lanes x 2000 rounds)."""
    u, k, rounds = U, 3, 2000
    cases = [lane(f"p{i}", 35, Policy.BEV, 1, 500 + i, participants=k)
             for i in range(8)]
    draws = _engine(cases).seeded_draws(35)
    masks = torch.stack([draws(t)["part"] for t in range(rounds)])
    assert masks.dtype == torch.bool
    assert (masks.sum(dim=-1) == k).all()
    share = masks.float().mean(dim=(0, 1)).numpy()
    np.testing.assert_allclose(share, np.full(u, k / u), atol=0.02)
    full = _engine([lane("f", 35, Policy.BEV, 1, 1, participants=u)])
    assert full.seeded_draws(35)(0)["part"].all()


def test_markov_fading_marginals_are_rayleigh():
    """The fading state's |h| keeps the Rayleigh(sigma) marginal at every
    round (mean sigma sqrt(pi/2), E|h|^2 = 2 sigma^2, exponential tail of
    |h|^2), and successive rounds correlate at rho."""
    rho, rounds, lanes_n = 0.9, 400, 16
    sigma = 1.0
    cases = [lane(f"m{i}", 35, Policy.BEV, 1, 700 + i, rho=rho)
             for i in range(lanes_n)]
    engine = _engine(cases)
    draws = engine.seeded_draws(35)
    h, samples, states = None, [], []
    for t in range(rounds):
        draw = draws(t)
        if t == 0:
            h = engine._sp_exec.sigma[..., None] * draw["h_init"]
        h, draw = engine._fade(h, draw)
        samples.append(draw["h_abs"])
        states.append(h[..., 0])
    a = torch.stack(samples).numpy().ravel()
    np.testing.assert_allclose(a.mean(), sigma * np.sqrt(np.pi / 2),
                               rtol=0.02)
    np.testing.assert_allclose((a ** 2).mean(), 2 * sigma**2, rtol=0.03)
    for t in (0.5, 1.0, 2.0):
        np.testing.assert_allclose(np.mean(a ** 2 > t * 2 * sigma**2),
                                   np.exp(-t), rtol=0.08)
    re = torch.stack(states).numpy()            # [R, S, U]
    lag1 = np.mean(re[1:] * re[:-1]) / np.mean(re ** 2)
    np.testing.assert_allclose(lag1, rho, atol=0.03)
    # the dataclass-path helpers draw the same law
    sig = torch.full((50_000,), 1.3)
    h0 = CH.complex_gain_init(torch.Generator().manual_seed(0), sig)
    h1 = CH.gauss_markov_step(h0, CH.complex_gain_init(
        torch.Generator().manual_seed(1), sig), 0.5)
    for h in (h0, h1):
        np.testing.assert_allclose(CH.complex_gain_abs(h).mean().item(),
                                   1.3 * np.sqrt(np.pi / 2), rtol=0.02)


def test_colluding_directions_are_unit_rms():
    """A COLLUDING lane's shared row has RMS 1 (its received weight carries
    the amplitude), drawn fresh each round."""
    dim = 5000
    cases = [lane(f"c{i}", dim, Policy.BEV, 2, 800 + i,
                  attack=AttackType.COLLUDING) for i in range(4)]
    engine = _engine(cases)
    draws = engine.seeded_draws(dim)
    rows = []
    for t in range(3):
        draw = draws(t)
        grads = torch.zeros(4, U, dim)
        rows.append(engine._direction(grads, draw, engine._sp, None))
    rows = torch.stack(rows)
    rms = torch.sqrt((rows ** 2).mean(dim=-1))
    np.testing.assert_allclose(rms.numpy(), 1.0, rtol=1e-5)
    assert not torch.allclose(rows[0], rows[1])
    # the raw draw is standard normal
    z = torch.stack([draws(t)["dir"] for t in range(3, 13)]).numpy()
    np.testing.assert_allclose([z.mean(), z.std()], [0.0, 1.0], atol=0.01)


# ------------------------------------------------------- unit parity

def _masked_inputs(u, d, seed):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(u, d)).astype(np.float32)
    mask = np.zeros(u, bool)
    mask[rng.permutation(u)[:max(3, (2 * u) // 3)]] = True
    return flat, mask


MASKED = {
    "mean": (lambda f, m: JDEF.flat_masked_mean(f, m),
             lambda f, m: TDEF.flat_masked_mean(f, m)),
    "median": (lambda f, m: JDEF.flat_masked_median(f, m),
               lambda f, m: TDEF.flat_masked_median(f, m)),
    "trimmed_mean": (lambda f, m: JDEF.flat_masked_trimmed_mean(f, 1, m),
                     lambda f, m: TDEF.flat_masked_trimmed_mean(f, 1, m)),
    "krum": (lambda f, m: JDEF.flat_masked_krum(f, 1, 1, m),
             lambda f, m: TDEF.flat_masked_krum(f, 1, 1, m)),
    "multi_krum": (lambda f, m: JDEF.flat_masked_krum(f, 1, 2, m),
                   lambda f, m: TDEF.flat_masked_krum(f, 1, 2, m)),
    "geometric_median": (
        lambda f, m: JDEF.flat_masked_geometric_median(f, m),
        lambda f, m: TDEF.flat_masked_geometric_median(f, m)),
}


@pytest.mark.parametrize("u", [7, 70])
@pytest.mark.parametrize("name", sorted(MASKED))
def test_masked_flat_defenses_match_jax(name, u):
    """Each masked twin against the reference's on one [U, D] slab; at
    U = 70 Krum takes the blocked distances."""
    flat, mask = _masked_inputs(u, 33, u)
    jfn, tfn = MASKED[name]
    want = np.asarray(jfn(jnp.asarray(flat), jnp.asarray(mask)))
    got = tfn(torch.from_numpy(flat), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # batched over lanes: one [S, U, D] call equals the per-lane calls
    flat2, mask2 = _masked_inputs(u, 33, u + 1)
    both = tfn(torch.from_numpy(np.stack([flat, flat2])),
               torch.from_numpy(np.stack([mask, mask2])))
    assert torch.equal(both[0], torch.from_numpy(got))


def test_scenario_coefficients_with_participation_match_jax():
    """The branchless coefficients under a participation mask, every policy
    and attack code, against the reference's."""
    rng = np.random.default_rng(3)
    dim = 35
    cases, jsp = [], []
    for pol in Policy:
        for atk in AttackType:
            cfg = floa(dim, pol, 2, attack=atk)
            cases.append(TSC.from_floa(cfg, 0.05, participants=3))
            jsp.append(JSC.from_floa(jax_floa(cfg), 0.05, participants=3))
    sp, jsp = TSC.stack(cases), JSC.stack(tuple(jsp))
    s = len(cases)
    h = rng.rayleigh(size=(s, U)).astype(np.float32)
    gbar = rng.normal(size=s).astype(np.float32) * 0.1
    eps2 = rng.uniform(0.5, 2.0, size=s).astype(np.float32)
    part = np.zeros((s, U), bool)
    for i in range(s):
        part[i, rng.permutation(U)[:3]] = True
    want = jax.vmap(JSC.scenario_coefficients)(
        jnp.asarray(h), jsp, jnp.asarray(gbar), jnp.asarray(eps2),
        jnp.asarray(part))
    got = TSC.scenario_coefficients(
        torch.from_numpy(h), sp, torch.from_numpy(gbar),
        torch.from_numpy(eps2), torch.from_numpy(part))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("alpha", [0.3, 1.0, np.inf])
def test_dirichlet_split_is_the_references(alpha):
    """numpy only on both sides, so the same seed gives the same bytes; the
    sampler over it replays the same batches."""
    x, y = make_dataset(600, seed=0)
    want = jdirichlet(x, y, 10, alpha, seed=1)
    got = tdirichlet(x, y, 10, alpha, seed=1)
    assert sorted(got) == sorted(want)
    for i in want:
        assert np.array_equal(got[i][0], want[i][0])
        assert np.array_equal(got[i][1], want[i][1])
    a = JSampler.dirichlet(x, y, 10, alpha, 4, seed=1).stack_rounds(3)
    b = TSampler.dirichlet(x, y, 10, alpha, 4, seed=1).stack_rounds(3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="alpha"):
        tdirichlet(x, y, 10, 0.0)


def test_showdown_cases_mirror_the_example():
    """figures.showdown_cases is examples/byzantine_showdown.py's grid: the
    same 68 lanes, names, order and configurations."""
    mc = TPAPER.full()
    tcases = TF.showdown_cases(mc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.configs import PAPER_MLP as JPAPER
        want = JSHOW.build_cases(JPAPER.full())
    assert len(tcases) == len(want) == 68
    assert [jax_case(c) for c in tcases] == want
    spec = TS.SweepSpec.build(tcases)
    assert spec.any_markov and spec.any_partial and spec.any_directional
    groups = TSC.build_lane_groups(spec.lane_codes)
    assert [(c, e - s) for c, s, e in groups.local_slices] == [
        (0, 36), (1, 4), (2, 8), (3, 8), (4, 4), (5, 4), (6, 4)]


def test_showdown_runs_on_cpu():
    """figures.run_showdown end to end at smoke size: every lane finite,
    deterministic, and the Dirichlet split is a different run."""
    mc = dataclasses.replace(TPAPER.smoke(), d_hidden=8)
    tops.reset_launches()
    a = TF.run_showdown(2, mc=mc, device="cpu")
    b = TF.run_showdown(2, mc=mc, device="cpu")
    c = TF.run_showdown(2, dirichlet=0.3, mc=mc, device="cpu")
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert a.loss.shape == (68, 2) and np.isfinite(a.loss).all()
    assert np.isfinite(c.loss).all() and not np.allclose(a.loss, c.loss)
    assert np.array_equal(a.loss, b.loss)
    acc = a.metrics["accuracy"]
    assert np.isfinite(acc).all()     # eval_every = R: rounds 0 and R - 1

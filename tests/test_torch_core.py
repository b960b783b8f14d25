"""The port's core layer (`repro_torch.core`) against the JAX package.

Channel, power control, attacks, scenario coefficients, standardization and
the flat aggregation helpers, from the same inputs (numpy seeds) on both
sides; `theory.py` to the float.  The port's own random draws cannot match
threefry, so they are checked statistically.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.core import aggregation as JAG
    from repro.core import attacks as JA
    from repro.core import channel as JCH
    from repro.core import power_control as JPC
    from repro.core import scenario as JSC
    from repro.core import standardize as JS
    from repro.core import theory as JT

from repro_torch.core import aggregation as TAG
from repro_torch.core import attacks as TA
from repro_torch.core import channel as TCH
from repro_torch.core import power_control as TPC
from repro_torch.core import scenario as TSC
from repro_torch.core import standardize as TS
from repro_torch.core import theory as TT
from repro_torch.fl import sweep as TSW

U, D_ACC = 10, 50890
POLICIES = ["ci", "bev", "ef", "truncated_ci"]
ATTACKS = ["none", "strongest", "sign_flip_protocol_power", "gaussian"]
SIGMA = tuple(3.0 if i < 2 else 1.0 + 0.1 * i for i in range(U))
P_MAX = tuple(1.0 + 0.05 * i for i in range(U))


def _configs(policy: str, attack: str, n_byz: int = 2):
    """The same lane as (JAX FLOAConfig, port FLOAConfig)."""
    mask = tuple(i < n_byz for i in range(U))
    out = []
    for M in ((JCH, JPC, JA, JAG), (TCH, TPC, TA, TAG)):
        ch, pc, at, ag = M
        out.append(ag.FLOAConfig(
            channel=ch.ChannelConfig(U, SIGMA, noise_std=0.02),
            power=pc.PowerConfig(U, D_ACC, P_MAX, pc.Policy(policy)),
            attack=at.AttackConfig(at.AttackType(attack), mask)))
    return out


def _round_inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = (np.asarray(SIGMA) * np.sqrt(2.0 * rng.exponential(size=U))).astype(
        np.float32)
    return h, np.float32(rng.normal(0, 0.01)), np.float32(
        rng.uniform(1e-4, 1e-2))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("attack", ATTACKS)
def test_scenario_coefficients_match_jax(policy, attack):
    """Every slice policy x attack code, one lane, same |h| / stats."""
    jcfg, tcfg = _configs(policy, attack)
    h, gbar, eps2 = _round_inputs()
    want = JSC.scenario_coefficients(jnp.asarray(h), JSC.from_floa(jcfg, 0.3),
                                     jnp.float32(gbar), jnp.float32(eps2))
    got = TSC.scenario_coefficients(torch.from_numpy(h),
                                    TSC.from_floa(tcfg, 0.3),
                                    torch.tensor(gbar), torch.tensor(eps2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)


def test_stacked_coefficients_equal_per_lane():
    """The [S, ...] form (what the sweep runs) is the per-lane form, row by
    row, and so the JAX package's vmapped coefficients."""
    cases = [(p, a) for p in POLICIES for a in ATTACKS]
    tsp = TSC.stack([TSC.from_floa(_configs(p, a)[1], 0.1 * i)
                     for i, (p, a) in enumerate(cases)])
    jsp = JSC.stack(tuple(JSC.from_floa(_configs(p, a)[0], 0.1 * i)
                          for i, (p, a) in enumerate(cases)))
    rows = [_round_inputs(i) for i in range(len(cases))]
    h = np.stack([r[0] for r in rows])
    gbar = np.array([r[1] for r in rows], np.float32)
    eps2 = np.array([r[2] for r in rows], np.float32)
    got = TSC.scenario_coefficients(torch.from_numpy(h), tsp,
                                    torch.from_numpy(gbar),
                                    torch.from_numpy(eps2))
    want = jax.vmap(JSC.scenario_coefficients)(jnp.asarray(h), jsp,
                                               jnp.asarray(gbar),
                                               jnp.asarray(eps2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)
    for i, (p, a) in enumerate(cases):
        one = TSC.scenario_coefficients(
            torch.from_numpy(h[i]), TSC.from_floa(_configs(p, a)[1], 0.1 * i),
            torch.tensor(gbar[i]), torch.tensor(eps2[i]))
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize("policy", POLICIES)
def test_transmit_amplitudes_match_jax(policy):
    jcfg, tcfg = _configs(policy, "none")
    h, _, _ = _round_inputs(3)
    want = JPC.transmit_amplitudes(jnp.asarray(h), jcfg.power, jcfg.channel)
    got = TPC.transmit_amplitudes(torch.from_numpy(h), tcfg.power,
                                  tcfg.channel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_channel_and_attack_helpers_match_jax():
    jcfg, tcfg = _configs("ci", "strongest")
    h, gbar, eps2 = _round_inputs(5)
    sig = np.asarray(SIGMA, np.float32)
    pm = np.asarray(P_MAX, np.float32)
    mask = np.arange(U) < 2
    np.testing.assert_allclose(
        TCH.min_sq_gain_from_sigmas(torch.from_numpy(sig)).numpy(),
        np.asarray(JCH.min_sq_gain_from_sigmas(jnp.asarray(sig))), rtol=1e-6)
    np.testing.assert_allclose(TPC.ci_b0(tcfg.power, tcfg.channel).numpy(),
                               np.asarray(JPC.ci_b0(jcfg.power, jcfg.channel)),
                               rtol=1e-6)
    assert TCH.noise_std_for_snr(1.0, D_ACC, 10.0) == \
        JCH.noise_std_for_snr(1.0, D_ACC, 10.0)
    args_t = (torch.from_numpy(h), torch.from_numpy(pm), float(D_ACC),
              torch.from_numpy(mask))
    args_j = (jnp.asarray(h), jnp.asarray(pm), float(D_ACC),
              jnp.asarray(mask))
    pairs = [
        (TA.jam_std_arrays(*args_t, torch.tensor(eps2)),
         JA.jam_std_arrays(*args_j, eps2)),
        (TA.colluding_dir_weight(*args_t, torch.tensor(eps2)),
         JA.colluding_dir_weight(*args_j, eps2)),
        (TA.omniscient_dir_weight(*args_t, torch.tensor(gbar),
                                  torch.tensor(eps2)),
         JA.omniscient_dir_weight(*args_j, gbar, eps2)),
        (TA.strongest_attack_amplitude(torch.from_numpy(pm), float(D_ACC),
                                       torch.tensor(gbar), torch.tensor(eps2)),
         JA.strongest_attack_amplitude(jnp.asarray(pm), float(D_ACC), gbar,
                                       eps2)),
    ]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert TA.first_n_mask(5, 2) == JA.first_n_mask(5, 2)
    with pytest.raises(ValueError):
        TCH.ChannelConfig(4, markov_rho=1.0)


def _theory_params(mod, n, sigma, p_max=1.0):
    return mod.TheoryParams(num_workers=10, num_attackers=n, dim=D_ACC,
                            sigma=sigma, p_max=p_max)


@pytest.mark.parametrize("n,sigma", [(0, 1.0), (1, SIGMA), (3, 2.0),
                                     (2, SIGMA)])
def test_theory_floats_equal(n, sigma):
    jt, tt = _theory_params(JT, n, sigma), _theory_params(TT, n, sigma)
    for fn in ("ci_b0", "omega_ci", "Omega_ci", "omega_bev", "Omega_bev"):
        assert getattr(TT, fn)(tt) == getattr(JT, fn)(jt), fn
    for pol in ("ci", "bev", "ef"):
        assert TT.omega_Omega(tt, pol) == JT.omega_Omega(jt, pol)
        assert TT.alpha_from_alpha_hat(tt, pol, 0.1) == \
            JT.alpha_from_alpha_hat(jt, pol, 0.1)
        assert TT.lr_upper_bound(tt, pol, 2.0) == \
            JT.lr_upper_bound(jt, pol, 2.0)
        assert TT.converges(tt, pol, 1e-3, 2.0) == \
            JT.converges(jt, pol, 1e-3, 2.0)
        assert TT.rate_bound(tt, pol, 1.0, 2.0, 0.5, 0.1, 0.01, 100, 0.3) == \
            JT.rate_bound(jt, pol, 1.0, 2.0, 0.5, 0.1, 0.01, 100, 0.3)
    for u in (4, 10, 31):
        for fn in ("max_attackers_ci_iso", "max_attackers_ci_iso_exact",
                   "max_attackers_bev_iso"):
            assert getattr(TT, fn)(u) == getattr(JT, fn)(u)


def test_flat_stats_match_jax():
    x = (np.random.default_rng(1).standard_normal((3, 5, 1234)) * 0.3 +
         0.01).astype(np.float32)
    gbar, eps2 = TS.flat_scalar_stats(torch.from_numpy(x))
    jg, je = jax.vmap(JS.flat_scalar_stats)(jnp.asarray(x))
    np.testing.assert_allclose(gbar.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(eps2.numpy(), np.asarray(je), rtol=1e-5)
    gg, ge = TS.global_stats(gbar, eps2)
    wg, we = jax.vmap(JS.global_stats)(jg, je)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-5)
    # the variance floor of the epilogue
    _, flat_e = TS.stats_from_partials(torch.tensor([3.0]),
                                       torch.tensor([9.0]), 1)
    assert math.isclose(float(flat_e), 1e-20, rel_tol=1e-6)


def test_flatten_worker_grads_uses_jax_flat_order():
    """Dict leaves concatenate in sorted key order, as tree_flatten does."""
    rng = np.random.default_rng(2)
    tree = {"w2": rng.standard_normal((2, 4, 3)), "b1": rng.standard_normal(
        (2, 4)), "w1": rng.standard_normal((2, 5, 4)),
            "b2": rng.standard_normal((2, 3))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    flat_t, unflat_t = TAG.flatten_worker_grads(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    flat_j, _ = JAG.flatten_worker_grads({k: jnp.asarray(v)
                                          for k, v in tree.items()})
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unflat_t(flat_t[..., :])
    assert all(torch.equal(back[k], torch.from_numpy(tree[k]))
               for k in tree)
    unflatten_row, sizes = TSW.make_row_unflatten(
        {k: torch.from_numpy(v[0]) for k, v in tree.items()})
    assert sizes == (4, 3, 20, 12)
    row = flat_t[1].clone().requires_grad_(True)
    parts = unflatten_row(row)
    assert all(p._base is row for p in parts.values())   # views, not copies
    sum(p.sum() for p in parts.values()).backward()
    assert torch.equal(row.grad, torch.ones_like(row))


def test_batched_step_matches_jax_route():
    rng = np.random.default_rng(4)
    s, u, d = 3, 6, 333
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    w, c, g, z = f(s, d), f(s, u), f(s, u, d), f(s, d)
    bias, eps, alpha = f(s), np.abs(f(s)), np.abs(f(s)) * 0.1
    wn, gg = TAG.batched_floa_step(*map(torch.from_numpy,
                                        (w, alpha, c, g, z, bias, eps)))
    jw, jg = JAG.batched_floa_step(*map(jnp.asarray,
                                        (w, alpha, c, g, z, bias, eps)))
    np.testing.assert_allclose(wn.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    comb = TAG.batched_floa_combine(*map(torch.from_numpy,
                                         (c, g, z, bias, eps)))
    assert torch.equal(comb, gg)


# ------------------------------------------- the port's own random draws


def test_rayleigh_gains_statistics():
    """|h| ~ Rayleigh(sigma): E|h| = sigma sqrt(pi/2), E|h|^2 = 2 sigma^2
    (core/channel.py), within 5 standard errors at n = 200000."""
    n, sigma = 200_000, 1.7
    gen = torch.Generator().manual_seed(0)
    h = TCH.rayleigh_gains(gen, torch.full((n,), sigma)).double()
    mean, sq = sigma * math.sqrt(math.pi / 2), 2 * sigma**2
    assert abs(float(h.mean()) - mean) < 5 * float(h.std()) / math.sqrt(n)
    assert abs(float((h**2).mean()) - sq) < 5 * float((h**2).std()) / \
        math.sqrt(n)
    assert float(h.min()) >= 0.0


SIGMAS3 = (0.5, 1.0, 2.0)


def test_expected_gain_helpers_match_jax():
    """E|h|, E|h|^2 and E[min |h|^2] of a [U] sigma tuple against the JAX
    helpers (tests/test_stat_contracts.py:52), rtol 1e-6."""
    jcfg = JCH.ChannelConfig(num_workers=3, sigma=SIGMAS3)
    tcfg = TCH.ChannelConfig(num_workers=3, sigma=SIGMAS3)
    for name in ("expected_abs_gain", "expected_sq_gain",
                 "expected_min_sq_gain"):
        got = getattr(TCH, name)(tcfg, "cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(JCH, name)(jcfg)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(TCH.expected_abs_gain(tcfg, "cpu").numpy(),
                               np.array(SIGMAS3) * np.sqrt(np.pi / 2),
                               rtol=1e-6)
    np.testing.assert_allclose(TCH.expected_sq_gain(tcfg, "cpu").numpy(),
                               2 * np.array(SIGMAS3) ** 2, rtol=1e-6)


def test_expected_gains_are_the_moments_of_the_ports_draws():
    """200 000 rounds of the port's own gains (`rayleigh_gains`, the draw
    of `sample_channel_gains`, on a seeded CPU generator) against the
    helpers, at tests/test_stat_contracts.py's tolerances: E|h| rtol 5e-3,
    E|h|^2 rtol 1e-2, the exponential tail of |h|^2 rtol 0.05 / atol 2e-3,
    and E[min_i |h_i|^2] rtol 1e-2."""
    n = 200_000
    cfg = TCH.ChannelConfig(num_workers=3, sigma=SIGMAS3)
    gen = torch.Generator().manual_seed(0)
    h = TCH.rayleigh_gains(gen, cfg.sigmas().expand(n, 3)).double().numpy()
    one = TCH.sample_channel_gains(torch.Generator().manual_seed(0), cfg)
    assert one.shape == (3,) and torch.equal(one, torch.from_numpy(
        h[0]).float())
    np.testing.assert_allclose(h.mean(0),
                               TCH.expected_abs_gain(cfg, "cpu").numpy(),
                               rtol=5e-3)
    sq = h ** 2
    mean_sq = TCH.expected_sq_gain(cfg, "cpu").numpy()
    np.testing.assert_allclose(sq.mean(0), mean_sq, rtol=1e-2)
    for t in (0.5, 1.0, 2.0, 4.0):
        np.testing.assert_allclose((sq > t * mean_sq).mean(0),
                                   np.full(3, np.exp(-t)), rtol=0.05,
                                   atol=2e-3)
    np.testing.assert_allclose(
        sq.min(axis=1).mean(),
        float(TCH.expected_min_sq_gain(cfg, "cpu")), rtol=1e-2)


def _engine(lanes):
    from repro_torch.figures import experiment_floa
    from repro_torch.configs import PAPER_MLP
    from repro_torch.models import mlp_loss
    mc = PAPER_MLP.smoke()
    cases = [TSW.ScenarioCase(e.name, *experiment_floa(e, mc), seed=e.seed)
             for e in lanes]
    return TSW.SweepEngine(mlp_loss, TSW.SweepSpec.build(cases),
                           device="cpu"), mc


def test_seeded_draws_statistics_and_lane_independence():
    """The default draws: Rayleigh mean and unit-normal noise rows (so the
    received noise has the config's std), each lane a function of its own
    seed only."""
    from repro_torch.core.power_control import Policy
    from repro_torch.figures import Experiment
    a = Experiment("A", Policy.CI, seed=1, rounds=1)
    b = Experiment("B", Policy.BEV, seed=2, rounds=1)
    eng2, mc = _engine([a, b])
    eng1, _ = _engine([b])
    d = mc.dim
    draws2, draws1 = eng2.seeded_draws(d), eng1.seeded_draws(d)
    hs, zs = [], []
    for t in range(200):
        x2, x1 = draws2(t), draws1(t)
        assert torch.equal(x2["h_abs"][1], x1["h_abs"][0])
        assert torch.equal(x2["z"][1], x1["z"][0])
        assert x2["jam"] is None
        hs.append(x2["h_abs"])
        zs.append(x2["z"][:, :1000])
    h = torch.stack(hs).double()
    z = torch.stack(zs).double()
    n = h[:, 0].numel()
    assert abs(float(h.mean()) - math.sqrt(math.pi / 2)) < \
        5 * float(h.std()) / math.sqrt(n * 2)
    assert abs(float(z.std()) - 1.0) < 0.01
    assert abs(float(z.mean())) < 0.01
    noise = eng2._sp.noise_std[:, None, None] * z.permute(1, 0, 2)
    for lane in range(2):
        std = float(eng2.spec.cases[lane].floa.channel.noise_std)
        assert abs(float(noise[lane].std()) / std - 1.0) < 0.01

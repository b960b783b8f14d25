"""The port's Mixture-of-Experts (`repro_torch.models.moe`) against
`repro.models.moe`.

The same weights (the JAX `init_moe` draw, carried across as numpy) and
the same f32 tokens through both packages: `router_probs`,
`load_balance_loss`, `moe_scan_dense`, `moe_capacity_gather` (at a
capacity that drops pairs and at one that drops none, top-1 and top-2) and
`moe_ffn` with shared experts, at rtol 1e-5.  The two impls are pinned
against each other as tests/test_substrates.py::test_moe_impls_agree pins
the reference's.  `torch.topk` and `jax.lax.top_k` could order exact ties
differently; the router probabilities of random inputs have none (a tie
has measure zero), so both packages route every token alike.
"""
import dataclasses
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
    from repro.models import common as JC
    from repro.models import moe as JMOE

from repro_torch.models import common as TC
from repro_torch.models import moe as TMOE

RTOL = 1e-5
D, T = 32, 48


def _cfgs(e=4, k=2, f=16, shared=0, cf=1.25, impl="capacity_gather"):
    """(JAX cfg, port cfg) of a one-layer f32 MoE model."""
    kw = dict(name="m", arch_type="moe", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab_size=64)
    jm = JC.MoEConfig(num_experts=e, top_k=k, d_expert=f, num_shared=shared,
                      capacity_factor=cf, impl=impl)
    tm = TC.MoEConfig(**dataclasses.asdict(jm))
    return (JC.ModelConfig(**kw, dtype=jnp.float32, moe=jm),
            TC.ModelConfig(**kw, dtype=torch.float32, moe=tm))


def _params(jcfg, seed=0):
    """The JAX init_moe weights: (JAX tree, port tree)."""
    fac = JC.ParamFactory(jax.random.PRNGKey(seed), dtype=jnp.float32)
    JMOE.init_moe(fac, "ffn", jcfg)
    jp = jax.tree_util.tree_map(np.asarray, fac.collect()[0]["ffn"])

    def to_t(tree):
        return {k: to_t(v) if isinstance(v, dict) else torch.tensor(v)
                for k, v in tree.items()}
    return jp, to_t(jp)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_init_moe_layout_matches_jax():
    for shared in (0, 2):
        jcfg, tcfg = _cfgs(shared=shared)
        jp, _ = _params(jcfg)
        tp = TMOE.init_moe(TC.ParamInit(torch.Generator().manual_seed(0),
                                        torch.bfloat16, "cpu"), tcfg)
        flat_j = jax.tree_util.tree_leaves_with_path(jp)
        assert [(jax.tree_util.keystr(p), x.shape) for p, x in flat_j] == [
            (jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_leaves_with_path(tp)]
        assert tp["router"].dtype == torch.float32     # f32 whatever dtype
        assert tp["w1"].dtype == torch.bfloat16


def test_router_probs_and_load_balance_loss_match_jax():
    jcfg, tcfg = _cfgs(e=8, k=3)
    jp, tp = _params(jcfg)
    x = _x(1, T, D)
    jprobs = JMOE.router_probs(jp, jnp.asarray(x), jcfg)
    tprobs = TMOE.router_probs(tp, torch.from_numpy(x), tcfg)
    assert tprobs.dtype == torch.float32 and tprobs.shape == (T, 8)
    _close(tprobs, jprobs)
    _, jidx = jax.lax.top_k(jprobs, 3)
    _, tidx = torch.topk(tprobs, 3)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(TMOE.load_balance_loss(tprobs, tidx, 8),
           JMOE.load_balance_loss(jprobs, jidx, 8))


@pytest.mark.parametrize("impl,e,k,cf", [
    ("scan_dense", 4, 2, 1.25), ("scan_dense", 8, 1, 1.25),
    ("capacity_gather", 4, 2, 1.25),     # some pairs dropped
    ("capacity_gather", 4, 2, 0.5),      # many dropped
    ("capacity_gather", 8, 1, 4.0),      # none dropped, top-1
    ("capacity_gather", 4, 3, 4.0)])
def test_moe_impls_match_jax(impl, e, k, cf):
    jcfg, tcfg = _cfgs(e=e, k=k, cf=cf, impl=impl)
    jp, tp = _params(jcfg)
    x = _x(2, T, D)
    jfn = getattr(JMOE, f"moe_{impl}")
    tfn = getattr(TMOE, f"moe_{impl}")
    jy, jaux = jfn(jp, jnp.asarray(x), jcfg)
    ty, taux = tfn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)


def test_capacity_gather_drops_past_capacity():
    """At capacity_factor 0.5 some experts get more pairs than their
    capacity: the output differs from the dense impl's on some tokens (those
    that lost a pair), not on all."""
    jcfg, tcfg = _cfgs(e=4, k=2, cf=0.5)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(3, T, D))
    dense_cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl="scan_dense"))
    yc, _ = TMOE.moe_capacity_gather(tp, x, tcfg)
    yd, _ = TMOE.moe_scan_dense(tp, x, dense_cfg)
    cap = int(-(-2 * T // 4) * 0.5)
    _, idx = torch.topk(TMOE.router_probs(tp, x, tcfg), 2)
    counts = torch.bincount(idx.reshape(-1), minlength=4)
    assert (counts > cap).any()
    differ = (yc - yd).abs().amax(dim=1) > 1e-6
    assert differ.any() and not differ.all()


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_matches_jax(shared):
    for impl in ("scan_dense", "capacity_gather"):
        jcfg, tcfg = _cfgs(shared=shared, impl=impl)
        jp, tp = _params(jcfg, seed=shared)
        x = _x(4, 2, 24, D)
        jy, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
        ty, taux = TMOE.moe_ffn(tp, torch.from_numpy(x), tcfg)
        assert ty.shape == (2, 24, D)
        _close(ty, jy)
        _close(taux, jaux)


def test_moe_impls_agree():
    """tests/test_substrates.py::test_moe_impls_agree on the port: with a
    generous capacity nothing is dropped, so the two impls agree."""
    jcfg, tcfg = _cfgs(e=4, k=2, cf=4.0, impl="scan_dense")
    _, tp = _params(jcfg)
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (48, 32))))
    y1, a1 = TMOE.moe_scan_dense(tp, x, tcfg)
    cfg2 = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl="capacity_gather"))
    y2, a2 = TMOE.moe_capacity_gather(tp, x, cfg2)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-5)


def test_capacity_gather_sums_in_a_fixed_order():
    """The (token, k) contributions are summed over k in top-k order, not
    scattered with atomics: two calls give the same bits, and so does the
    same batch with its tokens permuted (each token's sum does not depend
    on where its pairs sit in the sorted buckets)."""
    jcfg, tcfg = _cfgs(e=4, k=3, cf=4.0)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(5, T, D))
    y1, _ = TMOE.moe_capacity_gather(tp, x, tcfg)
    y2, _ = TMOE.moe_capacity_gather(tp, x, tcfg)
    assert torch.equal(y1, y2)
    perm = torch.randperm(T, generator=torch.Generator().manual_seed(0))
    y3, _ = TMOE.moe_capacity_gather(tp, x[perm], tcfg)
    assert torch.equal(y3, y1[perm])


def test_routing_tape_replays_one_runs_experts_in_another():
    """A run recorded under `routing` and replayed gives the same bits with
    0 flips; a perturbed input replayed keeps the recorded experts (its
    output is the unperturbed routing's on the perturbed tokens) and
    counts the tokens whose own choice differed."""
    jcfg, tcfg = _cfgs(e=8, k=2, cf=4.0, impl="scan_dense")
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(6, T, D))
    tape = TMOE.RoutingTape()
    with TMOE.routing(tape):
        y1, _ = TMOE.moe_scan_dense(tp, x, tcfg)
        assert len(tape.recorded) == 1
        tape.replay()
        y2, _ = TMOE.moe_scan_dense(tp, x, tcfg)
    assert torch.equal(y1, y2) and int(tape.flips) == 0
    assert tape.decisions == T
    xp = x + 0.3 * torch.from_numpy(_x(7, T, D))
    _, own = torch.topk(TMOE.router_probs(tp, xp, tcfg), 2)
    _, rec = torch.topk(TMOE.router_probs(tp, x, tcfg), 2)
    want_flips = int((own.sort(-1).values != rec.sort(-1).values)
                     .any(-1).sum())
    assert want_flips > 0
    with TMOE.routing(tape.replay()):
        TMOE.moe_scan_dense(tp, xp, tcfg)
    assert int(tape.flips) == want_flips
    assert TMOE._TAPE.get() is None

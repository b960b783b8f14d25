"""The port's LM train and prefill steps (`repro_torch.launch.steps`,
`launch.train`), `TokenBatcher` and `optim` against the JAX package.

The smoke qwen3-4b (2 layers, f32, D = 1 377 664) with the weights of JAX
`init_model(PRNGKey(0))` (`params_from_jax`): 3 FLOA train steps against
the JAX `make_train_step` on a 1x1 debug mesh (U = 1 worker, so no
attacker), for BEV, CI and EF and for `use_floa=False`, with the JAX
step's draws replayed (`PRNGKey(seed)` split into the gains' and the
noise's keys, `fold_in(k_z, i)` for leaf i in tree order): params, the
stale stats gbar / eps2 and the metrics at rtol 1e-5.  The prefill step's
last-position logits at rtol 1e-5; the token batcher byte for byte; the
optimizers and schedules over 5 steps at rtol 1e-6; the training entry
point on the CPU.
"""
import functools
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
    from repro import optim as JOPT
    from repro.configs import get_smoke as jget_smoke
    from repro.core.channel import sample_channel_gains as jgains
    from repro.core.power_control import Policy as JPolicy
    from repro.data import TokenBatcher as JTokenBatcher
    from repro.data import sample_tokens
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_debug_mesh

from repro_torch import optim as TOPT
from repro_torch.configs import get_smoke
from repro_torch.core.power_control import Policy
from repro_torch.data import TokenBatcher
from repro_torch.data import sample_tokens as tsample_tokens
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch import train as TTRAIN
from repro_torch.launch.mesh import ModelAxis
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCH = "qwen3-4b"
RTOL = 1e-5
OPT_RTOL = 1e-6
STEPS, BATCH, SEQ, ALPHA = 3, 4, 16, 0.02
ROUTES = [("bev", True), ("ci", True), ("ef", True), ("bev", False)]


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, JAX params, 1x1 mesh, token batches)."""
    jcfg = jget_smoke(ARCH)
    jparams, _ = JSTEPS.init_model(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    toks = [sample_tokens(BATCH, SEQ + 1, vocab=jcfg.vocab_size, seed=t)
            for t in range(STEPS)]
    return (jcfg, get_smoke(ARCH), jparams,
            make_debug_mesh((1, 1), ("data", "model")), toks)


def _close(got, want, rtol=RTOL, err_msg=""):
    """rtol, with an atol of rtol times the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float()), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _jax_steps(policy, use_floa):
    """The JAX step run for STEPS steps: (params, [(state, metrics)])."""
    jcfg, _, jparams, mesh, toks = _setup()
    art = JSTEPS.make_train_step(
        jcfg, mesh, dict(global_batch=BATCH, seq_len=SEQ, kind="train"),
        policy=JPolicy(policy), alpha=ALPHA, use_floa=use_floa)
    params, state, out = jparams, JSTEPS.init_floa_state(), []
    with mesh:
        fn = jax.jit(art.fn, in_shardings=art.in_shardings)
        for t in range(STEPS):
            params, state, m = fn(params, state,
                                  {"tokens": jnp.asarray(toks[t])},
                                  jnp.uint32(t))
            out.append((jax.tree_util.tree_map(np.asarray, state),
                        jax.tree_util.tree_map(np.asarray, m)))
    return jax.tree_util.tree_map(np.asarray, params), out, art.meta


def _replayed_draws(seed, dim):
    """The JAX step's draws of step `seed`: gains off the first key of
    PRNGKey(seed)'s split, leaf i's noise off fold_in(second key, i)."""
    _, _, jparams, mesh, _ = _setup()
    channel = JSTEPS.default_floa(mesh, dim)["channel"]
    k_ch, k_z = jax.random.split(jax.random.PRNGKey(seed))
    return {"h_abs": torch.as_tensor(np.array(jgains(k_ch, channel))),
            "z": [torch.as_tensor(np.array(jax.random.normal(
                jax.random.fold_in(k_z, i), x.shape, jnp.float32)))
                  for i, x in enumerate(jax.tree_util.tree_leaves(jparams))]}


@pytest.mark.parametrize("policy,use_floa", ROUTES)
def test_train_step_matches_jax(policy, use_floa):
    jcfg, tcfg, jparams, _, toks = _setup()
    want_params, want_steps, jmeta = _jax_steps(policy, use_floa)
    step, meta = TSTEPS.make_train_step(
        tcfg, None, dict(global_batch=BATCH, seq_len=SEQ, kind="train"),
        policy=Policy(policy), alpha=ALPHA, use_floa=use_floa)
    assert (meta["dim"], meta["num_workers"], meta["policy"]) == (
        jmeta["dim"], jmeta["num_workers"], jmeta["policy"])
    params, state = TT.params_from_jax(jparams, "cpu"), \
        TSTEPS.init_floa_state()
    tops.reset_launches()
    for t in range(STEPS):
        draws = _replayed_draws(t, meta["dim"]) if use_floa else None
        params, state, m = step(params, state,
                                {"tokens": torch.as_tensor(toks[t])}, t,
                                draws=draws)
        wstate, wm = want_steps[t]
        for k in ("gbar", "eps2"):
            _close(state[k], wstate[k], err_msg=f"step {t} {k}")
        for k in ("loss", "grad_scale"):
            _close(m[k], wm[k], err_msg=f"step {t} {k}")
    # the step's combine is the backward itself: no kernel of the port
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    for path, g, w in zip(tree_paths(params), tree_leaves(params),
                          jax.tree_util.tree_leaves(want_params)):
        _close(g, w, err_msg=path)


def test_train_step_own_draws_are_seeded_and_move_the_params():
    _, tcfg, jparams, _, toks = _setup()
    step, _ = TSTEPS.make_train_step(tcfg, alpha=ALPHA)
    p0 = TT.params_from_jax(jparams, "cpu")
    batch = {"tokens": torch.as_tensor(toks[0])}
    runs = [step(p0, TSTEPS.init_floa_state(), batch, seed)
            for seed in (5, 5, 6)]
    same = [torch.equal(a, b) for a, b in
            zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0]))]
    other = [torch.equal(a, b) for a, b in
             zip(tree_leaves(runs[0][0]), tree_leaves(runs[2][0]))]
    assert all(same) and not all(other)
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(runs[0][0]), tree_leaves(p0)))
    assert all(torch.isfinite(x).all() for x in tree_leaves(runs[0][0]))


def test_prefill_step_matches_jax():
    jcfg, tcfg, jparams, mesh, _ = _setup()
    shape = dict(global_batch=2, seq_len=24, kind="prefill")
    art = JSTEPS.make_prefill_step(jcfg, mesh, shape)
    toks = sample_tokens(2, 24, vocab=jcfg.vocab_size, seed=9)
    with mesh:
        want = jax.jit(art.fn)(jparams, {"tokens": jnp.asarray(toks)})
    step, meta = TSTEPS.make_step(tcfg, None, "prefill_32k", shape)
    got = step(TT.params_from_jax(jparams, "cpu"),
               {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, tcfg.padded_vocab) and not got.requires_grad
    _close(got, want)
    assert meta["dim"] == art.meta["dim"]
    assert meta["batch"]["tokens"][0] == JSTEPS.batch_shapes(
        jcfg, shape, "prefill")["tokens"].shape


def test_step_builders_follow_the_reference():
    jcfg, tcfg, _, mesh, _ = _setup()
    shape = dict(global_batch=8, seq_len=64, kind="train")
    assert TSTEPS.batch_shapes(tcfg, shape, "train")["tokens"][0] == \
        JSTEPS.batch_shapes(jcfg, shape, "train")["tokens"].shape
    dim = TSTEPS.param_count(tcfg)
    got, want = TSTEPS.default_floa(None, dim), JSTEPS.default_floa(mesh, dim)
    assert got["channel"].noise_std == want["channel"].noise_std
    assert got["channel"].num_workers == want["channel"].num_workers == 1
    assert got["attack"].attack.value == want["attack"].attack.value
    assert got["attack"].byzantine_mask == want["attack"].byzantine_mask
    # 16 ranks do not divide the smoke qwen3-4b's 8 heads: wq / wk / wv
    # split d, wo hd, and every rank computes every head
    TATT.check_heads(tcfg, 16)
    assert TATT.head_dims(tcfg, 16) == (0, 0, 1)
    assert TATT.local_heads(tcfg, 16, 3) == (
        slice(0, tcfg.n_heads), slice(0, tcfg.n_kv_heads))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TATT.check_heads(get_smoke("mamba2-1.3b"), 16)
    with pytest.raises(ValueError, match="process group"):
        ModelAxis(16)
    with pytest.raises(TypeError, match="is not a mesh"):
        TSTEPS.make_train_step(tcfg, ModelAxis(1))
    _, meta = TSTEPS.make_step(tcfg, None, "decode_32k",
                               dict(global_batch=2, seq_len=8,
                                    kind="decode"))
    assert meta["window"] is None


def test_token_batcher_byte_equal():
    def fn(pkg):
        return lambda n, s: pkg(n, s, vocab=300, seed=4)
    got = TokenBatcher(fn(tsample_tokens), 3, 10, seed=4)
    want = JTokenBatcher(fn(sample_tokens), 3, 10, seed=4)
    for _ in range(3):
        a, b = next(got)["tokens"], next(want)["tokens"]
        assert a.shape == (3, 11) and a.tobytes() == b.tobytes()
    assert got.step == want.step == 3


def _opt_problem():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "sub": {"b": rng.standard_normal(3).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((4, 3)).astype(np.float32),
              "sub": {"b": rng.standard_normal(3).astype(np.float32)}}
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.01})])
def test_optimizers_match_jax(name, kw):
    params, grads = _opt_problem()
    jopt, topt = getattr(JOPT, name)(**kw), getattr(TOPT, name)(**kw)
    jp, tp = params, tree_map(torch.as_tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(g, js, jp, 0.05)
        tu, ts = topt.update(tree_map(torch.as_tensor, g), ts, tp, 0.05)
        jp, tp = JOPT.apply_updates(jp, ju), TOPT.apply_updates(tp, tu)
    for path, a, b in zip(tree_paths(tp), tree_leaves(tp),
                          jax.tree_util.tree_leaves(jp)):
        _close(a, b, rtol=OPT_RTOL, err_msg=path)


def test_schedules_match_jax():
    for name, args in [("constant", (0.1,)), ("cosine", (0.1, 10)),
                       ("cosine", (0.3, 7, 0.0)),
                       ("warmup_cosine", (0.1, 3, 10))]:
        jfn, tfn = getattr(JOPT, name)(*args), getattr(TOPT, name)(*args)
        for step in range(13):
            _close(tfn(step), jfn(step), rtol=OPT_RTOL,
                   err_msg=f"{name}{args} at {step}")


def test_train_entry_point_on_the_cpu(capsys, tmp_path):
    TTRAIN.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "8", "--ckpt",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    1 loss" in out and "workers=1" in out
    assert (tmp_path / "ckpt_2.meta.json").exists()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        TTRAIN.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--mesh", "multi"])


def test_train_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TTRAIN.main(["--arch", ARCH, "--smoke", "--steps", "1"])

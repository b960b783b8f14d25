"""The dense and MoE archs of the zoo on the port against the JAX package.

granite-8b, starcoder2-3b (a native window of 64 at smoke size),
moonshot-v1-16b-a3b (every block "attn_moe", 4 experts top-2 + 1 shared)
and llama4-maverick-400b-a17b (pattern ("attn", "attn_moe"), 4 experts
top-1 + 1 shared), at their smoke configs (f32), and llama4 at 3 layers so
that one super-block is stacked and a `tail0` block ("attn") is left over.
For each (the config fields are held against JAX's by
tests/test_torch_lm.py::test_config_fields_equal_jax): the parameter tree's
leaf paths, shapes and dtypes equal JAX's in JAX's leaf order (the MoE
router in f32);
and from the weights of JAX `init_lm(PRNGKey(0))` carried across with
`params_from_jax`, `lm_loss` (with the MoE aux term) and the prefill
step's last-position logits agree at rtol 1e-5, 8 teacher-forced decode
steps at rtol 1e-4, and one FLOA train step (BEV, U = 1, the JAX step's
draws replayed) at rtol 1e-5.  Everything runs on the CPU.
"""
import dataclasses
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
    from repro.configs import registry as JR
    from repro.core.channel import sample_channel_gains as jgains
    from repro.data import sample_tokens
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as JT

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

ZOO = ["granite-8b", "starcoder2-3b", "moonshot-v1-16b-a3b",
       "llama4-maverick-400b-a17b"]
# (arch, n_layers override): each smoke config, and llama4 with a tail
CASES = [(a, None) for a in ZOO] + [("llama4-maverick-400b-a17b", 3)]
IDS = [a if n is None else f"{a}-L{n}" for a, n in CASES]
RTOL, DECODE_RTOL = 1e-5, 1e-4
BATCH, SEQ, STEPS, ALPHA = 2, 12, 8, 0.02
JDTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _close(got, want, rtol, err_msg=""):
    """rtol, with an atol of rtol times the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).detach().float()), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers):
    """(JAX cfg, port cfg, JAX params as numpy, port params)."""
    jcfg, tcfg = JR.get_smoke(arch), get_smoke(arch)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TT.params_from_jax(jparams, "cpu")


def _jpaths(tree):
    return ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_param_tree_paths_and_order_equal_jax(arch, n_layers):
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers)
    drawn = TSTEPS.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    meta = TSTEPS.init_model(tcfg, None, "meta")
    want = [(p, tuple(x.shape), JDTYPE[x.dtype.type]) for p, x in
            zip(_jpaths(jparams), jax.tree_util.tree_leaves(jparams))]
    for tree in (drawn, meta, tparams):
        assert [(p, tuple(x.shape), x.dtype) for p, x in
                zip(tree_paths(tree), tree_leaves(tree))] == want
    n_rep, n_tail = TT.layer_counts(tcfg)
    assert ("tail0" in drawn) == bool(n_tail) and (n_layers != 3 or n_tail)
    if tcfg.moe is not None:
        assert any(p.endswith("ffn/router") for p, _, _ in want)
        routers = [x for p, x in zip(tree_paths(drawn), tree_leaves(drawn))
                   if p.endswith("ffn/router")]
        assert routers and all(x.dtype == torch.float32 for x in routers)
    assert TSTEPS.param_count(tcfg) == sum(
        int(np.prod(s)) for _, s, _ in want)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_loss_and_prefill_match_jax(arch, n_layers):
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers)
    toks = sample_tokens(BATCH, SEQ + 1, vocab=jcfg.vocab_size, seed=3)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.as_tensor(toks)}
    _close(TT.lm_loss(tparams, batch_t, tcfg),
           JT.lm_loss(jparams, batch_j, jcfg), RTOL)
    (tper, taux), (jper, jaux) = (
        TT.lm_per_example_loss(tparams, batch_t, tcfg),
        JT.lm_per_example_loss(jparams, batch_j, jcfg))
    _close(tper, jper, RTOL)
    _close(taux, jaux, RTOL)
    assert (float(taux) > 0) == (tcfg.moe is not None)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    shape = dict(global_batch=BATCH, seq_len=SEQ, kind="prefill")
    art = JSTEPS.make_prefill_step(jcfg, mesh, shape)
    with mesh:
        want = jax.jit(art.fn)(jparams, {"tokens": jnp.asarray(toks[:, :-1])})
    step, meta = TSTEPS.make_prefill_step(tcfg, None, shape)
    assert meta["dim"] == art.meta["dim"]
    _close(step(tparams, {"tokens": torch.as_tensor(toks[:, :-1])}), want,
           RTOL)


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_teacher_forced_decode_matches_jax(arch, n_layers):
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers)
    toks = sample_tokens(BATCH, STEPS, vocab=jcfg.vocab_size, seed=4)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    jcaches = JT.init_caches(jcfg, BATCH, STEPS)
    tcaches = TT.init_caches(tcfg, BATCH, STEPS, device="cpu")
    assert sorted(tcaches) == sorted(jcaches)
    assert tree_paths(tcaches) == _jpaths(jcaches)
    tops.reset_launches()
    for i in range(STEPS):
        jl, jcaches = jstep(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        tl, tcaches = TT.decode_step(
            tparams, tcaches, torch.as_tensor(toks[:, i:i + 1]),
            torch.tensor(i, dtype=torch.int32), tcfg)
        _close(tl, jl, DECODE_RTOL, err_msg=f"step {i}")
    for p, g, w in zip(tree_paths(tcaches), tree_leaves(tcaches),
                       jax.tree_util.tree_leaves(jcaches)):
        _close(g, w, DECODE_RTOL, err_msg=p)
    assert tops.launch_counts()["decode_attention"] == 0   # CPU: plain route


@pytest.mark.parametrize("arch,n_layers", CASES, ids=IDS)
def test_floa_train_step_matches_jax(arch, n_layers):
    """One BEV step on a 1x1 mesh (U = 1), the JAX step's gains and
    per-leaf noise replayed; the weighted loss carries the MoE aux term
    (router_aux_coef * aux * sum(s) / U) on the MoE archs."""
    jcfg, tcfg, jparams, tparams = _setup(arch, n_layers)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    shape = dict(global_batch=BATCH, seq_len=SEQ, kind="train")
    toks = sample_tokens(BATCH, SEQ + 1, vocab=jcfg.vocab_size, seed=5)
    art = JSTEPS.make_train_step(jcfg, mesh, shape, alpha=ALPHA)
    with mesh:
        wparams, wstate, wm = jax.jit(art.fn, in_shardings=art.in_shardings)(
            jparams, JSTEPS.init_floa_state(), {"tokens": jnp.asarray(toks)},
            jnp.uint32(0))
    step, meta = TSTEPS.make_train_step(tcfg, None, shape, alpha=ALPHA)
    assert meta["dim"] == art.meta["dim"]
    channel = JSTEPS.default_floa(mesh, meta["dim"])["channel"]
    k_ch, k_z = jax.random.split(jax.random.PRNGKey(0))
    draws = {"h_abs": torch.as_tensor(np.array(jgains(k_ch, channel))),
             "z": [torch.as_tensor(np.array(jax.random.normal(
                 jax.random.fold_in(k_z, i), x.shape, jnp.float32)))
                   for i, x in enumerate(jax.tree_util.tree_leaves(
                       jparams))]}
    params, state, m = step(tparams, TSTEPS.init_floa_state(),
                            {"tokens": torch.as_tensor(toks)}, 0,
                            draws=draws)
    for k in ("gbar", "eps2"):
        _close(state[k], wstate[k], RTOL, err_msg=k)
    for k in ("loss", "grad_scale"):
        _close(m[k], wm[k], RTOL, err_msg=k)
    for p, g, w in zip(tree_paths(params), tree_leaves(params),
                       jax.tree_util.tree_leaves(wparams)):
        _close(g, w, RTOL, err_msg=p)

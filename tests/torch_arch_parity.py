"""Shared checks of one registered arch of the port against the JAX package
at its smoke config (tests/test_torch_mla.py, tests/test_torch_ssm.py,
test_torch_vlm.py, test_torch_encdec.py; test_torch_zoo.py and
test_torch_lm.py take some of them): the weights of JAX
`init_model(PRNGKey(0))` (`init_lm`, or `init_encdec` for the
encoder-decoder) carried across with `params_from_jax`,
then the parameter tree, the loss and its gradient, prefill, teacher-forced
decode (and decode against the full-sequence forward within each package),
one FLOA train step with the JAX step's draws replayed, and the greedy
serve against the JAX serving loop.  Each compares at `rtol` with an atol
of rtol times the largest |want| (the products sum in another order in the
two frameworks).  `extra`, where a check takes it, adds numpy inputs to
both batches: a VLM's `embeds_prefix`, an encoder-decoder's `frames`."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

RTOL, DECODE_RTOL = 1e-5, 1e-4
JDTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def close(got, want, rtol=RTOL, err_msg=""):
    """rtol, with an atol of rtol times the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).detach().float()), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def setup(arch, n_layers=None):
    """(JAX cfg, port cfg, JAX params as numpy, port params) of arch's smoke
    config (n_layers replaced when given)."""
    jcfg, tcfg = JR.get_smoke(arch), get_smoke(arch)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jparams, _ = JSTEPS.init_model(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TT.params_from_jax(jparams, "cpu")


def batches(toks, extra=None):
    """The (JAX, port) batches of numpy tokens and the `extra` inputs."""
    data = {"tokens": toks, **(extra or {})}
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.as_tensor(v) for k, v in data.items()})


def jpaths(tree):
    return ["/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(tree)]


def check_tree(arch):
    """The port's drawn, "meta" and carried-across trees: the JAX leaf
    paths, shapes and dtypes in the JAX leaf order; the parameter count."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    drawn = TSTEPS.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    meta = TSTEPS.init_model(tcfg, None, "meta")
    want = [(p, tuple(x.shape), JDTYPE[x.dtype.type]) for p, x in
            zip(jpaths(jparams), jax.tree_util.tree_leaves(jparams))]
    for tree in (drawn, meta, tparams):
        assert [(p, tuple(x.shape), x.dtype) for p, x in
                zip(tree_paths(tree), tree_leaves(tree))] == want
    for g, w in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        assert g.numpy().tobytes() == w.tobytes()
    assert TSTEPS.param_count(tcfg) == sum(
        int(np.prod(s)) for _, s, _ in want)
    return want


def check_loss_and_grads(arch, batch, seq, seed, grad_rtol=RTOL,
                         extra=None):
    """lm_loss, the per-example losses and aux, and the gradient of
    lm_loss leaf by leaf at grad_rtol."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    toks = sample_tokens(batch, seq + 1, vocab=jcfg.vocab_size, seed=seed)
    bj, bt = batches(toks, extra)
    # the reference's loss, per-example losses and gradient in one program
    jloss, (jper, jaux), gj = jax.jit(lambda p: (
        JT.lm_loss(p, bj, jcfg), JT.lm_per_example_loss(p, bj, jcfg),
        jax.grad(lambda q: JT.lm_loss(q, bj, jcfg))(p)))(jparams)
    close(TT.lm_loss(tparams, bt, tcfg), jloss)
    tper, taux = TT.lm_per_example_loss(tparams, bt, tcfg)
    close(tper, jper)
    close(taux, jaux)
    gt = torch.func.grad(lambda p: TT.lm_loss(p, bt, tcfg))(tparams)
    for p, g, w in zip(tree_paths(gt), tree_leaves(gt),
                       jax.tree_util.tree_leaves(gj)):
        assert np.isfinite(np.asarray(w)).all(), p
        close(g, w, grad_rtol, err_msg=p)


def check_prefill(arch, batch, seq, seed, extra=None, shape_seq=None):
    """The prefill step on `seq` tokens (and `extra`), the steps built for
    an input shape of `shape_seq` (default seq) positions."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    toks = sample_tokens(batch, seq, vocab=jcfg.vocab_size, seed=seed)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    shape = dict(global_batch=batch, seq_len=shape_seq or seq,
                 kind="prefill")
    art = JSTEPS.make_prefill_step(jcfg, mesh, shape)
    bj, bt = batches(toks, extra)
    with mesh:
        want = jax.jit(art.fn)(jparams, bj)
    step, meta = TSTEPS.make_prefill_step(tcfg, None, shape)
    assert meta["dim"] == art.meta["dim"]
    close(step(tparams, bt), want)


def check_decode(arch, batch, steps, seed):
    """`steps` teacher-forced decode steps against JAX's (logits and the
    caches at the end), and in each package the decode logits against its
    own full-sequence forward on the same tokens (the port's replaying
    the forward's expert choices, `RoutingTape.by_step`)."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    toks = sample_tokens(batch, steps, vocab=jcfg.vocab_size, seed=seed)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    jcaches = JT.init_caches(jcfg, batch, steps)
    tcaches = TT.init_caches(tcfg, batch, steps, device="cpu")
    assert tree_paths(tcaches) == jpaths(jcaches)
    jl, tl = [], []
    for i in range(steps):
        j, jcaches = jstep(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(i))
        t, tcaches = TT.decode_step(
            tparams, tcaches, torch.as_tensor(toks[:, i:i + 1]),
            torch.tensor(i, dtype=torch.int32), tcfg)
        close(t, j, DECODE_RTOL, err_msg=f"step {i}")
        jl.append(np.asarray(j[:, 0]))
        tl.append(t[:, 0])
    for p, g, w in zip(tree_paths(tcaches), tree_leaves(tcaches),
                       jax.tree_util.tree_leaves(jcaches)):
        close(g, w, DECODE_RTOL, err_msg=p)
    jfull, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, jnp.asarray(toks))
    close(np.stack(jl, axis=1), jfull, DECODE_RTOL, err_msg="JAX")
    # the port's decode replays its forward's expert choices (a MoE model)
    ftape = MOE.RoutingTape()
    with MOE.routing(ftape):
        tfull, _ = TT.forward(tparams, torch.as_tensor(toks), tcfg)
    caches = TT.init_caches(tcfg, batch, steps, device="cpu")
    with MOE.routing(ftape.by_step(batch, steps)):
        tl = [TT.decode_step(tparams, caches, torch.as_tensor(
            toks[:, i:i + 1]), i, tcfg)[0][:, 0] for i in range(steps)]
    close(torch.stack(tl, dim=1), tfull, DECODE_RTOL, err_msg="port")


def check_train_step(arch, batch, seq, seed, alpha=0.02, n_layers=None,
                     extra=None, shape_seq=None, remat=None):
    """One BEV step on a 1x1 mesh (U = 1), the JAX step's gains and
    per-leaf noise replayed (the weighted loss carries the MoE aux term,
    router_aux_coef * aux * sum(s) / U, on a MoE arch); the batch `seq`
    + 1 tokens (and `extra`), the steps built for an input shape of
    `shape_seq` (default seq) positions; `remat`, given, replaces both
    configs' remat."""
    jcfg, tcfg, jparams, tparams = setup(arch, n_layers)
    if remat is not None:
        jcfg = dataclasses.replace(jcfg, remat=remat)
        tcfg = dataclasses.replace(tcfg, remat=remat)
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    shape = dict(global_batch=batch, seq_len=shape_seq or seq, kind="train")
    toks = sample_tokens(batch, seq + 1, vocab=jcfg.vocab_size, seed=seed)
    art = JSTEPS.make_train_step(jcfg, mesh, shape, alpha=alpha)
    bj, bt = batches(toks, extra)
    with mesh:
        wparams, wstate, wm = jax.jit(art.fn, in_shardings=art.in_shardings)(
            jparams, JSTEPS.init_floa_state(), bj, jnp.uint32(0))
    step, meta = TSTEPS.make_train_step(tcfg, None, shape, alpha=alpha)
    assert meta["dim"] == art.meta["dim"]
    channel = JSTEPS.default_floa(mesh, meta["dim"])["channel"]
    k_ch, k_z = jax.random.split(jax.random.PRNGKey(0))
    draws = {"h_abs": torch.as_tensor(np.array(jgains(k_ch, channel))),
             "z": [torch.as_tensor(np.array(jax.random.normal(
                 jax.random.fold_in(k_z, i), x.shape, jnp.float32)))
                   for i, x in enumerate(jax.tree_util.tree_leaves(
                       jparams))]}
    params, state, m = step(tparams, TSTEPS.init_floa_state(), bt, 0,
                            draws=draws)
    for k in ("gbar", "eps2"):
        close(state[k], wstate[k], err_msg=k)
    for k in ("loss", "grad_scale"):
        close(m[k], wm[k], err_msg=k)
    for p, g, w in zip(tree_paths(params), tree_leaves(params),
                       jax.tree_util.tree_leaves(wparams)):
        close(g, w, err_msg=p)


def jax_serve(jcfg, jparams, batch, prompt_len, gen):
    """The loop of repro/launch/serve.py on one device, greedy: (prompts,
    generated tokens)."""
    max_len = prompt_len + gen
    step = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    prompts = jnp.asarray(sample_tokens(batch, prompt_len,
                                        vocab=jcfg.vocab_size, seed=0))
    caches = JT.init_caches(jcfg, batch, max_len, window=jcfg.window)
    for i in range(prompt_len):
        logits, caches = step(jparams, caches, prompts[:, i:i + 1],
                              jnp.int32(i))
    out = []
    tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], axis=-1).astype(jnp.int32)
    for i in range(prompt_len, max_len):
        out.append(tok)
        logits, caches = step(jparams, caches, tok, jnp.int32(i))
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size],
                         axis=-1).astype(jnp.int32)
    return np.asarray(prompts), np.asarray(jnp.concatenate(out, axis=1))


def check_serve(arch, batch, prompt_len, gen):
    jcfg, tcfg, jparams, tparams = setup(arch)
    res = TS.serve(tcfg, batch, prompt_len, gen, device="cpu", params=tparams)
    jprompts, jtokens = jax_serve(jcfg, jparams, batch, prompt_len, gen)
    np.testing.assert_array_equal(res.prompts.numpy(), jprompts)
    np.testing.assert_array_equal(res.tokens.numpy(), jtokens)
    assert res.logits.shape == (prompt_len + gen, batch, tcfg.padded_vocab)

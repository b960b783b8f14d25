"""The windowed (ring-buffer) KV cache of the port against the JAX package.

A window makes every decode cache a ring of min(max_len, window) slots,
written at slot pos % slots; the attention passes the token's true pos to
the decode attention, whose valid length min(pos + 1, S) is then every
slot, which is the reference's mask over the slots' rebuilt positions
(`repro/models/attention.py::decode_step`).  Held here on the CPU (the
attention takes the kernel's plain version), with JAX weights carried
across by `params_from_jax`:

- starcoder2-3b's smoke config (native window 64) for 80 teacher-forced
  decode steps into a ring of 64 slots (one wrap), logits and caches at
  rtol 1e-4;
- qwen3-4b's smoke config with `long_context_window` 16 on both sides,
  through `make_decode_step(cfg, "long_500k")` and the JAX step of the
  same shape, 40 steps into a ring of 16 slots (two wraps), rtol 1e-4;
- one attention layer's decode step on a ring past its wrap, rtol 1e-4;
- `lm_loss` at a window shorter than the sequence, rtol 1e-5;
- the decode attention's contract for pos >= S (every slot), Python int
  and tensor alike, and a negative pos refused.
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
    from repro.data import sample_tokens
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_debug_mesh
    from repro.models import attention as JATT
    from repro.models import transformer as JT

from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

DECODE_RTOL, LOSS_RTOL = 1e-4, 1e-5


def _close(got, want, rtol, err_msg=""):
    """rtol, with an atol of rtol times the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).detach().float()), want, rtol=rtol,
        atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _setup(arch, long_window=None):
    """(JAX cfg, port cfg, JAX params as numpy, port params)."""
    jcfg, tcfg = JR.get_smoke(arch), get_smoke(arch)
    if long_window is not None:
        jcfg = dataclasses.replace(jcfg, long_context_window=long_window)
        tcfg = dataclasses.replace(tcfg, long_context_window=long_window)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TT.params_from_jax(jparams, "cpu")


def _teacher_forced(jstep, tstep, jparams, tparams, jcaches, tcaches, toks):
    """Both steps fed toks [B, n] from their caches: logits at every step
    and the caches at the end at DECODE_RTOL."""
    for i in range(toks.shape[1]):
        jl, jcaches = jstep(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        tl, tcaches = tstep(tparams, tcaches,
                            torch.as_tensor(toks[:, i:i + 1]),
                            torch.tensor(i, dtype=torch.int32))
        _close(tl, jl, DECODE_RTOL, err_msg=f"step {i}")
    for p, g, w in zip(tree_paths(tcaches), tree_leaves(tcaches),
                       jax.tree_util.tree_leaves(jcaches)):
        _close(g, w, DECODE_RTOL, err_msg=p)


def test_starcoder2_ring_decode_past_a_wrap_matches_jax():
    """80 steps into starcoder2's native 64-slot ring (the cache holds 64
    of the 80 positions: slots 0-15 are overwritten by positions 64-79)."""
    jcfg, tcfg, jparams, tparams = _setup("starcoder2-3b")
    b, steps = 2, 80
    assert tcfg.window == jcfg.window == 64
    jcaches = JT.init_caches(jcfg, b, steps, window=jcfg.window)
    tcaches = TT.init_caches(tcfg, b, steps, window=tcfg.window,
                             device="cpu")
    assert tcaches["blocks"]["b0"]["k"].shape == (2, b, 64, 2, 32) == \
        jcaches["blocks"]["b0"]["k"].shape
    toks = sample_tokens(b, steps, vocab=jcfg.vocab_size, seed=6)
    tops.reset_launches()
    _teacher_forced(jax.jit(functools.partial(JT.decode_step, cfg=jcfg)),
                    functools.partial(TT.decode_step, cfg=tcfg),
                    jparams, tparams, jcaches, tcaches, toks)
    assert tops.launch_counts()["decode_attention"] == 0   # CPU: plain route


def test_qwen3_long_500k_ring_matches_jax_step():
    """qwen3-4b's long_500k variant with its window cut from 8192 to 16:
    `make_decode_step(cfg, "long_500k")` against the JAX step of the same
    shape name (1x1 mesh), 40 steps into 16 slots."""
    jcfg, tcfg, jparams, tparams = _setup("qwen3-4b", long_window=16)
    b, steps = 1, 40
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    art = JSTEPS.make_decode_step(
        jcfg, mesh, dict(seq_len=steps, global_batch=b, kind="decode"),
        "long_500k")
    step, meta = TSTEPS.make_decode_step(tcfg, "long_500k")
    assert meta["window"] == art.meta["window"] == 16
    assert meta["window"] == TSTEPS.decode_window(tcfg, "long_500k")
    assert TSTEPS.decode_window(tcfg, "decode_32k") is None
    jcaches = JT.init_caches(jcfg, b, steps, window=16)
    tcaches = TT.init_caches(tcfg, b, steps, window=meta["window"],
                             device="cpu")
    assert tuple(tcaches["blocks"]["b0"]["k"].shape) == \
        art.args[1]["blocks"]["b0"]["k"].shape == (2, b, 16, 2, 32)
    toks = sample_tokens(b, steps, vocab=jcfg.vocab_size, seed=7)
    with mesh:
        _teacher_forced(jax.jit(art.fn), step, jparams, tparams, jcaches,
                        tcaches, toks)


@pytest.mark.parametrize("window,max_len", [(8, 32), (8, 8), (32, 8)])
def test_attention_ring_step_matches_jax(window, max_len):
    """One layer's decode step on a ring of min(max_len, window) slots
    filled with random keys, at positions before, on and past a wrap (and
    past max_len where the ring is the whole cache)."""
    jcfg, tcfg, jparams, tparams = _setup("qwen3-4b")
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["blocks"]["b0"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["b0"]["attn"].items()}
    b, slots = 2, min(max_len, window)
    rng = np.random.default_rng(window + max_len)
    ck = rng.standard_normal((b, slots, 2, 32), np.float32)
    cv = rng.standard_normal((b, slots, 2, 32), np.float32)
    tcache = TATT.init_cache(tcfg, b, max_len, window, torch.float32)
    assert tcache["k"].shape == (b, slots, 2, 32)
    for pos in sorted({0, slots - 1, slots, slots + 3, 3 * slots + 1}):
        x1 = rng.standard_normal((b, 1, tcfg.d_model), np.float32)
        jy, jc = JATT.decode_step(jp, jnp.asarray(x1),
                                  dict(k=jnp.asarray(ck), v=jnp.asarray(cv)),
                                  jnp.int32(pos), jcfg, window=window)
        tcache = {"k": torch.from_numpy(ck.copy()),
                  "v": torch.from_numpy(cv.copy())}
        ty, _ = TATT.decode_step(tp, torch.from_numpy(x1), tcache,
                                 torch.tensor(pos, dtype=torch.int32), tcfg,
                                 window=window)
        _close(ty, jy, DECODE_RTOL, err_msg=f"pos {pos}")
        for k in ("k", "v"):
            _close(tcache[k], jc[k], DECODE_RTOL, err_msg=f"pos {pos} {k}")


@pytest.mark.parametrize("arch,window", [("qwen3-4b", 8),
                                         ("starcoder2-3b", None)])
def test_lm_loss_at_a_short_window_matches_jax(arch, window):
    """The full-sequence path (`gqa_full` -> `_chunked_attn` ->
    `make_causal_mask(.., window)`) at a window shorter than the sequence:
    an explicit window 8 on qwen3, starcoder2's native 64 at 96 positions."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    seq = 96 if window is None else 24
    toks = sample_tokens(2, seq + 1, vocab=jcfg.vocab_size, seed=8)
    want = JT.lm_loss(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                      window=window)
    got = TT.lm_loss(tparams, {"tokens": torch.as_tensor(toks)}, tcfg,
                     window=window)
    _close(got, want, LOSS_RTOL)
    full = TT.lm_loss(tparams, {"tokens": torch.as_tensor(toks)},
                      dataclasses.replace(tcfg, window=None))
    assert abs(float(full) - float(got)) > 1e-4    # the window bites


def test_decode_attention_pos_past_the_cache_attends_every_slot():
    """pos >= S (a ring's pos) attends every slot, for a Python int and a
    0-d tensor, on the wrapper and its plain version alike, and equals
    pos = S - 1; a negative int is refused."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 64, generator=g)
    k = torch.randn(2, 16, 2, 64, generator=g)
    v = torch.randn(2, 16, 2, 64, generator=g)
    full = tops.decode_attention(q, k, v, 15)
    for pos in (16, 17, 524287):
        for p in (pos, torch.tensor(pos, dtype=torch.int32)):
            assert torch.equal(tops.decode_attention(q, k, v, p), full)
            assert torch.equal(tref.decode_attention_ref(q, k, v, p), full)
    assert not torch.equal(tops.decode_attention(q, k, v, 14), full)
    with pytest.raises(ValueError, match="negative"):
        tops.decode_attention(q, k, v, -1)


def test_split_plan_depends_on_the_slots_alone():
    """The split count is planned from the cache's S (the ring's slots),
    never from pos: a 4096-slot ring at pos 524 287 is planned as a
    4096-position cache (132 SMs x 2 resident blocks, a stand-in for the
    card's occupancy query)."""
    slots = 264
    blocks, ring = DA.launch_plan(1, 24, 2, 4096, torch.bfloat16, slots)
    # starcoder2's G = 12 takes two blocks a KV head: 8 and 4 query heads
    assert blocks == 4
    # too few blocks to fill a wave: the most chunks of >= MIN_CHUNK keys
    assert ring == 4096 // DA.MIN_CHUNK == 16
    # a linear cache of 524 288 positions would be cut into a wave's worth
    assert DA.launch_plan(1, 24, 2, 524288, torch.bfloat16, slots)[1] == 60


@pytest.mark.parametrize("arch,shape", [("starcoder2-3b", "decode_32k"),
                                        ("granite-8b", "long_500k")])
def test_serve_past_a_wrap_matches_jax_loop(arch, shape):
    """`serve` 40 prompt + 40 generated tokens into a ring: starcoder2's
    native 64 slots, and granite's long_500k SWA window cut to 16 (the
    reference's serve loop, repro/launch/serve.py, greedy, with the caches
    of the same window): the same prompts and greedy tokens."""
    from repro_torch.launch import serve as TS
    jcfg, tcfg, jparams, tparams = _setup(
        arch, long_window=16 if shape == "long_500k" else None)
    b, prompt_len, gen = 2, 40, 40
    window = TSTEPS.decode_window(tcfg, shape)
    assert window == JSTEPS.decode_window(jcfg, shape)
    res = TS.serve(tcfg, b, prompt_len, gen, device="cpu", params=tparams,
                   shape=shape)
    step = jax.jit(functools.partial(JT.decode_step, cfg=jcfg,
                                     window=window))
    prompts = jnp.asarray(sample_tokens(b, prompt_len, vocab=jcfg.vocab_size,
                                        seed=0))
    caches = JT.init_caches(jcfg, b, prompt_len + gen, window=window)
    for i in range(prompt_len):
        logits, caches = step(jparams, caches, prompts[:, i:i + 1],
                              jnp.int32(i))
    out = []
    for i in range(prompt_len, prompt_len + gen):
        tok = jnp.argmax(logits[:, :, :jcfg.vocab_size], axis=-1)
        out.append(tok)
        logits, caches = step(jparams, caches, tok.astype(jnp.int32),
                              jnp.int32(i))
    np.testing.assert_array_equal(res.prompts.numpy(), np.asarray(prompts))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.asarray(jnp.concatenate(out, axis=1)))

"""DeepSeek-V2's multi-head latent attention (MLA) and deepseek-v2-236b on
the port against the JAX package, at the reference's smoke config (f32,
2 layers, 4 heads, q_lora 64, kv_lora 32, 4 experts top-2 + 1 shared).

`mla_full` on one query chunk, on several (Q_CHUNK monkeypatched on both
modules) and at a length off the chunk grid, which the reference runs as
one chunk; `mla_decode_step` (the absorbed form) at every position of a
cache, the last slot included, its cache written in place; and the whole
model through tests/torch_arch_parity.py: the tree, loss and gradient,
prefill, teacher-forced decode (and decode against the forward in each
package), one FLOA train step with replayed draws and the greedy serve.
Then long_500k: the decode step's full 524 288-slot latent cache, one
step at its last position against the JAX step on the same cache.
rtol 1e-5, decode 1e-4.  Everything runs on the CPU.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.launch import steps as JSTEPS
    from repro.models import attention as JATT
    from repro.models import transformer as JT

import torch_arch_parity as AP

from repro_torch.configs import get_config
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT

ARCH = "deepseek-v2-236b"
LONG = 524288


def _layer(n=0):
    """Layer n's MLA weights, (JAX, port)."""
    jcfg, tcfg, jparams, tparams = AP.setup(ARCH)
    jp = {k: v[n] for k, v in jparams["blocks"]["b0"]["attn"].items()}
    tp = {k: v[n] for k, v in tparams["blocks"]["b0"]["attn"].items()}
    return jcfg, tcfg, jp, tp


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_param_tree_paths_and_order_equal_jax():
    want = AP.check_tree(ARCH)
    names = {p.rsplit("/", 1)[-1] for p, _, _ in want if "/attn/" in p}
    assert names == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b",
                     "wv_b", "wo"}


@pytest.mark.parametrize("q_chunk,sq", [(1024, 24), (8, 24), (8, 20)],
                         ids=["one-chunk", "three-chunks", "off-grid"])
def test_mla_full_matches_jax(monkeypatch, q_chunk, sq):
    """Several chunks at 24 / 8; at 20 / 8 the reference runs one chunk of
    20 (its `sq % Q_CHUNK` rule), which the port mirrors."""
    monkeypatch.setattr(JATT, "Q_CHUNK", q_chunk)
    monkeypatch.setattr(TATT, "Q_CHUNK", q_chunk)
    jcfg, tcfg, jp, tp = _layer(1)
    x = _rng(sq, 2, sq, tcfg.d_model)
    pos = np.broadcast_to(np.arange(sq), (2, sq))
    want = JATT.mla_full(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TATT.mla_full(tp, torch.from_numpy(x), tcfg, torch.from_numpy(
        pos.copy()))
    AP.close(got, want)


def test_mla_decode_step_at_every_position():
    """The absorbed decode over a cache of 8 slots filled with random
    latents, at pos 0 .. 7 (the last slot): the output and the written
    cache against the JAX step, the port's cache written in place."""
    jcfg, tcfg, jp, tp = _layer(0)
    m = tcfg.mla
    b, s = 2, 8
    ck, cr = _rng(1, b, s, m.kv_lora), _rng(2, b, s, m.qk_rope_dim)
    for pos in range(s):
        x1 = _rng(10 + pos, b, 1, tcfg.d_model)
        jy, jc = JATT.mla_decode_step(
            jp, jnp.asarray(x1), dict(c_kv=jnp.asarray(ck),
                                      k_rope=jnp.asarray(cr)),
            jnp.int32(pos), jcfg)
        cache = {"c_kv": torch.from_numpy(ck.copy()),
                 "k_rope": torch.from_numpy(cr.copy())}
        ty, got = TATT.mla_decode_step(tp, torch.from_numpy(x1), cache,
                                       torch.tensor(pos, dtype=torch.int32),
                                       tcfg)
        assert got is cache
        AP.close(ty, jy, AP.DECODE_RTOL, err_msg=f"pos {pos}")
        for k in ("c_kv", "k_rope"):
            AP.close(cache[k], jc[k], AP.DECODE_RTOL, err_msg=k)


def test_loss_and_gradients_match_jax():
    AP.check_loss_and_grads(ARCH, batch=2, seq=12, seed=3)


def test_prefill_matches_jax():
    AP.check_prefill(ARCH, batch=2, seq=12, seed=4)


def test_decode_matches_jax_and_the_forward():
    AP.check_decode(ARCH, batch=2, steps=10, seed=5)


def test_floa_train_step_matches_jax():
    AP.check_train_step(ARCH, batch=2, seq=12, seed=6)


def test_greedy_serve_matches_jax_loop():
    AP.check_serve(ARCH, batch=2, prompt_len=6, gen=6)


def test_long_500k_decodes_over_the_full_latent_cache():
    """long_500k keeps MLA unwindowed: `make_decode_step(cfg, "long_500k")`
    has no window and `init_caches` builds 524 288 latent slots a layer
    (the full config on "meta": 604 MB a layer in bf16).  On a 1-layer cut
    of the smoke config, a cache filled with random latents, one step at
    pos 524 287 against the JAX step on the same cache."""
    full = get_config(ARCH)
    _, meta = TSTEPS.make_decode_step(full, "long_500k")
    assert meta["window"] is None
    c = TT.init_caches(full, 1, LONG, window=meta["window"], device="meta")
    ck = c["blocks"]["b0"]["c_kv"]
    assert ck.shape == (60, 1, LONG, 512)
    assert c["blocks"]["b0"]["k_rope"].shape == (60, 1, LONG, 64)
    assert (ck[0].numel() + 64 * LONG) * 2 == 603979776
    jcfg, tcfg, jparams, tparams = AP.setup(ARCH, 1)
    step, meta = TSTEPS.make_decode_step(tcfg, "long_500k")
    caches = TT.init_caches(tcfg, 1, LONG, window=meta["window"],
                            device="cpu")
    for i, x in enumerate(caches["blocks"]["b0"].values()):
        x.copy_(torch.from_numpy(_rng(i, *x.shape)) * 0.5)
    jcaches = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()),
                                     caches)
    tok = np.array([[7]], np.int32)
    jl, _ = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))(
        jparams, jcaches, jnp.asarray(tok), jnp.int32(LONG - 1))
    tl, _ = step(tparams, caches, torch.from_numpy(tok), LONG - 1)
    AP.close(tl, jl, AP.DECODE_RTOL)
    assert JSTEPS.decode_window(jcfg, "long_500k") is None

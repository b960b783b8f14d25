"""The int8 KV cache (kv_cache_dtype="int8") on the port against the JAX
package: the quantizer and dequantizer bitwise against
`repro/models/attention.py`'s `_quantize_kv` / `_dequantize_kv` (round
half to even included), the int8 decode of the smoke qwen3-4b (full
cache) and recurrentgemma-9b (MQA, the 32-slot local ring past a wrap)
against the JAX int8 decode at rtol 1e-4, and the reference's two
contracts (`tests/test_kv_quant.py`) on the port: the int8 decode stays
close to the exact-cache decode, and the f32 smoke cache takes fewer than
a third of the bytes.  Everything runs on the CPU, through the decode
attention's plain version.
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
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.data import sample_tokens
    from repro.models import attention as JATT
    from repro.models import transformer as JT

import torch_arch_parity as AP

from repro_torch.configs import get_smoke
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths


def _inputs():
    """[B, 1, KV, hd] rows of every kind: seeded normals at three scales,
    an all-zero row (the 1e-8 floor), and a row whose max is 127 exactly
    (scale 1) holding halves, which round to even."""
    g = np.random.default_rng(0)
    x = g.standard_normal((3, 1, 4, 32)).astype(np.float32)
    x[0] *= 1e-3
    x[2] *= 50.0
    x[1, 0, 1] = 0.0
    x[1, 0, 2] = 0.0
    x[1, 0, 2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    return x


def test_quantize_and_dequantize_are_bitwise_the_references():
    x = _inputs()
    jq, js = JATT._quantize_kv(jnp.asarray(x))
    tq, ts = TATT.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tq[1, 0, 2, :6].tolist() == [127, 2, -4, 0, 0, 2]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(JATT._dequantize_kv(jq, js, jdt).astype(
            jnp.float32))
        got = TATT.dequantize_kv(tq, ts, dt).float().numpy()
        assert got.tobytes() == want.tobytes(), dt


def _int8(arch):
    """(JAX cfg, port cfg, JAX params, port params) of arch's smoke
    config with kv_cache_dtype="int8"."""
    jcfg, tcfg, jparams, tparams = AP.setup(arch)
    return (dataclasses.replace(jcfg, kv_cache_dtype="int8"),
            dataclasses.replace(tcfg, kv_cache_dtype="int8"), jparams,
            tparams)


@pytest.mark.parametrize("arch,steps", [("qwen3-4b", 12),
                                        ("recurrentgemma-9b", 40)])
def test_int8_decode_matches_jax(arch, steps):
    """Teacher-forced int8 decode, logits at rtol 1e-4 step by step; the
    cache leaves k / v int8 and their scales f16 in the JAX layout, the
    dequantized cache and the scales at the end at rtol 1e-4."""
    jcfg, tcfg, jparams, tparams = _int8(arch)
    toks = sample_tokens(2, steps, vocab=jcfg.vocab_size, seed=5)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    jcaches = JT.init_caches(jcfg, 2, steps)
    tcaches = TT.init_caches(tcfg, 2, steps, device="cpu")
    assert tree_paths(tcaches) == AP.jpaths(jcaches)
    for g, w in zip(tree_leaves(tcaches), jax.tree_util.tree_leaves(jcaches)):
        assert (tuple(g.shape), g.dtype) == (
            w.shape, {jnp.int8: torch.int8, jnp.float16: torch.float16,
                      jnp.float32: torch.float32}[w.dtype.type])
    for i in range(steps):
        j, jcaches = jstep(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(i))
        t, _ = TT.decode_step(tparams, tcaches, torch.as_tensor(
            toks[:, i:i + 1]), i, tcfg)
        AP.close(t, j, AP.DECODE_RTOL, err_msg=f"step {i}")
    tflat = dict(zip(tree_paths(tcaches), tree_leaves(tcaches)))
    jflat = dict(zip(AP.jpaths(jcaches), jax.tree_util.tree_leaves(jcaches)))
    for path in tflat:
        if path.endswith("/k") or path.endswith("/v"):
            got = TATT.dequantize_kv(tflat[path], tflat[path + "_scale"],
                                     torch.float32)
            want = JATT._dequantize_kv(jflat[path], jflat[path + "_scale"],
                                       jnp.float32)
            AP.close(got, want, AP.DECODE_RTOL, err_msg=path)
        elif path.endswith("_scale"):
            AP.close(tflat[path], jflat[path], AP.DECODE_RTOL, err_msg=path)


def _run(cfg, params, toks):
    caches = TT.init_caches(cfg, toks.shape[0], toks.shape[1], device="cpu")
    return torch.stack([TT.decode_step(
        params, caches, toks[:, i:i + 1], i, cfg)[0][:, 0]
        for i in range(toks.shape[1])], dim=1)


def test_int8_decode_close_to_exact():
    """The reference's contract on the port's own decode: over 24 steps
    the int8 cache's logits stand within 0.05 of the largest |logit| of
    the exact cache's, and the greedy argmax agrees on more than 90 % of
    the positions."""
    _, tcfg, _, tparams = AP.setup("qwen3-4b")
    cfg_q = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    toks = torch.as_tensor(np.array(jax.random.randint(
        jax.random.PRNGKey(0), (2, 24), 0, tcfg.vocab_size)))
    exact, quant = _run(tcfg, tparams, toks), _run(cfg_q, tparams, toks)
    rel = float((quant - exact).abs().max() / (exact.abs().max() + 1e-9))
    assert rel < 0.05, rel
    agree = float((quant.argmax(-1) == exact.argmax(-1)).float().mean())
    assert agree > 0.9, agree


@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-9b"])
def test_int8_cache_is_under_a_third_of_the_bytes(arch):
    """int8 values and f16 scales against the f32 smoke cache: under a
    third of its bytes (the reference's qwen3-4b contract; on the hybrid
    the RG-LRU state ignores the flag, so it is left out of both sides and
    the attention caches alone are compared)."""
    cfg = get_smoke(arch)
    cfg_q = dataclasses.replace(cfg, kv_cache_dtype="int8")

    def nbytes(c):
        return sum(x.numel() * x.element_size()
                   for p, x in zip(tree_paths(c), tree_leaves(c))
                   if "/conv" not in p and not p.endswith("/h"))

    c0 = TT.init_caches(cfg, 2, 64, device="meta")
    c1 = TT.init_caches(cfg_q, 2, 64, device="meta")
    assert nbytes(c1) < nbytes(c0) / 3

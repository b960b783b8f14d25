"""seamless-m4t-large-v2, the encoder-decoder, on the port against the JAX
package, at the reference's smoke config (f32, 2 encoder + 2 decoder
layers, d 128, 4 heads of 32, frames of 64 features).

The tree against `init_encdec`; `encode`, `decode_hidden`, `decode_full`,
the loss and its gradient; `precompute_cross_kv`; 16 `decode_step`s
against the JAX step's (logits, caches) and against `decode_full`; the
one-token cross-attention (`attention.cross_decode`, plain route: the
kernel's plain version on the CPU) against the reference's
`cross_attention`; the FLOA train step, the prefill step and the decode
step of `launch.steps` against the JAX steps; `shape_applicable`.
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
    from repro.configs import registry as JR
    from repro.launch import steps as JSTEPS
    from repro.launch.mesh import make_debug_mesh
    from repro.models import attention as JATT
    from repro.models import encdec as JED

import torch_arch_parity as AP

from repro_torch.configs import INPUT_SHAPES, get_config, shape_applicable
from repro_torch.kernels import ops
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import attention as TATT
from repro_torch.models import encdec as TED
from repro_torch.tree import tree_leaves, tree_paths

ARCH = "seamless-m4t-large-v2"
FRAMES, DEC = 20, 16         # encoder frames, decoder tokens


def _frames(batch, seed, n=FRAMES):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, 64)).astype(np.float32)


def _tokens(cfg, batch, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, n))


def _jp(jparams):
    return jax.tree_util.tree_map(jnp.asarray, jparams)


def test_param_tree_paths_and_order_equal_jax():
    want = AP.check_tree(ARCH)
    assert sorted({p.split("/")[0] for p, _, _ in want}) == [
        "dec_blocks", "dec_norm", "embed", "enc_blocks", "enc_in",
        "enc_norm", "lm_head"]
    assert {p.split("/", 1)[1].split("/")[0] for p, _, _ in want
            if p.startswith("dec_blocks")} == {
        "ln1", "self_attn", "ln_x", "cross_attn", "ln2", "ffn"}
    assert dict((p, s) for p, s, _ in want)["enc_blocks/attn/wq"] == (
        2, 128, 4, 32)
    assert TSTEPS.param_count(get_config(ARCH)) == 1_280_899_072


def test_encoder_decoder_forward_matches_jax():
    """encode (bidirectional), decode_hidden and decode_full."""
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    jp = _jp(jparams)
    fr, toks = _frames(2, 0), _tokens(tcfg, 2, DEC, 1)
    jenc = JED.encode(jp, jnp.asarray(fr), jcfg)
    tenc = TED.encode(tp, torch.as_tensor(fr), tcfg)
    AP.close(tenc, jenc)
    AP.close(TED.decode_hidden(tp, torch.as_tensor(toks), tenc, tcfg),
             JED.decode_hidden(jp, jnp.asarray(toks), jenc, jcfg))
    AP.close(TED.decode_full(tp, torch.as_tensor(toks), tenc, tcfg),
             JED.decode_full(jp, jnp.asarray(toks), jenc, jcfg))
    # the encoder attends both ways: a late frame moves the first output
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    assert not torch.allclose(TED.encode(tp, torch.as_tensor(fr2), tcfg)[
        :, 0], tenc[:, 0], atol=1e-4)


def test_loss_and_gradients_match_jax():
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    fr, toks = _frames(2, 2), _tokens(tcfg, 2, DEC + 1, 3)
    bj = {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)}
    bt = {"frames": torch.as_tensor(fr), "tokens": torch.as_tensor(toks)}
    AP.close(TED.encdec_per_example_loss(tp, bt, tcfg),
             JED.encdec_per_example_loss(_jp(jparams), bj, jcfg))
    AP.close(TED.encdec_loss(tp, bt, tcfg),
             JED.encdec_loss(_jp(jparams), bj, jcfg))
    gj = jax.jit(jax.grad(lambda p: JED.encdec_loss(p, bj, jcfg)))(
        _jp(jparams))
    gt = torch.func.grad(lambda p: TED.encdec_loss(p, bt, tcfg))(tp)
    for p, g, w in zip(tree_paths(gt), tree_leaves(gt),
                       jax.tree_util.tree_leaves(gj)):
        assert np.isfinite(np.asarray(w)).all() and np.abs(w).max() > 0, p
        AP.close(g, w, err_msg=p)


def test_precompute_cross_kv_matches_jax():
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    fr = _frames(2, 4)
    jenc = JED.encode(_jp(jparams), jnp.asarray(fr), jcfg)
    want = JED.precompute_cross_kv(_jp(jparams), jenc, jcfg)
    got = TED.precompute_cross_kv(tp, TED.encode(tp, torch.as_tensor(fr),
                                                 tcfg), tcfg)
    for g, w in zip(got, want):
        assert g.shape == (2, 2, FRAMES, 4, 32)
        AP.close(g, w)


def test_cross_decode_matches_jax_cross_attention():
    """One decoder token over all Se encoder positions: the kernel route's
    plain version (pos = Se - 1) against the reference's cross_attention,
    and against the port's full-sequence route.  On the CPU both routes
    run the plain version, which counts no launch."""
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    g = np.random.default_rng(5)
    x1 = g.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    k, v = (g.standard_normal((3, FRAMES, 4, 32)).astype(np.float32)
            for _ in range(2))
    jpc = _jp(jparams)["dec_blocks"]["cross_attn"]
    jpc = jax.tree_util.tree_map(lambda a: a[1], jpc)
    tpc = {n: w[1] for n, w in tp["dec_blocks"]["cross_attn"].items()}
    want = JATT.cross_attention(jpc, jnp.asarray(x1),
                                (jnp.asarray(k), jnp.asarray(v)), jcfg)
    ops.reset_launches()
    kv = (torch.as_tensor(k), torch.as_tensor(v))
    got = TATT.cross_decode(tpc, torch.as_tensor(x1), kv, tcfg, plain=True)
    AP.close(got, want, AP.DECODE_RTOL)
    AP.close(TATT.cross_decode(tpc, torch.as_tensor(x1), kv, tcfg), want,
             AP.DECODE_RTOL)
    AP.close(TATT.cross_attention(tpc, torch.as_tensor(x1), kv, tcfg),
             want)
    assert ops.launch_counts()["decode_attention"] == 0


def test_decode_steps_match_jax_and_decode_full():
    """16 teacher-forced steps against the JAX step (logits, and the caches
    at the end), and against decode_full on the same tokens in each
    package; the caches written in place."""
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    jp = _jp(jparams)
    fr, toks = _frames(2, 6), _tokens(tcfg, 2, DEC, 7)
    jenc = JED.encode(jp, jnp.asarray(fr), jcfg)
    jkv = JED.precompute_cross_kv(jp, jenc, jcfg)
    tenc = TED.encode(tp, torch.as_tensor(fr), tcfg)
    tkv = TED.precompute_cross_kv(tp, tenc, tcfg)
    jstep = jax.jit(functools.partial(JED.decode_step, cfg=jcfg))
    jc = JED.init_dec_caches(jcfg, 2, DEC)
    tc = TED.init_dec_caches(tcfg, 2, DEC, device="cpu")
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    assert tc["k"].shape == (2, 2, DEC, 4, 32)
    tl = []
    for i in range(DEC):
        j, jc = jstep(jp, jc, jkv, jnp.asarray(toks[:, i:i + 1]),
                      jnp.int32(i))
        t, got = TED.decode_step(tp, tc, tkv, torch.as_tensor(
            toks[:, i:i + 1]), torch.tensor(i, dtype=torch.int32), tcfg)
        assert got is tc
        AP.close(t, j, AP.DECODE_RTOL, err_msg=f"step {i}")
        tl.append(t[:, 0])
    for n in ("k", "v"):
        AP.close(tc[n], jc[n], AP.DECODE_RTOL, err_msg=n)
    AP.close(torch.stack(tl, dim=1), TED.decode_full(
        tp, torch.as_tensor(toks), tenc, tcfg), AP.DECODE_RTOL)


def test_floa_train_step_matches_jax():
    AP.check_train_step(ARCH, batch=2, seq=DEC, seed=8,
                        extra={"frames": _frames(2, 8)})


def test_prefill_matches_jax():
    AP.check_prefill(ARCH, batch=2, seq=DEC, seed=9,
                     extra={"frames": _frames(2, 9)})


def test_decode_step_of_the_steps_matches_jax():
    """`make_decode_step` takes the cross K / V as the reference's does
    (`make_cross_kv_step` encodes them); 8 steps of both."""
    jcfg, tcfg, jparams, tp = AP.setup(ARCH)
    b, n = 2, 8
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    art = JSTEPS.make_decode_step(jcfg, mesh, dict(global_batch=b,
                                                   seq_len=n), "decode_32k")
    fr, toks = _frames(b, 10), _tokens(tcfg, b, n, 11)
    jp = _jp(jparams)
    jkv = JED.precompute_cross_kv(jp, JED.encode(jp, jnp.asarray(fr), jcfg),
                                  jcfg)
    kv_step, _ = TSTEPS.make_cross_kv_step(tcfg)
    tkv = kv_step(tp, torch.as_tensor(fr))
    for g, w in zip(tkv, jkv):
        AP.close(g, w)
    step, meta = TSTEPS.make_decode_step(tcfg)
    assert meta == {"dim": art.meta["dim"], "window": None}
    jc, tc = JED.init_dec_caches(jcfg, b, n), TED.init_dec_caches(
        tcfg, b, n, device="cpu")
    with mesh:
        fn = jax.jit(art.fn)
        for i in range(n):
            j, jc = fn(jp, jc, jkv, jnp.asarray(toks[:, i:i + 1]),
                       jnp.int32(i))
            t, tc = step(tp, tc, tkv, torch.as_tensor(toks[:, i:i + 1]), i)
            AP.close(t, j, AP.DECODE_RTOL, err_msg=f"step {i}")


def test_shape_applicable_skips_long_500k():
    """As the reference's: seamless skips long_500k, and runs the other
    shapes; every other arch runs long_500k."""
    cfg = get_config(ARCH)
    assert not shape_applicable(cfg, "long_500k")
    for name in INPUT_SHAPES:
        assert shape_applicable(cfg, name) == JR.shape_applicable(
            JR.get_config(ARCH), name)
    for arch in JR.ARCH_IDS:
        if arch != ARCH:
            assert shape_applicable(get_config(arch), "long_500k"), arch
    with pytest.raises(ValueError, match="encoder-decoder"):
        from repro_torch.launch.serve import serve
        serve(cfg, 1, 1, 1, device="cpu")

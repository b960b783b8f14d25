"""The port's LM training forward (`repro_torch.models`, `configs`,
`repro_torch.tree`) against the JAX package.

Two small configs of the qwen3 family, f32: `test_models_smoke.py`'s toy
LM (vocab 64, padded to 256: the CE masks 192 padding columns) and
`test_lm_lane.py`'s tiny lane config (D = 69 856), with the weights of JAX
`init_lm(PRNGKey(0))` carried across by `transformer.params_from_jax`.
Held at rtol 1e-5: `forward`, `lm_per_example_loss`, `lm_loss`,
`chunked_ce` (also with `lm_head_chunk` slices and a remainder) and
`gqa_full` / `_chunked_attn` (also over query chunks, causal and
windowed); the gradient of `lm_loss` (`torch.func.grad` against
`jax.grad`) at rtol 1e-4.  The port's flat row of a nested tree equals the
JAX `flatten_worker_grads` row exactly, and `flat_param_dim(lm_sweep())`
is the JAX package's 2 950 528.
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
    from repro.core import aggregation as JAGG
    from repro.data import text as JTX
    from repro.models import attention as JATT
    from repro.models import common as JC
    from repro.models import transformer as JT

from repro_torch import tree as TREE
from repro_torch.configs import registry as TR
from repro_torch.core import aggregation as TAGG
from repro_torch.fl import sweep as TS
from repro_torch.models import attention as TATT
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT

RTOL = 1e-5
GRAD_RTOL = 1e-4
LM_SWEEP_D = 2_950_528
# The LM's flat row, in the JAX package's leaf order (keys sorted at
# every level).
LM_ROW_ORDER = [
    "blocks/b0/attn/k_norm", "blocks/b0/attn/q_norm", "blocks/b0/attn/wk",
    "blocks/b0/attn/wo", "blocks/b0/attn/wq", "blocks/b0/attn/wv",
    "blocks/b0/ffn/wg", "blocks/b0/ffn/wi", "blocks/b0/ffn/wo",
    "blocks/b0/ln1", "blocks/b0/ln2", "embed", "final_norm", "lm_head"]

CONFIGS = {
    # test_models_smoke.py::_toy_lm_cfg
    "toy": dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                d_ff=64, vocab_size=64),
    # test_lm_lane.py::tiny_lm_cfg
    "tiny": dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab_size=256),
    # two layers, and the CE in lm_head_chunk slices of 16 with a remainder
    "chunked_ce": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                       head_dim=8, d_ff=64, vocab_size=100, lm_head_chunk=16),
}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX cfg, port cfg, JAX params, port params) of one config."""
    kw = CONFIGS[name]
    jcfg = dataclasses.replace(JR.get_lm_sweep(), **kw)
    tcfg = dataclasses.replace(TR.get_lm_sweep(), **kw)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TT.params_from_jax(jparams, "cpu")


def _jit(fn):
    """fn jitted with its config static."""
    return jax.jit(fn, static_argnames="cfg")


def _tokens(cfg, b, s, seed=0):
    return JTX.sample_tokens(b, s, cfg.vocab_size, seed=seed)


def _close(got, want, rtol=RTOL):
    """rtol, with an atol of rtol times the largest |want|: entries near
    zero (logits, activations) carry the rounding of values of the
    tensor's own scale."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_losses_match_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(jcfg, 3, 41)
    batch_j, batch_t = {"tokens": toks}, {"tokens": torch.as_tensor(toks)}
    lj, _ = _jit(JT.forward)(jp, toks[:, :-1], jcfg)
    lt, aux = TT.forward(tp, batch_t["tokens"][:, :-1], tcfg)
    assert lt.shape == (3, 40, tcfg.padded_vocab) and float(aux) == 0.0
    _close(lt, lj)
    pj, _ = _jit(JT.lm_per_example_loss)(jp, batch_j, jcfg)
    pt, _ = TT.lm_per_example_loss(tp, batch_t, tcfg)
    _close(pt, pj)
    _close(TT.lm_loss(tp, batch_t, tcfg), _jit(JT.lm_loss)(jp, batch_j, jcfg))
    hj, _ = _jit(JT.hidden_for_batch)(jp, toks[:, :-1], jcfg)
    ht, _ = TT.hidden_for_batch(tp, batch_t["tokens"][:, :-1], tcfg)
    _close(ht, hj)
    labels = toks[:, 1:]
    _close(TT.chunked_ce(tp, ht, torch.as_tensor(labels), tcfg),
           _jit(JT.chunked_ce)(jp, jnp.asarray(np.asarray(hj)), labels,
                               jcfg))


def test_forward_over_query_chunks_matches_jax():
    """S = 2048 > Q_CHUNK = 1024: two query chunks, the second's causal
    mask offset by 1024."""
    jcfg, tcfg, jp, tp = _model("toy")
    toks = _tokens(jcfg, 1, 2048, seed=3)
    lj, _ = _jit(JT.forward)(jp, toks, jcfg)
    lt, _ = TT.forward(tp, torch.as_tensor(toks), tcfg)
    _close(lt, lj)


@pytest.mark.parametrize("causal,window,q_chunk",
                         [(True, None, 16), (True, 24, 16), (False, None, 16),
                          (True, None, 1024)])
def test_chunked_attention_matches_jax(causal, window, q_chunk):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 64, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
    want = JATT._chunked_attn(q, k, v, causal, window, q_chunk=q_chunk)
    got = TATT._chunked_attn(*map(torch.as_tensor, (q, k, v)), causal,
                             window, q_chunk=q_chunk)
    _close(got, want)


def test_gqa_full_matches_jax():
    jcfg, tcfg, jp, tp = _model("tiny")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 30, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(30), (2, 30)).copy()
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["b0"]["attn"])
    pt = TREE.tree_map(lambda a: a[0], tp["blocks"]["b0"]["attn"])
    for window in (None, 7):
        _close(TATT.gqa_full(pt, torch.as_tensor(x), tcfg,
                             torch.as_tensor(pos), window=window),
               JATT.gqa_full(pj, x, jcfg, pos, window=window))


def test_softmax_xent_and_causal_mask_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 5, 256)).astype(np.float32) * 4
    labels = rng.integers(0, 60, (3, 5))
    _close(TC.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                           60), JC.softmax_xent(logits, labels, 60))
    for sq, sk, off, window in [(4, 9, 5, None), (6, 6, 0, 3), (3, 12, 8, 2)]:
        assert np.array_equal(
            TC.make_causal_mask(sq, sk, off, window).numpy(),
            np.asarray(JC.make_causal_mask(sq, sk, off, window)))


@pytest.mark.parametrize("name", ["toy", "tiny"])
def test_lm_loss_grad_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(jcfg, 4, 33, seed=1)
    gj = jax.jit(jax.grad(lambda p: JT.lm_loss(p, {"tokens": toks},
                                               jcfg)))(jp)
    gt = torch.func.grad(lambda p: TT.lm_loss(
        p, {"tokens": torch.as_tensor(toks)}, tcfg))(tp)
    paths = TREE.tree_paths(gt)
    for path, g, w in zip(paths, TREE.tree_leaves(gt),
                          jax.tree_util.tree_leaves(gj)):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale, err_msg=path)


def test_flat_row_is_the_jax_row():
    """The tree helper's leaf order is jax.tree_util's at every level, so
    the port's flat rows (flatten_worker_grads, make_row_unflatten) are the
    JAX package's rows byte for byte."""
    jcfg, tcfg, jp, tp = _model("tiny")
    assert TREE.tree_paths(tp) == LM_ROW_ORDER
    jrows = jax.tree_util.tree_map(lambda a: np.stack([a, 2 * a]), jp)
    trows = TREE.tree_map(lambda a: torch.stack([a, 2 * a]), tp)
    want, _ = JAGG.flatten_worker_grads(jrows, batch_dims=1)
    got, unflatten = TAGG.flatten_worker_grads(trows, batch_dims=1)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    back = unflatten(got[1])
    assert all(torch.equal(a, 2 * b) for a, b in
               zip(TREE.tree_leaves(back), TREE.tree_leaves(tp)))
    unflatten_row, sizes = TS.make_row_unflatten(tp)
    assert sum(sizes) == got.shape[1] == TR.flat_param_dim(tcfg)
    views = unflatten_row(got[0])
    assert TREE.tree_paths(views) == LM_ROW_ORDER
    assert all(torch.equal(a, b) for a, b in
               zip(TREE.tree_leaves(views), TREE.tree_leaves(tp)))


def test_tree_helpers_round_trip():
    tree = {"z": {"b": 1, "a": {"y": 2, "x": 3}}, "c": 4}
    leaves, treedef = TREE.tree_flatten(tree)
    assert leaves == [4, 3, 2, 1]
    assert TREE.tree_paths(tree) == ["c", "z/a/x", "z/a/y", "z/b"]
    assert TREE.tree_unflatten(treedef, leaves) == tree
    assert TREE.tree_map(lambda a, b: a + b, tree, tree) == \
        TREE.tree_unflatten(treedef, [8, 6, 4, 2])
    assert leaves == jax.tree_util.tree_leaves(tree)
    with pytest.raises(ValueError):
        TREE.tree_unflatten(treedef, leaves + [5])
    with pytest.raises(ValueError):
        TREE.tree_map(lambda a, b: a, tree, {"c": 1})


def test_lm_sweep_config_and_flat_dim_match_jax():
    jcfg, tcfg = JR.get_lm_sweep(), TR.get_lm_sweep()
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            want = {jnp.float32: torch.float32}[want]
        assert got == want, f.name
    assert TR.flat_param_dim(tcfg) == JR.flat_param_dim(jcfg) == LM_SWEEP_D


def test_prefix_embeddings_raise():
    """A prefix on a config without a frontend (no projector) raises; the
    VLM prefix is held against JAX in tests/test_torch_vlm.py."""
    _, tcfg, _, tp = _model("toy")
    toks = torch.zeros((1, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="no frontend"):
        TT.forward(tp, toks, tcfg, embeds_prefix=torch.zeros((1, 2, 8)))

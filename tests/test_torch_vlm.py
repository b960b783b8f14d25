"""llava-next-mistral-7b, the VLM, on the port against the JAX package, at
the reference's smoke config (f32, 2 layers, d 256, 8 heads against 2 KV
heads, window 64, a 16-position prefix of 64 features).

The projector and `hidden_for_batch` with a prefix (b1 / b2 made nonzero
on the JAX side before the weights are carried across, so every term of
the projector counts); the tanh GELU; the loss and its gradient; the
FLOA train step and the prefill step against the JAX steps; decode
across the 64-slot ring's wrap (the text tokens alone, as the reference
serves them) and the greedy serve; `batch_shapes` against the reference's
for the VLM and the encoder-decoder at every input shape.  rtol 1e-5,
decode 1e-4.  Everything runs on the CPU.
"""
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
    from repro.models import transformer as JT

import torch_arch_parity as AP

from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

ARCH = "llava-next-mistral-7b"
N_PREFIX, TEXT = 16, 12     # the smoke prefix, text positions a row


def _prefix(batch, seed, n=N_PREFIX):
    return {"embeds_prefix": np.random.default_rng(seed).standard_normal(
        (batch, n, 64)).astype(np.float32)}


def _biased():
    """(JAX cfg, port cfg, JAX params, port params) with b1 / b2 seeded
    nonzero on the JAX side, then carried across."""
    jcfg, tcfg, jparams, _ = AP.setup(ARCH)
    g = np.random.default_rng(11)
    jp = jax.tree_util.tree_map(np.array, jparams)
    for k in ("b1", "b2"):
        jp["projector"][k] = (0.3 * g.standard_normal(
            jp["projector"][k].shape)).astype(np.float32)
    return jcfg, tcfg, jp, TT.params_from_jax(jp, "cpu")


def test_param_tree_paths_and_order_equal_jax():
    want = AP.check_tree(ARCH)
    assert [(p, s) for p, s, _ in want if p.startswith("projector")] == [
        ("projector/b1", (256,)), ("projector/b2", (256,)),
        ("projector/w1", (64, 256)), ("projector/w2", (256, 256))]
    full = TSTEPS.init_model(get_config(ARCH), None, "meta")
    assert full["projector"]["w1"].shape == (1024, 4096)
    assert TSTEPS.param_count(get_config(ARCH)) == 7_262_711_808


def test_projector_and_hidden_with_a_prefix_match_jax():
    """`project_prefix` against the reference's projector (the tanh GELU
    between w1 and w2), then the hidden states of the token region after
    the projected prefix, and the prefix itself moving them."""
    jcfg, tcfg, jp, tp = _biased()
    x = _prefix(2, 0)["embeds_prefix"]
    pr = {k: jnp.asarray(v) for k, v in jp["projector"].items()}
    e = jnp.einsum("bpf,fd->bpd", jnp.asarray(x), pr["w1"]) + pr["b1"]
    want = jnp.einsum("bpd,de->bpe", jax.nn.gelu(e), pr["w2"]) + pr["b2"]
    AP.close(TT.project_prefix(tp, torch.as_tensor(x), tcfg), want)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, TEXT))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jh, _ = JT.hidden_for_batch(jparams, jnp.asarray(toks), jcfg,
                                embeds_prefix=jnp.asarray(x))
    th, _ = TT.hidden_for_batch(tp, torch.as_tensor(toks), tcfg,
                                embeds_prefix=torch.as_tensor(x))
    assert th.shape == (2, TEXT, tcfg.d_model)
    AP.close(th, jh)
    bare, _ = TT.hidden_for_batch(tp, torch.as_tensor(toks), tcfg)
    assert not torch.allclose(bare, th, atol=1e-3)
    # a bf16 prefix (the dtype of `batch_shapes`) is cast to cfg.dtype
    xb = torch.as_tensor(x).bfloat16()
    AP.close(TT.project_prefix(tp, xb, tcfg),
             TT.project_prefix(tp, xb.float(), tcfg))


def test_loss_and_gradients_match_jax():
    """The per-example loss over the token region and the gradient of
    every leaf, the projector's included."""
    AP.check_loss_and_grads(ARCH, batch=2, seq=TEXT, seed=3,
                            extra=_prefix(2, 3))
    _, tcfg, _, tp = AP.setup(ARCH)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, TEXT + 1)))
    g = torch.func.grad(lambda p: TT.lm_loss(p, {
        "tokens": toks, "embeds_prefix": torch.as_tensor(
            _prefix(2, 3)["embeds_prefix"])}, tcfg))(tp)
    assert all(float(x.abs().max()) > 0 for x in g["projector"].values())


def test_floa_train_step_matches_jax():
    AP.check_train_step(ARCH, batch=2, seq=TEXT, seed=6,
                        extra=_prefix(2, 6), shape_seq=N_PREFIX + TEXT)


def test_prefill_matches_jax():
    AP.check_prefill(ARCH, batch=2, seq=TEXT, seed=4, extra=_prefix(2, 4),
                     shape_seq=N_PREFIX + TEXT)


def test_decode_matches_jax_past_the_ring():
    """72 teacher-forced text steps into the 64-slot ring (the native
    window), against the JAX step and the forward, at 1e-4."""
    AP.check_decode(ARCH, batch=2, steps=72, seed=5)


def test_greedy_serve_matches_jax_loop():
    AP.check_serve(ARCH, batch=2, prompt_len=6, gen=6)


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_batch_shapes_equal_the_reference(arch):
    """Every input of every input shape, train and prefill, full and
    smoke: the shapes and dtypes of the reference's `batch_shapes` (the
    prefix and frames bf16 whatever the config's dtype)."""
    dt = {jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int32}
    for full in (False, True):
        jcfg = JR.get_config(arch) if full else JR.get_smoke(arch)
        tcfg = get_config(arch) if full else get_smoke(arch)
        for name, shape in INPUT_SHAPES.items():
            for kind in ("train", "prefill", shape["kind"]):
                want = JSTEPS.batch_shapes(jcfg, shape, kind)
                got = TSTEPS.batch_shapes(tcfg, shape, kind)
                assert got == {k: (tuple(v.shape), dt[v.dtype.type])
                               for k, v in want.items()}, (name, kind)
    with pytest.raises(ValueError, match="no text positions"):
        TSTEPS.batch_shapes(get_smoke(ARCH), dict(global_batch=2,
                                                  seq_len=N_PREFIX), "train")


def test_prefix_rows_split_over_workers():
    """`WorkerAxes.every(2)`: the train step splits the prefix rows with
    the tokens, each worker's loss its own rows' (the one-process twin of
    a (2, 1) mesh; tests/test_torch_lm_tp_frontends.py runs seamless's on
    ranks)."""
    from repro_torch.launch.mesh import WorkerAxes
    _, tcfg, _, tp = AP.setup(ARCH)
    shape = dict(global_batch=4, seq_len=N_PREFIX + TEXT, kind="train")
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (4, TEXT + 1)))
    batch = {"tokens": toks,
             "embeds_prefix": torch.as_tensor(_prefix(4, 8)["embeds_prefix"])}
    step, meta = TSTEPS.make_train_step(tcfg, WorkerAxes.every(2), shape,
                                        use_floa=False)
    _, _, m = step(tp, TSTEPS.init_floa_state(), batch, 0)
    per_ex, _ = TT.lm_per_example_loss(tp, batch, tcfg)
    AP.close(m["loss"], per_ex.mean())
    assert meta["batch"]["embeds_prefix"][0] == (4, N_PREFIX, 64)
    assert tree_paths(tp) == tree_paths(TSTEPS.init_model(tcfg, None,
                                                          "meta"))
    assert len(tree_leaves(tp)) == len(tree_leaves(meta["params_specs"]))

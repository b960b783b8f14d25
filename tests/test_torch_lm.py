"""The port's serving path (`repro_torch.models`, `configs`, `data.text`,
`launch`) against the JAX package.

The qwen3-4b smoke config (f32, 2 layers) with the weights of JAX
`init_lm(PRNGKey(0))`, carried across by `transformer.params_from_jax`:
one attention decode step at several positions, 16 teacher-forced model
decode steps (logits and caches), and the greedy tokens of `serve` against
the JAX serving loop.  Also the numerics (RMS norm, RoPE, SwiGLU), the
token streams, the configs and the parameter count at full width, and the
parts that are not ported raising.  Everything runs on the CPU, where the
attention takes the kernel's plain version.
"""
import dataclasses
import functools
import sys
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
    from repro.data import text as JTX
    from repro.models import attention as JATT
    from repro.models import common as JC
    from repro.models import ffn as JFFN
    from repro.models import transformer as JT

from torch_arch_parity import jax_serve

from repro_torch.configs import get_config, get_smoke, registry as TR
from repro_torch.data import text as TTX
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as TS
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import attention as TATT
from repro_torch.models import common as TC
from repro_torch.models import ffn as TFFN
from repro_torch.models import transformer as TT

ARCH = "qwen3-4b"
RTOL, ATOL = 1e-4, 1e-5      # f32 model steps, port vs JAX
# XLA-only execution knobs of the JAX config that the port leaves out
JAX_ONLY_FIELDS = {"model_parallel", "remat", "scan_layers",
                   "unroll_for_analysis"}
FULL_PARAMS = 4_412_079_616   # qwen3-4b at full width


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def _smoke():
    """(JAX cfg, port cfg, JAX params, port params) of the smoke config."""
    jcfg, tcfg = JR.get_smoke(ARCH), get_smoke(ARCH)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, TT.params_from_jax(_np_tree(jparams), "cpu")


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_rms_norm_rope_swiglu_match_jax():
    x, scale = _rng(0, 3, 5, 4, 32), _rng(1, 32) * 0.1
    _close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JC.rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-6, 1e-6)
    pos = np.array([[0, 1, 7, 33, 4095]], np.int32).repeat(3, 0)
    for theta in (1e4, 1e6):
        got = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(got, want, 1e-6, 1e-6)
    # weights at the model's init scale, 1/sqrt(fan_in): the products sum in
    # another order in the two frameworks, so atol is relative to O(1)
    p = {"wi": _rng(2, 32, 48) / 32 ** 0.5, "wg": _rng(3, 32, 48) / 32 ** 0.5,
         "wo": _rng(4, 48, 32) / 48 ** 0.5}
    h = _rng(5, 2, 3, 32)
    _close(TFFN.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(h)),
           JFFN.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(h)), 1e-6, 1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_token_streams_byte_equal(seed):
    for t, j in [(TTX.make_markov_tables(512, seed),
                  JTX.make_markov_tables(512, seed)),
                 (TTX.sample_tokens(4, 24, 512, seed=seed),
                  JTX.sample_tokens(4, 24, 512, seed=seed)),
                 (TTX.stack_token_rounds(2, 3, 8, 300, seed=seed),
                  JTX.stack_token_rounds(2, 3, 8, 300, seed=seed))]:
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


@pytest.mark.parametrize("arch", TR.ARCH_IDS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_fields_equal_jax(arch, variant):
    """Every arch's configs field for field (the MoE, MLA, SSM, encdec and
    frontend sub-configs as dicts), and `shape_applicable` as the
    reference's for every shape; the port registers the reference's ten
    archs."""
    jcfg = JR.get_config(arch) if variant == "full" else JR.get_smoke(arch)
    tcfg = get_config(arch) if variant == "full" else get_smoke(arch)
    tfields = {f.name for f in dataclasses.fields(tcfg)}
    assert {f.name for f in dataclasses.fields(jcfg)} - tfields \
        == JAX_ONLY_FIELDS
    for name in sorted(tfields):
        want = getattr(jcfg, name)
        got = getattr(tcfg, name)
        if name == "dtype":
            want = {jnp.float32: torch.float32,
                    jnp.bfloat16: torch.bfloat16}[want]
        elif name in ("moe", "mla", "ssm", "encdec",
                      "frontend") and want is not None:
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, name
    assert (tcfg.hd, tcfg.padded_vocab) == (jcfg.hd, jcfg.padded_vocab)
    assert TR.INPUT_SHAPES == JR.INPUT_SHAPES
    for shape in JR.INPUT_SHAPES:
        assert TR.shape_applicable(tcfg, shape) == \
            JR.shape_applicable(jcfg, shape), shape
    assert TR.ARCH_IDS == JR.ARCH_IDS


def test_full_width_param_count_on_meta():
    """The full-width model built on the "meta" device (no allocation) has
    the JAX package's tree of shapes and 4 412 079 616 parameters."""
    cfg = get_config(ARCH)
    tparams = TSTEPS.init_model(cfg, None, "meta")
    jshapes, _ = JT.init_lm(jax.random.PRNGKey(0), JR.get_config(ARCH),
                            shape_only=True)
    flat_t = jax.tree_util.tree_leaves_with_path(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(jshapes)
    assert [(p, tuple(x.shape)) for p, x in flat_t] == \
        [(p, tuple(x.shape)) for p, x in flat_j]
    assert all(x.device.type == "meta" and x.dtype == torch.bfloat16
               for _, x in flat_t)
    assert TC.count_params(tparams) == FULL_PARAMS
    assert TSTEPS.param_count(cfg) == FULL_PARAMS
    _, meta = TSTEPS.make_decode_step(cfg)
    assert meta == {"dim": FULL_PARAMS, "window": None}


def test_random_init_statistics():
    """The port's own draws: truncated at 2 sigma, scaled by 1/sqrt(fan_in),
    norm scales zero; one seed gives one set of weights."""
    cfg = get_smoke(ARCH)
    p = TSTEPS.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    wq = p["blocks"]["b0"]["attn"]["wq"]
    assert wq.shape == (2, 256, 8, 32)
    assert float(wq.abs().max()) <= 2.0 / 256 ** 0.5 + 1e-7
    assert abs(float(wq.std()) * 256 ** 0.5 - 0.88) < 0.02
    assert not p["blocks"]["b0"]["ln1"].any()
    p2 = TSTEPS.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p2["lm_head"], p["lm_head"])


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_attention_decode_step_matches_jax(pos):
    jcfg, tcfg, jparams, tparams = _smoke()
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["blocks"]["b0"]["attn"])
    tp = {k: v[0] for k, v in tparams["blocks"]["b0"]["attn"].items()}
    b, s = 2, 16
    x1 = _rng(10 + pos, b, 1, tcfg.d_model)
    ck = _rng(20, b, s, tcfg.n_kv_heads, tcfg.hd)
    cv = _rng(21, b, s, tcfg.n_kv_heads, tcfg.hd)
    jy, jcache = JATT.decode_step(jp, jnp.asarray(x1),
                                  dict(k=jnp.asarray(ck), v=jnp.asarray(cv)),
                                  jnp.int32(pos), jcfg)
    tcache = {"k": torch.from_numpy(ck.copy()),
              "v": torch.from_numpy(cv.copy())}
    ty, tcache2 = TATT.decode_step(tp, torch.from_numpy(x1), tcache, pos,
                                   tcfg)
    assert tcache2 is tcache     # written in place
    _close(ty, jy)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_teacher_forced_decode_matches_jax():
    """16 decode steps fed the same tokens: logits at every step and the
    caches at the end agree at rtol 1e-4 / atol 1e-5."""
    jcfg, tcfg, jparams, tparams = _smoke()
    b, steps = 2, 16
    tokens = TTX.sample_tokens(b, steps, tcfg.vocab_size, seed=5)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))
    jcaches = JT.init_caches(jcfg, b, steps)
    tcaches = TT.init_caches(tcfg, b, steps, device="cpu")
    tops.reset_launches()
    for i in range(steps):
        jl, jcaches = jstep(jparams, jcaches, jnp.asarray(tokens[:, i:i + 1]),
                            jnp.int32(i))
        tl, tcaches = TT.decode_step(tparams, tcaches,
                                     torch.from_numpy(tokens[:, i:i + 1]).long(),
                                     torch.tensor(i, dtype=torch.int32), tcfg)
        assert tl.shape == (b, 1, tcfg.padded_vocab)
        _close(tl, jl)
    for k in ("k", "v"):
        _close(tcaches["blocks"]["b0"][k], jcaches["blocks"]["b0"][k])
    assert tops.launch_counts()["decode_attention"] == 0   # CPU: plain route


def test_greedy_serve_matches_jax_loop():
    jcfg, tcfg, jparams, tparams = _smoke()
    res = TS.serve(tcfg, 2, 8, 8, device="cpu", params=tparams)
    jprompts, jtokens = jax_serve(jcfg, jparams, 2, 8, 8)
    np.testing.assert_array_equal(res.prompts.numpy(), jprompts)
    np.testing.assert_array_equal(res.tokens.numpy(), jtokens)
    assert res.logits.shape == (16, 2, tcfg.padded_vocab)
    assert res.prefill_s > 0 and res.decode_s > 0 and res.tok_per_s > 0


def test_sampled_serve_is_seeded():
    cfg = get_smoke(ARCH)
    a = TS.serve(cfg, 2, 4, 6, device="cpu", temperature=0.8, seed=1)
    b = TS.serve(cfg, 2, 4, 6, device="cpu", temperature=0.8, seed=1)
    assert torch.equal(a.tokens, b.tokens)
    assert a.tokens.shape == (2, 6)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab_size
    # as in the JAX loop, the first generated token is the prompt's argmax
    greedy = TS.serve(cfg, 2, 4, 6, device="cpu", seed=1)
    assert torch.equal(a.tokens[:, 0], greedy.tokens[:, 0])


def test_unported_paths_raise():
    """Every reference arch builds in the port: its full and smoke configs
    and its "meta" parameter tree (`steps.init_model`: the
    encoder-decoder's for seamless-m4t-large-v2, the projector's leaves
    beside the decoder's for llava-next-mistral-7b), with the reference's
    parameter count, and its decode caches; an unknown arch is a
    ValueError.  The int8 cache builds; an unknown block kind or cache
    dtype is a ValueError, as is an encoder-decoder config given to the
    decoder-only model."""
    cfg = get_smoke(ARCH)
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cache = TATT.init_cache(int8, 1, 8, None, torch.float32)
    assert {k: v.dtype for k, v in cache.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float16,
        "v_scale": torch.float16}
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TATT.init_cache(dataclasses.replace(cfg, kv_cache_dtype="fp8"), 1,
                        8, None, torch.float32)
    assert len(TR.ARCH_IDS) == len(JR.ARCH_IDS) == 10
    for arch in JR.ARCH_IDS:
        for c in (get_config(arch), get_smoke(arch)):
            tree = TSTEPS.init_model(c, None, "meta")
            assert all(x.device.type == "meta"
                       for x in jax.tree_util.tree_leaves(tree))
            if c.arch_type == "audio":
                assert sorted(tree) == ["dec_blocks", "dec_norm", "embed",
                                        "enc_blocks", "enc_in", "enc_norm",
                                        "lm_head"]
                continue
            assert ("projector" in tree) == (c.arch_type == "vlm")
            caches = TT.init_caches(c, 1, 8, device="meta")
            assert caches and all(x.device.type == "meta" for x in
                                  jax.tree_util.tree_leaves(caches))
    assert TSTEPS.param_count(get_config("llava-next-mistral-7b")) == \
        JR.flat_param_dim(JR.get_config("llava-next-mistral-7b"))
    assert TSTEPS.param_count(get_config("seamless-m4t-large-v2")) == \
        JR.flat_param_dim(JR.get_config("seamless-m4t-large-v2"))
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="encoder-decoder"):
        TT.init_lm(None, get_smoke("seamless-m4t-large-v2"), "meta")
    rg = TT.init_lm(None, dataclasses.replace(cfg, block_pattern=("rglru",)),
                    "meta")
    assert rg["blocks"]["b0"]["mixer"]["w_a"].shape == (
        cfg.n_layers, cfg.d_model, cfg.d_model)
    with pytest.raises(ValueError, match="unknown block kind"):
        TT.init_lm(None, dataclasses.replace(cfg, block_pattern=("conv",)),
                   "meta")
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        TT.init_lm(None, dataclasses.replace(cfg, block_pattern=("ssm",)),
                   "meta")


def test_serve_entry_point(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve` defaults to the card (raises
    without one), refuses a mesh, and serves the smoke config on the CPU."""
    argv = ["serve", "--arch", ARCH, "--smoke", "--batch", "2",
            "--prompt-len", "4", "--gen", "3"]
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(RuntimeError, match="cuda"):
            TS.main()
    monkeypatch.setattr(sys, "argv", argv + ["--mesh", "single"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TS.main()
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    TS.main()
    assert "arch=qwen3-4b batch=2" in capsys.readouterr().out

"""The port's kernel layer (`repro_torch.kernels`) against the JAX package.

Each plain PyTorch version is held against the JAX oracle and against the
Pallas kernel in interpret mode, on the shape/dtype grids and tolerances of
tests/test_kernels.py, from inputs made with a numpy seed.  On the CPU the
wrappers take the plain route and launch nothing; their input checks are
pinned here too.  The CUDA kernels themselves run only on a card
(tests/test_torch_gpu.py).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.kernels import ops as jops
from repro_torch.kernels import _build, philox, ref
from repro_torch.kernels import ops as tops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py: combine 1e-5 (f32) / 0.15 (bf16).
TOL = {"float32": 1e-5, "bfloat16": 0.15}


def _pair(x: np.ndarray, dtype: str):
    """One f32 numpy array as (jax, torch) arrays of `dtype` (both round
    f32 -> bf16 to nearest even, so the bf16 values are identical)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x.copy()).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _combine_inputs(seed, s, u, d, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa
    w, g, z = _pair(f(s, d), dtype), _pair(f(s, u, d), dtype), \
        _pair(f(s, d), dtype)
    c, bias, eps = _pair(f(s, u), "float32"), _pair(f(s), "float32"), \
        _pair(f(s), "float32")
    alpha = _pair(rng.uniform(0.01, 0.2, s).astype(np.float32), "float32")
    return w, c, g, z, bias, eps, alpha


@pytest.mark.parametrize("u", [4, 10, 32])
@pytest.mark.parametrize("d", [512, 2048, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_floa_aggregate_plain_matches_jax(u, d, dtype):
    _, c, g, z, bias, eps, _ = _combine_inputs(u * d, 1, u, d, dtype)
    got = tops.floa_aggregate(c[1][0], g[1][0], z[1][0], bias[1][0],
                              eps[1][0])
    assert got.dtype == DTYPES[dtype][1] and got.shape == (d,)
    jargs = (c[0][0], g[0][0], z[0][0], bias[0][0], eps[0][0])
    _close(got, jops.floa_aggregate_ref(*jargs), TOL[dtype])
    _close(got, jops.floa_aggregate(*jargs, interpret=True), TOL[dtype])


SUD = [(1, 4, 512), (3, 10, 2048), (4, 8, 5000), (2, 32, 5000)]


@pytest.mark.parametrize("s,u,d", SUD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_floa_aggregate_batched_plain_matches_jax(s, u, d, dtype):
    _, c, g, z, bias, eps, _ = _combine_inputs(s * u + d, s, u, d, dtype)
    got = tops.floa_aggregate_batched(c[1], g[1], z[1], bias[1], eps[1])
    assert got.dtype == DTYPES[dtype][1] and got.shape == (s, d)
    jargs = (c[0], g[0], z[0], bias[0], eps[0])
    _close(got, jops.floa_aggregate_batched_ref(*jargs), TOL[dtype])
    _close(got, jops.floa_aggregate_batched(*jargs, interpret=True),
           TOL[dtype])


@pytest.mark.parametrize("s,u,d", SUD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_floa_step_batched_plain_matches_jax(s, u, d, dtype):
    """The plain version copies the JAX oracle (bf16: gagg rounded before
    the update); the Pallas kernel updates from the f32 aggregate, within
    the bf16 tolerance of both."""
    w, c, g, z, bias, eps, alpha = _combine_inputs(7 * s + u * d, s, u, d,
                                                   dtype)
    wn, gg = tops.floa_step_batched(w[1], c[1], g[1], z[1], bias[1], eps[1],
                                    alpha[1])
    assert wn.dtype == w[1].dtype and gg.dtype == g[1].dtype
    jargs = (w[0], c[0], g[0], z[0], bias[0], eps[0], alpha[0])
    for want in (jops.floa_step_batched_ref(*jargs),
                 jops.floa_step_batched(*jargs, interpret=True)):
        _close(wn, want[0], TOL[dtype])
        _close(gg, want[1], TOL[dtype])


@pytest.mark.parametrize("u", [4, 10, 32])
@pytest.mark.parametrize("d", [512, 2048, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_stats_plain_matches_jax(u, d, dtype):
    """Identical input values on both sides, f32 sums in different orders:
    tests/test_kernels.py's rtol 1e-4 / atol 1e-3 (its routing test)."""
    x = np.random.default_rng(u + d).standard_normal((u, d)).astype(
        np.float32) * 0.7
    jg, tg = _pair(x, dtype)
    got = tops.grad_stats(tg)
    assert got.dtype == torch.float32 and got.shape == (u, 2)
    for want in (jops.grad_stats_ref(jg), jops.grad_stats(jg, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-3)


def test_step_ref_is_combine_plus_update():
    """The fused plain version decomposes exactly into combine + update."""
    w, c, g, z, bias, eps, alpha = (x[1] for x in _combine_inputs(
        11, 3, 6, 777, "float32"))
    wn, gg = ref.floa_step_batched_ref(w, c, g, z, bias, eps, alpha)
    want_g = ref.floa_aggregate_batched_ref(c, g, z, bias, eps)
    assert torch.equal(gg, want_g)
    assert torch.equal(wn, w - alpha[:, None] * want_g)


def test_cpu_route_launches_nothing():
    tops.reset_launches()
    w, c, g, z, bias, eps, alpha = (x[1] for x in _combine_inputs(
        3, 2, 5, 300, "float32"))
    tops.floa_step_batched(w, c, g, z, bias, eps, alpha)
    tops.floa_aggregate_batched(c, g, z, bias, eps)
    tops.floa_aggregate(c[0], g[0], z[0], 0.5, 1.5)
    tops.grad_stats(g[0])
    tops.grad_stats_fixed(g[0][:, 10:200])
    tops.grad_stats_segments(g[0], (100, 200))
    tops.sort_columns(g)
    tops.sort_columns_bitonic(g[0])
    tops.decode_attention(torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32),
                          torch.zeros(1, 8, 2, 32), 3)
    part = philox.Part.whole((6, 10))
    tops.noisy_sgd(torch.zeros(6, 10), torch.zeros(6, 10), torch.zeros(()),
                   torch.ones(()), 0.1, draw=philox.Draw(0, 1, part))
    tops.counter_trunc_normal(torch.empty(6, 10), 0, 1, part, 0.5)
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert set(tops.KERNELS) == {"floa_step_batched", "floa_aggregate",
                                 "floa_aggregate_batched", "grad_stats",
                                 "grad_stats_segments", "sort_columns",
                                 "sort_columns_bitonic", "decode_attention",
                                 "noisy_sgd", "counter_trunc_normal"}


def _bad_inputs():
    s, u, d = 2, 3, 40
    w, c, g, z, bias, eps, alpha = (x[1] for x in _combine_inputs(
        5, s, u, d, "float32"))
    return {
        "grads_not_contiguous": dict(grads=g.transpose(1, 2).contiguous()
                                     .transpose(1, 2)),
        "grads_float64": dict(grads=g.double()),
        "coeffs_bf16": dict(coeffs=c.bfloat16()),
        "coeffs_wrong_u": dict(coeffs=c[:, :2].contiguous()),
        "noise_dtype": dict(noise=z.bfloat16()),
        "noise_short": dict(noise=z[:, :-1].contiguous()),
        "bias_shape": dict(bias=bias[:1].contiguous()),
        "alpha_shape": dict(alpha=alpha[None]),
        "w_shape": dict(w=w[:, :-1].contiguous()),
        "grads_2d": dict(grads=g[0]),
    }, dict(w=w, coeffs=c, grads=g, noise=z, bias=bias, eps=eps, alpha=alpha)


@pytest.mark.parametrize("case", sorted(_bad_inputs()[0]))
def test_step_wrapper_rejects_what_the_kernel_does_not_take(case):
    bad, good = _bad_inputs()
    args = {**good, **bad[case]}
    with pytest.raises(ValueError):
        tops.floa_step_batched(args["w"], args["coeffs"], args["grads"],
                               args["noise"], args["bias"], args["eps"],
                               args["alpha"])


def test_grad_stats_wrapper_rejects_bad_rows():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        tops.grad_stats(x.t())                 # not contiguous
    with pytest.raises(ValueError):
        tops.grad_stats(x.double())            # dtype
    with pytest.raises(ValueError):
        tops.grad_stats(x[None])               # rank


def test_build_targets_cover_every_source_and_need_nvcc(monkeypatch):
    """One library per csrc/*.cu, named by a hash of source and flags; no
    nvcc means a clear error, never a silent fallback."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    names = {_build._target(n).name for n in sources}
    assert len(names) == len(sources)
    assert all(n.endswith(".so") and "-" in n for n in names)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()

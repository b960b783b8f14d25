"""The port's decode-attention kernel layer against the JAX package.

`repro_torch.kernels.ref.decode_attention_ref` is held against the JAX
oracle and against the Pallas kernel in interpret mode, on the shape/dtype
grid and tolerances of tests/test_kernels.py, from inputs made with a numpy
seed.  On the CPU the wrapper takes the plain route and launches nothing;
its input checks and the split-count rule are pinned here too.  The CUDA
kernel itself runs only on a card (tests/test_torch_gpu.py).
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
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops as tops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py: decode attention 2e-4 (f32) / 4e-2 (bf16).
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
# tests/test_kernels.py::test_decode_attention_sweep's grid
GRID = [(1, 4, 1, 64, 512),      # MQA
        (2, 8, 2, 64, 1024),     # GQA
        (2, 8, 8, 128, 777),     # MHA, ragged length
        (1, 16, 4, 128, 2048)]


def _inputs(seed, b, h, kv, dh, s, dtype):
    """(q, k, v) as (jax, torch) pairs of `dtype` from one numpy seed (both
    round f32 -> bf16 to nearest even, so the bf16 values are identical)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for shape in [(b, h, dh), (b, s, kv, dh), (b, s, kv, dh)]:
        x = rng.standard_normal(shape, dtype=np.float32)
        out.append((jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("b,h,kv,dh,s", GRID)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("where", ["end", "start"])
def test_plain_matches_jax_oracle_and_pallas(b, h, kv, dh, s, dtype, where):
    """pos = s - 3 (test_kernels.py's) and pos = 0 (one valid key)."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(b * s + h, b, h, kv, dh, s, dtype)
    pos = s - 3 if where == "end" else 0
    tops.reset_launches()
    got = tops.decode_attention(tq, tk, tv, pos)
    assert got.dtype == tq.dtype and got.shape == (b, h, dh)
    assert tops.launch_counts()["decode_attention"] == 0
    tol = TOL[dtype]
    want = jops.decode_attention_ref(jq, jk, jv, jnp.int32(pos))
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    if where == "end":   # Pallas interpret mode is slow: one pos per shape
        pallas = jops.decode_attention(jq, jk, jv, jnp.int32(pos),
                                       interpret=True)
        np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)


def test_plain_masks_future():
    """Entries beyond pos must not affect the output
    (test_kernels.py::test_decode_attention_masks_future)."""
    (_, q), (_, k), (_, v) = _inputs(0, 1, 4, 2, 32, 256, "float32")
    pos = 100
    out1 = tops.decode_attention(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 101:] = 99.0
    v2[:, 101:] = -99.0
    out2 = tops.decode_attention(q, k2, v2, pos)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


def test_pos_as_device_tensor_matches_int():
    """A 0-d integer tensor (what the decode step passes) and an int give
    the same result; one valid key returns that key's value row."""
    (_, q), (_, k), (_, v) = _inputs(1, 2, 8, 2, 64, 40, "float32")
    for pos in (0, 17, 39):
        want = tops.decode_attention(q, k, v, pos)
        for t in (torch.tensor(pos, dtype=torch.int32), torch.tensor(pos)):
            assert torch.equal(tops.decode_attention(q, k, v, t), want)
    one = tops.decode_attention(q, k, v, 0)
    np.testing.assert_allclose(
        one.numpy(), v[:, 0].repeat_interleave(4, dim=1).numpy(), rtol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k = torch.zeros(2, 8, 64), torch.zeros(2, 16, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        tops.decode_attention(torch.zeros(2, 8, 48), torch.zeros(2, 16, 2, 48),
                              torch.zeros(2, 16, 2, 48), 3)
    with pytest.raises(ValueError, match="multiple of KV"):
        tops.decode_attention(q, torch.zeros(2, 16, 3, 64),
                              torch.zeros(2, 16, 3, 64), 3)
    with pytest.raises(ValueError, match="on meta"):
        tops.decode_attention(q, k.to("meta"), k, 3)
    with pytest.raises(ValueError, match="dtype"):
        tops.decode_attention(q, k.bfloat16(), k, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tops.decode_attention(q, k, k.transpose(1, 2).contiguous()
                              .transpose(1, 2), 3)
    with pytest.raises(ValueError, match="shape"):
        tops.decode_attention(q, k, torch.zeros(2, 15, 2, 64), 3)
    with pytest.raises(ValueError, match="outside the cache"):
        tops.decode_attention(q, k, k, 16)
    with pytest.raises(ValueError, match="scalar"):
        DA._pos_tensor(torch.zeros(2, dtype=torch.int32), q.device)
    with pytest.raises(ValueError, match="integer tensor"):
        DA._pos_tensor(torch.tensor(1.0), q.device)


@pytest.mark.parametrize("blocks,s_len,slots", [
    (64, 32768, 264), (1024, 32768, 264), (64, 64, 264), (64, 512, 264),
    (16, 777, 396), (4096, 32768, 396), (1, 524288, 264)])
def test_num_splits_fills_whole_waves(blocks, s_len, slots):
    """The split count keeps chunks of at least MIN_CHUNK positions and is
    the smallest whose grid fills WAVE_FILL of one wave of resident blocks
    with its last wave WAVE_FILL full; where no count does, the one with
    the fullest waves."""
    n = DA.num_splits(blocks, s_len, slots)
    assert 1 <= n <= DA.MAX_SPLITS
    assert n == 1 or s_len // n >= DA.MIN_CHUNK
    n_max = max(1, min(DA.MAX_SPLITS, s_len // DA.MIN_CHUNK))

    def fill(m):
        grid = blocks * m
        return grid / (-(-grid // slots) * slots)

    def fills(m):
        return blocks * m >= DA.WAVE_FILL * slots and fill(m) >= DA.WAVE_FILL

    if any(fills(m) for m in range(1, n_max + 1)):
        assert fills(n) and not any(fills(m) for m in range(1, n))
    else:
        assert fill(n) == max(fill(m) for m in range(1, n_max + 1))


# (B, S, H, KV) of qwen3-4b's shapes in bf16 at dh = 128, and the split
# count at 264 resident blocks (2 per SM on 132 SMs): the serve cache is
# one pass; the long cache about one wave; decode_32k's 1024 blocks fill
# waves alone.
@pytest.mark.parametrize("b,s_len,want", [(8, 64, 1), (8, 512, 2),
                                          (8, 32768, 4), (128, 32768, 1)])
def test_split_rule_at_the_serving_shapes(b, s_len, want):
    blocks, n = DA.launch_plan(b, 32, 8, s_len, torch.bfloat16, 264)
    assert (blocks, n) == (b * 8, want)


@pytest.mark.parametrize("h,kvh,dtype,groups", [
    (32, 8, torch.bfloat16, 1), (32, 4, torch.bfloat16, 1),
    (12, 2, torch.bfloat16, 1), (48, 4, torch.bfloat16, 2),
    (32, 4, torch.float32, 2), (32, 8, torch.float32, 1),
    (4, 1, torch.bfloat16, 1)])
def test_launch_plan_heads_per_block(h, kvh, dtype, groups):
    """bf16 takes all G <= 8 query heads of a KV head in one block (its
    K/V is read once), f32 up to 4."""
    blocks, _ = DA.launch_plan(2, h, kvh, 4096, dtype, 264)
    assert blocks == 2 * kvh * groups

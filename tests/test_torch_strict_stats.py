"""The strict route's leaf-segment statistics on the CPU.

`kernels/grad_stats.py::grad_stats_segments` sums every leaf segment of
[R, D] rows in one call and folds the pairs in leaf order; under
strict_numerics `core/standardize.py::flat_scalar_stats(flat, sizes)`
calls it once a round.  Here:

  - the work list (`work_list`, the host mirror of the kernel's table)
    covers each segment exactly once and in order, within the kernel's
    limits, as a function of the leaf sizes alone (hypothesis over sizes);
  - the numpy mirror of the kernel's add order (`tests/fixed_order.py`,
    which the card tests hold the kernel to bit for bit) adds every element
    once: exact on integer-valued rows, and near the plain route on normal
    ones;
  - the plain route, which the CPU takes, is bitwise the per-leaf loop
    (one fixed-order call a segment, the pairs added in leaf order) on the
    paper MLP's and the tiny LM's leaves, and agrees with the JAX
    `repro.core.standardize.flat_scalar_stats` at rtol 1e-6 / atol 1e-7
    (tests/test_torch_plan.py's tolerance).

The kernel itself runs only on a card: tests/test_torch_gpu.py.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core.standardize as JSTD

from fixed_order import fixed_order_sums
from hypothesis import given, settings, strategies as st
from repro_torch.configs import get_lm_sweep
from repro_torch.core import standardize as TSTD
from repro_torch.fl.sweep import make_row_unflatten
from repro_torch.kernels import grad_stats as GS
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_lm

MLP_SIZES = (64, 10, 50176, 640)      # the paper MLP's b1 | b2 | w1 | w2
TINY_LM = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
               d_ff=128, vocab_size=256)  # test_torch_lm_lane.py::TINY
RTOL_PORT, ATOL_PORT = 1e-6, 1e-7


def _tiny_lm_sizes():
    cfg = dataclasses.replace(get_lm_sweep(), **TINY_LM)
    return tuple(make_row_unflatten(
        init_lm(torch.Generator().manual_seed(0), cfg, "cpu"))[1])


def _check_work_list(sizes):
    """Segment s's parts sit together, in segment order, and tile its
    elements [off_s, off_s + n_s) in order: PART_ELEMS each but the last,
    ceil(n_s / PART_ELEMS) of them."""
    items = GS.work_list(tuple(sizes))
    assert [s for s, _, _ in items] == sorted(s for s, _, _ in items)
    off, i = 0, 0
    for s, n in enumerate(sizes):
        mine = [it for it in items if it[0] == s]
        assert len(mine) == GS.segment_parts(n) == -(-n // GS.PART_ELEMS)
        pos = off
        for k, (_, start, length) in enumerate(mine):
            assert items[i + k][0] == s and start == pos
            assert 1 <= length <= GS.PART_ELEMS
            assert length == GS.PART_ELEMS or k == len(mine) - 1
            pos += length
        assert pos == off + n
        off, i = off + n, i + len(mine)
    assert i == len(items)
    return items


@settings(max_examples=200)
@given(st.lists(st.integers(1, 3 * GS.PART_ELEMS + 3), min_size=1,
                max_size=40))
def test_work_list_covers_each_segment_once_in_order(sizes):
    """Any leaf sizes: every element of every segment in exactly one part,
    in order, and the call within the kernel's limits at the sweep's
    largest row count (1000)."""
    items = _check_work_list(sizes)
    assert len(items) + len(sizes) <= GS.MAX_FOLD_PAIRS
    assert 1000 * len(items) <= GS.MAX_BLOCKS


@pytest.mark.parametrize("which", ["mlp", "lm", "tiny_lm", "one"])
def test_work_list_at_the_main_path_leaf_sizes(which):
    """The strict sweeps' leaf sizes: the MLP's 10 parts (w1 in 7), the LM
    lane's 365 (a 524 288-entry leaf in 64), within the fold's limit; and
    the kernel's table, which the wrapper uploads, says the same."""
    sizes = {"mlp": MLP_SIZES, "one": (GS.PART_ELEMS + 1,),
             "tiny_lm": _tiny_lm_sizes(),
             "lm": (64, 64, 32768, 131072, 131072, 32768, 524288, 524288,
                    524288, 512, 512, 524288, 256, 524288)}[which]
    items = _check_work_list(sizes)
    want = {"mlp": 10, "lm": 365, "one": 2}.get(which)
    assert want is None or len(items) == want
    table = GS._table(torch.device("cpu"), tuple(sizes)).tolist()
    n = len(items)
    assert table[:n] == [start for _, start, _ in items]
    assert table[n:2 * n] == [length for _, _, length in items]
    first = table[2 * n:]
    assert len(first) == len(sizes) + 1 and first[0] == 0
    assert [b - a for a, b in zip(first, first[1:])] == [
        GS.segment_parts(k) for k in sizes]


@pytest.mark.parametrize("rows", [1, 3, 7])
def test_fixed_order_mirror_sums_what_the_plain_route_sums(rows):
    """The mirror adds each element of each segment once: on integer-valued
    rows every partial sum is exact in float32, so it equals the plain
    route bit for bit; on normal rows (another order) it agrees at rtol
    1e-5."""
    sizes = (5, GS.PART_ELEMS + 7, 300, 1)
    rng = np.random.default_rng(rows)
    ints = rng.integers(-8, 9, (rows, sum(sizes))).astype(np.float32)
    assert np.array_equal(
        fixed_order_sums(ints, sizes),
        ops.grad_stats_segments(torch.from_numpy(ints), sizes)[:, 0].numpy())
    x = (rng.standard_normal((rows, sum(sizes))) * 3 + 0.25).astype(
        np.float32)
    np.testing.assert_allclose(
        fixed_order_sums(x, sizes),
        ops.grad_stats_segments(torch.from_numpy(x), sizes)[:, 0],
        rtol=1e-5, atol=1e-3)


def _per_leaf_loop(rows, sizes):
    """The strict stats as one fixed-order call a leaf segment, the pairs
    added in leaf order from 0 (what flat_scalar_stats ran before the
    segments entry)."""
    off, s1, s2 = 0, 0, 0
    for n in sizes:
        part = ops.grad_stats_fixed(rows[:, off:off + n])
        s1, s2 = s1 + part[:, 0], s2 + part[:, 1]
        off += n
    return s1, s2


@pytest.mark.parametrize("which", ["mlp", "tiny_lm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_route_equals_the_per_leaf_loop(which, dtype):
    """On the CPU one `grad_stats_segments` call is `torch.equal` to the
    per-leaf loop, on the rows of a slab and of a sub-slab; so are the
    strict stats of `flat_scalar_stats`."""
    sizes = MLP_SIZES if which == "mlp" else _tiny_lm_sizes()
    rng = np.random.default_rng(len(sizes))
    flat = torch.from_numpy(
        (rng.standard_normal((3, 4, sum(sizes))) * 0.1).astype(np.float32)
    ).to(dtype)
    rows = flat.reshape(-1, sum(sizes))
    for view in (rows, rows[3:]):
        got = ops.grad_stats_segments(view, sizes)
        s1, s2 = _per_leaf_loop(view, sizes)
        assert got.dtype == torch.float32 and got.shape == (len(view), 2)
        assert torch.equal(got[:, 0], s1) and torch.equal(got[:, 1], s2)
    gbar, eps2 = TSTD.flat_scalar_stats(flat, sizes)
    s1, s2 = _per_leaf_loop(rows, sizes)
    want = TSTD.stats_from_partials(s1, s2, sum(sizes))
    assert torch.equal(gbar.reshape(-1), want[0])
    assert torch.equal(eps2.reshape(-1), want[1])


@pytest.mark.parametrize("which", ["mlp", "tiny_lm"])
def test_segment_stats_match_the_jax_reference(which):
    """flat_scalar_stats(flat, sizes) against the JAX segmented stats."""
    sizes = MLP_SIZES if which == "mlp" else _tiny_lm_sizes()
    rng = np.random.default_rng(7)
    flat = (rng.standard_normal((2, 5, sum(sizes))) * 0.1).astype(np.float32)
    got = TSTD.flat_scalar_stats(torch.from_numpy(flat), sizes)
    want = jax.vmap(lambda g: JSTD.flat_scalar_stats(g, list(sizes)))(
        jnp.asarray(flat))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_PORT,
                                   atol=ATOL_PORT)


def test_segments_entry_refuses_what_the_kernel_cannot_take():
    """Sizes that do not sum to D, an empty leaf, overlapping rows, a
    float64 slab: ValueError before any launch."""
    x = torch.zeros(4, 30)
    with pytest.raises(ValueError, match="leaf sizes sum"):
        ops.grad_stats_segments(x, (10, 10))
    with pytest.raises(ValueError, match=">= 1"):
        ops.grad_stats_segments(x, (30, 0))
    with pytest.raises(ValueError, match="overlap"):
        ops.grad_stats_segments(x.view(-1).as_strided((4, 20), (5, 1)),
                                (20,))
    with pytest.raises(ValueError, match="dtype"):
        ops.grad_stats_segments(x.double(), (30,))

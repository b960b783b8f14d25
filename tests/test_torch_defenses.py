"""The port's digital defenses (`repro_torch.core.defenses`), its sort
kernels' plain versions and its lane partition against the JAX package.

Inputs are made with numpy seeds and handed to both sides.  The JAX side
runs as its own tests run on the CPU, where `sorted_columns` takes
`jnp.sort`; the port's wrappers take their plain versions on CPU tensors
(`torch.sort`), so no kernel launches here (the CUDA kernels are held
against the same plain versions in tests/test_torch_gpu.py).

Tolerances: sorts and medians are exact (a sort is a permutation; the
two-middle average rounds the same on both sides).  The trimmed mean, mean,
Krum and geometric median sum in another order than XLA does: rtol 1e-5,
atol 1e-6.  Blocked vs direct Krum scores: the reference's rtol 2e-4 /
atol 1e-3 (tests/test_defense_sort.py), the expanded distance form rounds
differently.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.core import defenses as JDEF
    from repro.core import scenario as JSC
    from repro.kernels import ops as jops

from repro_torch.core import defenses as TDEF
from repro_torch.core import scenario as TSC
from repro_torch.kernels import defense_sort as TDS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 1e-5, 1e-6


def _slab(seed, *shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.7 + 0.1).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("u", [1, 2, 7, 10, 16, 33, 100])
@pytest.mark.parametrize("d", [1, 130, 2049, 5000])
def test_columnwise_and_gm_defenses_match_jax(u, d):
    """Per lane ([U, D]) and per lane group ([S_g, U, D] with per-lane
    trims): median, trimmed mean, mean, geometric median."""
    x = _slab(u * 10_000 + d, 2, u, d)
    trims = [(u - 1) // 2, (u - 1) // 3]
    tops.reset_launches()
    for i in range(2):
        j, t = jnp.asarray(x[i]), torch.from_numpy(x[i])
        np.testing.assert_array_equal(TDEF.flat_median(t).numpy(),
                                      np.asarray(JDEF.flat_median(j)))
        _close(TDEF.flat_trimmed_mean(t, trims[i]),
               JDEF.flat_trimmed_mean(j, trims[i]))
        _close(TDEF.flat_mean(t), JDEF.flat_mean(j))
        _close(TDEF.flat_geometric_median(t),
               JDEF.flat_geometric_median(j))
    xs = torch.from_numpy(x)
    trim_t = torch.tensor(trims, dtype=torch.int32)
    got_tm = TDEF.flat_trimmed_mean(xs, trim_t)
    got_med = TDEF.flat_median(xs)
    for i in range(2):
        j = jnp.asarray(x[i])
        _close(got_tm[i], JDEF.flat_trimmed_mean(j, trims[i]))
        np.testing.assert_array_equal(got_med[i].numpy(),
                                      np.asarray(JDEF.flat_median(j)))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}


@pytest.mark.parametrize("u", [10, 70])
@pytest.mark.parametrize("f,multi", [(0, 1), (3, 1), (2, 4)])
def test_krum_matches_jax(u, f, multi):
    """Krum and multi-Krum on the direct path (U = 10) and the blocked
    path (U = 70 >= KRUM_BLOCK_MIN_U), one lane and a lane group."""
    assert (u >= TDEF.KRUM_BLOCK_MIN_U) == (u >= JDEF.KRUM_BLOCK_MIN_U)
    d = 37
    x = _slab(u * 7 + f, 2, u, d)
    scores = (TDEF._krum_scores_blocked if u >= TDEF.KRUM_BLOCK_MIN_U
              else TDEF._krum_scores)
    jscores = (JDEF._krum_scores_blocked if u >= JDEF.KRUM_BLOCK_MIN_U
               else JDEF._krum_scores)
    for i in range(2):
        j, t = jnp.asarray(x[i]), torch.from_numpy(x[i])
        _close(scores(t, f), jscores(j, f))
        _close(TDEF.flat_krum(t, f, multi), JDEF.flat_krum(j, f, multi))
    lanes = TDEF.flat_krum(torch.from_numpy(x),
                           torch.tensor([f, 0], dtype=torch.int32),
                           torch.tensor([multi, 1], dtype=torch.int32))
    _close(lanes[0], JDEF.flat_krum(jnp.asarray(x[0]), f, multi))
    _close(lanes[1], JDEF.flat_krum(jnp.asarray(x[1]), 0, 1))


@pytest.mark.parametrize("u,d", [(64, 37), (130, 16), (200, 8)])
def test_blocked_krum_scores_match_direct(u, d):
    """tests/test_defense_sort.py's contract, on the port's two paths."""
    flat = torch.from_numpy(_slab(u * d, u, d))
    np.testing.assert_allclose(TDEF._krum_scores_blocked(flat, 3).numpy(),
                               TDEF._krum_scores(flat, 3).numpy(),
                               rtol=2e-4, atol=1e-3)


def test_krum_scores_finite_and_ties_rank_in_worker_order():
    """The boolean-mask self-exclusion keeps every score finite (eye * inf
    would make them NaN), and equal scores rank by worker index, as jnp.argsort's
    stable sort does: with the workers at the corners of a simplex (every
    score equal), multi-Krum averages rows 0..m-1."""
    flat = torch.from_numpy(_slab(3, 10, 64))
    assert torch.isfinite(TDEF._krum_scores(flat, 1)).all()
    tied = torch.eye(6)
    scores = TDEF._krum_scores(tied, 0)
    assert torch.equal(scores, torch.full((6,), 8.0))
    got = TDEF.flat_krum(tied, 0, 3)
    np.testing.assert_array_equal(got.numpy(), tied[:3].mean(dim=0).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JDEF.flat_krum(jnp.eye(6), 0, 3)))


@pytest.mark.parametrize("code", sorted(JSC.DEFENSE_CODES.values()))
def test_group_defense_kernel_matches_jax(code):
    """make_group_defense_kernel over a [S_g, U, D] group with per-lane
    trim / f / multi, against the reference's vmapped group kernel."""
    s, u, d = 3, 10, 130
    x = _slab(code, s, u, d)
    trim, f, multi = [1, 3, 4], [0, 2, 3], [1, 2, 5]
    jk = JDEF.make_group_defense_kernel(code, gm_iters=5)
    tk = TDEF.make_group_defense_kernel(code, gm_iters=5)
    want = jk(jnp.asarray(x), *(jnp.asarray(v, jnp.int32)
                                for v in (trim, f, multi)))
    got = tk(torch.from_numpy(x), *(torch.tensor(v, dtype=torch.int32)
                                    for v in (trim, f, multi)))
    assert got.shape == (s, d)
    _close(got, want)


@pytest.mark.parametrize("shape", [(1, 7), (10, 130), (33, 515), (3, 100, 9)])
def test_sort_columns_ref_matches_jnp_sort(shape):
    x = _slab(len(shape), *shape)
    want = np.sort(x, axis=len(shape) - 2)
    np.testing.assert_array_equal(np.asarray(jops.sort_columns_ref(x)
                                             if x.ndim == 2 else
                                             jops.sort_columns_batched_ref(x)),
                                  want)
    t = torch.from_numpy(x)
    got = (tref.sort_columns_ref(t) if x.ndim == 2
           else tref.sort_columns_batched_ref(t))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrappers' CPU route is the plain version, with no launch
    tops.reset_launches()
    wrapper = (tops.sort_columns if shape[-2] <= TDS.UNROLL_MAX_U
               else tops.sort_columns_bitonic)
    np.testing.assert_array_equal(wrapper(t).numpy(), want)
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}


def test_sort_router_by_u():
    """The card's route is a pure function of U: the odd-even kernel up to
    32, the bitonic kernel while U padded to a power of two fits its
    shared-memory cap (the reference's 8192), no kernel above."""
    route = TDEF.sort_route
    assert [route(u) for u in (1, 2, 10, 31, 32)] == ["sort_columns"] * 5
    assert [route(u) for u in (33, 100, 1000, 2049, 4096, 4097, 8192)] == [
        "sort_columns_bitonic"] * 7
    assert [route(u) for u in (8193, 10_000)] == [None] * 2
    assert TDS.BITONIC_MAX_U == jops.BITONIC_MAX_U == 8192
    assert TDEF.SORT_UNROLL_MAX_U == JDEF.SORT_UNROLL_MAX_U
    # the bitonic plan: 32 values per thread; a column takes U_pad / 32
    # threads, so small U_pad packs columns into a warp and large U_pad
    # spans warps; every block is 256 threads and ~34 KB of static shared
    # memory (a static array's cap is 48 KB, under the 232 448 B a block
    # may opt into on an H100)
    pads = [1 << e for e in range(6, 14)]
    plans = [TDS.bitonic_plan(p) for p in pads]
    assert [pl["columns_per_block"] for pl in plans] == [
        128, 64, 32, 16, 8, 4, 2, 1]
    assert [pl["warps_per_column"] for pl in plans] == [
        1, 1, 1, 1, 1, 2, 4, 8]
    assert [pl["columns_per_warp"] for pl in plans] == [
        16, 8, 4, 2, 1, 1, 1, 1]
    for p, pl in zip(pads, plans):
        assert pl["values_per_thread"] * pl["threads_per_column"] == p
        assert (pl["columns_per_block"] * pl["threads_per_column"]
                == pl["threads_per_block"] <= 1024)
        assert 33 * 1024 <= pl["smem_bytes"] <= 48 * 1024
        # registers: the values and ~16 working registers fit the 64 a
        # thread has with four blocks of 256 threads on an SM's 65 536
        assert pl["values_per_thread"] + 16 <= 65_536 // (
            4 * pl["threads_per_block"])
    for bad in (32, 100, 16384):
        with pytest.raises(ValueError, match="bitonic_plan"):
            TDS.bitonic_plan(bad)
    # above the cap no kernel exists: every device sorts with torch.sort
    # (on the card too, logged once, tests/test_torch_gpu.py), as the
    # reference takes jnp.sort there
    x = torch.from_numpy(_slab(1, 8193, 2))
    np.testing.assert_array_equal(TDEF.sorted_columns(x).numpy(),
                                  np.sort(x.numpy(), axis=0))
    x3 = torch.from_numpy(_slab(2, 2, 8193, 3))
    np.testing.assert_array_equal(TDEF.sorted_columns(x3).numpy(),
                                  np.sort(x3.numpy(), axis=1))


def test_defenses_past_the_sort_cap_match_jax():
    """Median and trimmed mean at U = 8193, past the bitonic cap, where both
    packages sort with their library sort: equal to the JAX flat
    defenses."""
    x = _slab(3, 8193, 5)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(TDEF.flat_median(tx).numpy(),
                                  np.asarray(JDEF.flat_median(jnp.asarray(x))))
    _close(TDEF.flat_trimmed_mean(tx, 800),
           JDEF.flat_trimmed_mean(jnp.asarray(x), 800))


def test_sort_wrappers_check_their_inputs():
    x = torch.zeros(33, 8)
    with pytest.raises(ValueError, match="U<=32"):
        tops.sort_columns(x)
    with pytest.raises(ValueError, match="BITONIC_MAX_U"):
        tops.sort_columns_bitonic(torch.zeros(TDS.BITONIC_MAX_U + 1, 2))
    with pytest.raises(ValueError, match="dtype"):
        tops.sort_columns(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tops.sort_columns(torch.zeros(8, 4).t())
    with pytest.raises(ValueError, match=r"\[U, D\] or \[S, U, D\]"):
        tops.sort_columns_bitonic(torch.zeros(8))
    xb = torch.from_numpy(_slab(2, 10, 640)).to(torch.bfloat16)
    got = tops.sort_columns(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.sort(xb.float().numpy(), axis=0))


def test_defense_spec_validation():
    """tests/test_defense_lanes.py::test_defense_spec_validation, mirrored."""
    DS = TSC.DefenseSpec
    DS(name="trimmed_mean", trim=1).validate(4)
    for bad, match in [(DS(name="trimmed_mean", trim=2), "trim"),
                       (DS(name="trimmed_mean", trim=-1), "trim"),
                       (DS(name="krum", num_byzantine=4), "num_byzantine"),
                       (DS(name="multi_krum", multi=9), "multi"),
                       (DS(name="bulyan"), "unknown defense"),
                       (DS(name="geometric_median", gm_iters=0), "gm_iters")]:
        with pytest.raises(ValueError, match=match):
            bad.validate(4)
    assert DS.from_kwargs("krum", num_byzantine=1, multi=3).name == "multi_krum"
    assert DS.from_kwargs("geometric_median", iters=16).gm_iters == 16
    for kw in ({"bogus": 1}, {"trim": 2}):
        with pytest.raises(ValueError, match="does not accept"):
            DS.from_kwargs("median", **kw)
    assert TSC.DEFENSE_CODES == JSC.DEFENSE_CODES
    assert TSC._FLOA_CODE == JSC._FLOA_CODE
    assert TDEF.COLUMNWISE_CODES == JDEF.COLUMNWISE_CODES
    assert TDEF.ROW_GEOMETRY_CODES == JDEF.ROW_GEOMETRY_CODES
    spec = DS(name="multi_krum", num_byzantine=2, multi=3)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        JSC.DefenseSpec(name="multi_krum", num_byzantine=2, multi=3))


def test_lane_groups_metadata():
    """tests/test_defense_lanes.py::test_lane_groups_metadata on one device,
    against the reference's unsharded partition."""
    codes = [0, 4, 2, 0, 2, 4, 4]
    g = TSC.build_lane_groups(codes)
    assert g.codes == (0, 2, 4)
    assert g.perm == (0, 3, 2, 4, 1, 5, 6)
    assert [g.perm[r] for _, s, e in g.local_slices for r in range(s, e)
            ] == list(g.perm)
    for i, row in enumerate(g.inverse):
        assert g.perm[row] == i
    want = JSC.build_lane_groups(codes, shards=1)
    assert (g.codes, g.perm, g.inverse, g.local_slices) == (
        want.codes, want.perm, want.inverse, want.local_slices)
    x = torch.arange(7)
    assert TSC.permute_lanes(x, g.perm).tolist() == list(g.perm)
    assert TSC.permute_lanes(TSC.permute_lanes(x, g.perm),
                             g.inverse).tolist() == list(range(7))

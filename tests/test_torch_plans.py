"""The launch plans of the port's FLOA combine and grad_stats kernels.

Both kernels take their launch shape from a pure Python function of the
input shape, dtype, pointer alignment and SM count
(`kernels/floa_aggregate.py::combine_plan`, `kernels/grad_stats.py::
cluster_size`), and `row_chunks` / `warp_slices` mirror how the CUDA
kernels cut a row and a column's workers.  These run on the CPU: no card,
no JAX.
"""
import itertools

import pytest

from repro_torch.kernels import floa_aggregate as FA
from repro_torch.kernels import grad_stats as GS

H100_SMS = 132
ESIZE = {"float32": 4, "bfloat16": 2}


def _covers_once(ranges, n):
    """The (start, end) ranges tile [0, n) with no gap and no overlap."""
    pos = 0
    for start, end in sorted(ranges):
        assert start == pos and end > start, (ranges, n)
        pos = end
    assert pos == n


@pytest.mark.parametrize("d", [1, 3, 4097, 50890])
@pytest.mark.parametrize("dtype", sorted(ESIZE))
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_row_chunks_cover_the_row_once(d, dtype, offset):
    """Every row is read exactly once: the head up to the first 16-byte
    boundary and the tail after the last whole vector go to rank 0, each
    shorter than a vector; every block's run of vectors starts on a
    16-byte boundary and holds whole vectors."""
    esize = ESIZE[dtype]
    v = GS.VEC_BYTES // esize
    base = 4096 + offset * esize           # a view at storage offset `offset`
    for c in GS.CLUSTER_SIZES:
        for row in range(3):               # rows of [R, D] start at r * D
            addr = base + row * d * esize
            chunks = GS.row_chunks(d, c, esize, addr)
            _covers_once([(s, e) for _, s, e in chunks], d)
            assert all(0 <= rank < c for rank, _, _ in chunks)
            n_vec = 0
            for rank, s, e in chunks:
                aligned = (addr + s * esize) % GS.VEC_BYTES == 0
                if aligned and (e - s) % v == 0 and e - s >= v:
                    n_vec += (e - s) // v          # a run of whole vectors
                else:                              # the head or the tail
                    assert rank == 0 and e - s < v
                    assert s == 0 or (addr + s * esize) % GS.VEC_BYTES == 0
            head = (-(addr % GS.VEC_BYTES) // esize) % v
            assert n_vec == max(0, d - head) // v


@pytest.mark.parametrize("r", [1, 10, 20, 30, 40, 96, 1000, 5000])
@pytest.mark.parametrize("max_cluster", [1, 2, 8, 16])
def test_cluster_size_within_the_stated_limit(r, max_cluster):
    c = GS.cluster_size(r, 50890, 4, H100_SMS, max_cluster)
    assert c in GS.CLUSTER_SIZES and c <= max_cluster
    if r * c < GS.TARGET_BLOCKS_PER_SM * H100_SMS and c < max_cluster:
        # only a block's least share of the row stops the split
        assert 50890 * 4 // GS.VEC_BYTES // (2 * c) < GS.MIN_VECS_PER_BLOCK
    if c > 1:                              # no larger C than needed
        assert r * (c // 2) < GS.TARGET_BLOCKS_PER_SM * H100_SMS


def test_cluster_size_at_the_main_path_row_counts():
    """One block a row at R = 1000 (the U = 1000 grid's analog lane);
    several at the paper's grids' 10-40 rows; never a block with less
    than one round of loads a thread (a short row stays whole)."""
    plan = {r: GS.cluster_size(r, 50890, 4, H100_SMS, 16)
            for r in (10, 20, 30, 40, 1000)}
    assert plan[1000] == 1
    assert all(plan[r] > 1 for r in (10, 20, 30, 40))
    assert plan[10] >= plan[20] >= plan[30] >= plan[40]
    for r, c in plan.items():
        assert 50890 * 4 // GS.VEC_BYTES // c >= GS.MIN_VECS_PER_BLOCK
    assert GS.cluster_size(96, 5000, 2, H100_SMS, 16) == 1
    assert GS.cluster_size(4, 1000, 4, H100_SMS, 16) == 1


@pytest.mark.parametrize("u", [1, 7, 10, 33, 1000])
@pytest.mark.parametrize("ku", FA.WORKER_SLICES)
def test_warp_slices_cover_every_worker_once(u, ku):
    slices = FA.warp_slices(u, ku)
    assert len(slices) == ku
    assert [w for a, b in slices for w in range(a, b)] == list(range(u))
    sizes = [b - a for a, b in slices]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("d,g_esize,w_esize,align,want", [
    (50890, 4, 4, 16, 2),      # D = 2 x 25 445: f32 rows 8-byte aligned
    (50890, 2, 2, 16, 2),      # bf16: 4-byte loads
    (50890, 4, 4, 4, 1),       # a view at an odd f32 offset
    (4096, 4, 4, 16, 4),
    (4096, 2, 2, 16, 8),       # 16-byte bf16 loads
    (4096, 2, 4, 16, 4),       # bf16 G, f32 w: w's 16 bytes limit V
    (4096, 4, 2, 8, 2),
    (5000, 2, 2, 2, 1),
    (1, 4, 4, 16, 1),
    (4097, 4, 4, 16, 1),
])
def test_vector_width(d, g_esize, w_esize, align, want):
    assert FA.vector_width(d, g_esize, w_esize, align) == want


# (G, w) element sizes and a pointer alignment torch can hand out for them
ESIZES_ALIGN = [(e, a) for e in [(4, 4), (2, 2), (2, 4)]
                for a in (2, 4, 8, 16) if a >= max(e)]


@pytest.mark.parametrize("s,u,d", [(4, 10, 50890), (3, 10, 50890),
                                   (1, 10, 50890), (1, 1000, 50890),
                                   (1, 1, 7), (2, 33, 4097), (1, 12288, 64)])
@pytest.mark.parametrize("esizes,align", ESIZES_ALIGN)
def test_combine_plan_fits_shape_and_pointers(s, u, d, esizes, align):
    g_esize, w_esize = esizes
    vec, ku = FA.combine_plan(s, u, d, g_esize, w_esize, align, H100_SMS)
    assert d % vec == 0 and vec * max(esizes) <= 16
    assert align % (vec * g_esize) == 0 and align % (vec * w_esize) == 0
    assert ku in FA.WORKER_SLICES and ku <= max(1, u)
    assert (vec, ku) == FA.combine_plan(s, u, d, g_esize, w_esize, align,
                                        H100_SMS)


def test_combine_plan_at_the_main_path_shapes():
    """Every U = 10 lane count of the main path (S = 1, 2, 3, 4) takes the
    compile-time U and one worker slice; the U = 1000 grid's single lane
    splits U so that its grid reaches TARGET_BLOCKS_PER_SM blocks an SM."""
    def plan(s, u, esize=4):
        return FA.combine_plan(s, u, 50890, esize, esize, 16, H100_SMS)
    for s in (1, 2, 3, 4):
        assert plan(s, 10) == (2, 1)
    vec, ku = plan(1, 1000)
    assert vec == 2 and ku > 1
    blocks = -(-(50890 // vec) // ((FA.WARPS // ku) * 32))
    assert blocks >= FA.TARGET_BLOCKS_PER_SM * H100_SMS
    assert ku == 1 or -(-(50890 // vec) // ((FA.WARPS // (ku // 2)) * 32)) \
        < FA.TARGET_BLOCKS_PER_SM * H100_SMS
    assert plan(1, 16) == (2, 1) and plan(1, 17)[1] > 1
    assert plan(1, 10, esize=2)[1] > 1     # bf16 takes the runtime loop
    assert plan(1, 1) == (2, 1)            # one worker: nothing to split


def test_plans_are_pure_functions_of_their_inputs():
    """The same inputs give the same plan (the kernels' sums, and so their
    bits, depend only on it)."""
    grid = itertools.product((1, 4), (1, 10, 1000), (1, 4097, 50890),
                             (2, 4), (4, 8, 16))
    for s, u, d, esize, align in grid:
        first = [FA.combine_plan(s, u, d, esize, esize, align, H100_SMS),
                 GS.cluster_size(s * u, d, esize, H100_SMS, 16),
                 GS.row_chunks(d, 4, esize, align)]
        assert first == [FA.combine_plan(s, u, d, esize, esize, align,
                                         H100_SMS),
                         GS.cluster_size(s * u, d, esize, H100_SMS, 16),
                         GS.row_chunks(d, 4, esize, align)]


def test_align_is_the_common_power_of_two():
    assert FA._align(4096, 8192) == 16
    assert FA._align(4096 + 8, 8192) == 8
    assert FA._align(4096 + 4, 8192 + 2) == 2
    assert FA._align(4096 + 48) == 16

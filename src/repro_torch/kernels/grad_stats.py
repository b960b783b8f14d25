"""Per-row gradient statistics kernel (standardization round, eq. 3).

Wrapper around the CUDA C++ kernel of `csrc/grad_stats.cu`, which replaces
the Pallas kernel `repro/kernels/grad_stats.py::grad_stats`: rows [R, D] ->
[R, 2] f32 (sum, sum of squares).  The sweep engine hands it the [S*U, D]
rows of its gradient slab; the mean/variance follow on scalars
(`core/standardize.py::flat_scalar_stats`).

CPU tensors take the plain version (`kernels/ref.py::grad_stats_ref`), CUDA
tensors launch the kernel or raise; `plain=True` forces the plain version
for kernel-vs-plain tests.  Launches are counted in `grad_stats.launches`,
and by (R, D) in `grad_stats.shapes`.

`grad_stats_segments(rows, sizes)` is the fixed-order route, the sweep's
strict_numerics stats: each leaf segment's sums of [R, D] rows (a
row-strided view of the slab), folded in leaf order from 0, in one call
(`segment_parts_kernel`, a block a (row, part), then `segment_fold_kernel`,
a block a row; csrc/grad_stats.cu).  The sum's order depends on the leaf
sizes alone, not on R, the row stride or where a row starts: `work_list`
mirrors the parts the kernel cuts.  Its kernel launches, two a call, are
counted in `grad_stats_segments.launches`, and by (R, sizes) in `.shapes`.  `grad_stats_fixed(rows)` is its
one-segment case, sizes = (D,).

Bound and design (details in the .cu source): one read of R*D elements,
bound by bytes.  Each row is split over the C blocks of one thread-block
cluster (`cluster_size`: C grows while R*C is under TARGET_BLOCKS_PER_SM
blocks an SM and a block keeps MIN_VECS_PER_BLOCK vectors, so C = 1 at
R = 1000 and for short rows); a block reads its share with 16-byte
loads and hands its partial sums to the cluster's rank-0 block through
distributed shared memory, which adds them in rank order.  The alignment
rule: each row peels the elements before its first 16-byte boundary and
after its last whole vector (`row_chunks`), so any contiguous view, at any
storage offset and any D, is read with aligned loads.  The sum's order
depends only on (R, D, C, the row's alignment): deterministic, no atomics.
"""
from __future__ import annotations

import collections
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

MAX_ROWS = 2**31 - 1       # grid.x limit (R * C blocks, checked at launch)
THREADS = 256              # csrc/grad_stats.cu::THREADS
VEC_BYTES = 16             # one load
# A block's least share of a row, in 16-byte vectors: one round of the
# kernel's UNROLL = 4 loads a thread.
MIN_VECS_PER_BLOCK = THREADS * 4
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # 16 is non-portable on sm_90
# A row is split until R * C reaches this many blocks an SM (or C the card's
# largest cluster, or a block less than MIN_VECS_PER_BLOCK).  Each doubling
# of C costs cluster set-up and a longer sync, so the best C at the paper's
# 10-40 rows sits near 1.5 blocks an SM (`cluster_ms`, PERF.md).
TARGET_BLOCKS_PER_SM = 1.5


def cluster_size(r: int, d: int, esize: int, sms: int,
                 max_cluster: int) -> int:
    """Blocks per row (the cluster size C) for R rows of D elements of
    `esize` bytes on a card of `sms` SMs whose largest cluster is
    `max_cluster`: the smallest C in CLUSTER_SIZES with R*C >=
    TARGET_BLOCKS_PER_SM * sms, capped at max_cluster and at the C that
    leaves each block MIN_VECS_PER_BLOCK vectors."""
    vecs = d * esize // VEC_BYTES
    c = 1
    while (c * 2 <= max_cluster and r * c < TARGET_BLOCKS_PER_SM * sms
           and vecs // (c * 2) >= MIN_VECS_PER_BLOCK):
        c *= 2
    return c


def row_chunks(d: int, c: int, esize: int, row_addr: int
               ) -> List[Tuple[int, int, int]]:
    """The kernel's split of one row of D elements starting at byte address
    `row_addr` over C blocks, as (rank, start, end) element ranges: rank 0
    takes the head (up to the first 16-byte boundary) and the tail (after
    the last whole vector); the whole vectors between go to the ranks in
    equal runs of ceil(n_vec / C).  Mirrors csrc/grad_stats.cu."""
    v = VEC_BYTES // esize
    mis = (row_addr % VEC_BYTES) // esize
    head = min(d, v - mis) if mis else 0
    n_vec = (d - head) // v
    tail0 = head + n_vec * v
    per = -(-n_vec // c)
    out = [(0, 0, head)] if head else []
    for rank in range(c):
        v0 = min(n_vec, rank * per)
        v1 = min(n_vec, v0 + per)
        if v1 > v0:
            out.append((rank, head + v0 * v, head + v1 * v))
    if tail0 < d:
        out.append((0, tail0, d))
    return out


@functools.lru_cache(maxsize=None)
def _card(device_index: int, dtype_code: int) -> Tuple[int, int]:
    """(SM count, largest cluster the kernel runs at) of one card."""
    max_c = _build.library("grad_stats").grad_stats_max_cluster(dtype_code)
    need(max_c >= 1, f"grad_stats: cluster query failed ({max_c})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms, max_c


@functools.lru_cache(maxsize=4096)
def _plan(device_index: int, r: int, d: int, dtype) -> int:
    sms, max_c = _card(device_index, DTYPE_CODES[dtype])
    return cluster_size(r, d, dtype.itemsize, sms, max_c)


def grad_stats(grads: Tensor, *, plain: bool = False) -> Tensor:
    """grads [R, D] f32|bf16, contiguous -> [R, 2] f32 (sum, sum of
    squares)."""
    need(isinstance(grads, torch.Tensor) and grads.dim() == 2,
         "grads must be an [R, D] tensor")
    r, d = grads.shape
    need(grads.device.type in ("cpu", "cuda"),
         f"unsupported device {grads.device}")
    need(1 <= r <= MAX_ROWS and d >= 1, f"bad shape {(r, d)}")
    check_tensor("grads", grads, (r, d), tuple(DTYPE_CODES), grads.device)
    if grads.device.type == "cpu" or plain:
        return ref.grad_stats_ref(grads)
    c = _plan(grads.device.index, r, d, grads.dtype)
    out = torch.empty((r, 2), dtype=torch.float32, device=grads.device)
    err = _build.library("grad_stats").grad_stats(
        grads.data_ptr(), out.data_ptr(), r, d, DTYPE_CODES[grads.dtype], c,
        torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "grad_stats")
    grad_stats.launches += 1
    grad_stats.shapes[(r, d)] += 1
    return out


grad_stats.launches = 0
grad_stats.shapes = collections.Counter()


# The strict route's work list (csrc/grad_stats.cu::PART_ELEMS,
# MAX_FOLD_PAIRS): a segment of n elements is cut into ceil(n / PART_ELEMS)
# parts; one call holds at most MAX_FOLD_PAIRS parts and segments together
# (the fold's shared memory) and R * parts blocks.
PART_ELEMS = 8192
MAX_FOLD_PAIRS = 16384
MAX_BLOCKS = 2**31 - 1
SEGMENT_LAUNCHES = 2       # a call launches the parts and the fold kernel


def segment_parts(n: int) -> int:
    """Parts of a leaf segment of n elements: P(n) = ceil(n / PART_ELEMS)."""
    return -(-n // PART_ELEMS)


@functools.lru_cache(maxsize=256)
def work_list(sizes: Tuple[int, ...]) -> Tuple[Tuple[int, int, int], ...]:
    """The strict route's parts for leaf sizes `sizes` (flatten order), in
    the order the kernel folds them: (segment, start, length), `start`
    counted from the row's first element.  Segment s's parts tile its
    elements in order, PART_ELEMS each (the last shorter): a function of
    `sizes` alone.  Mirrors csrc/grad_stats.cu's table."""
    out, off = [], 0
    for s, n in enumerate(sizes):
        for p in range(segment_parts(n)):
            start = p * PART_ELEMS
            out.append((s, off + start, min(PART_ELEMS, n - start)))
        off += n
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _table(device: torch.device, sizes: Tuple[int, ...]) -> Tensor:
    """The kernel's int64 table on `device`: item starts, item lengths, then
    each segment's first item and the item count (n_seg + 1 entries)."""
    items = work_list(sizes)
    first = [0] * (len(sizes) + 1)
    for s, _, _ in items:
        first[s + 1] += 1
    for s in range(len(sizes)):
        first[s + 1] += first[s]
    flat = ([start for _, start, _ in items] + [n for _, _, n in items]
            + first)
    return torch.tensor(flat, dtype=torch.int64).to(device)


def _check_rows(grads: Tensor) -> Tuple[int, int]:
    need(isinstance(grads, torch.Tensor) and grads.dim() == 2,
         "grads must be an [R, D] tensor")
    r, d = grads.shape
    need(grads.device.type in ("cpu", "cuda"),
         f"unsupported device {grads.device}")
    need(1 <= r <= MAX_ROWS and d >= 1, f"bad shape {(r, d)}")
    need(grads.dtype in DTYPE_CODES, f"grads has dtype {grads.dtype}")
    need((grads.stride(1) == 1 or d == 1)
         and (grads.stride(0) >= d or r == 1),
         f"grads rows must be unit-stride and not overlap, got strides "
         f"{grads.stride()}")
    return r, d


def grad_stats_segments(rows: Tensor, sizes, *, plain: bool = False
                        ) -> Tensor:
    """The fixed-order route: rows [R, D] f32|bf16, at any row stride with
    unit stride within a row, and `sizes` the per-leaf entry counts in
    flatten order (each >= 1, summing to D) -> [R, 2] f32: per row, each
    segment's (sum, sum of squares), folded in leaf order from 0.  The
    order depends on `sizes` alone (`work_list`)."""
    r, d = _check_rows(rows)
    sizes = tuple(int(n) for n in sizes)
    need(len(sizes) >= 1 and min(sizes) >= 1,
         f"leaf sizes must be >= 1, got {sizes}")
    need(sum(sizes) == d, f"leaf sizes sum to {sum(sizes)}, flat D is {d}")
    if rows.device.type == "cpu" or plain:
        return ref.grad_stats_segments_ref(rows, sizes)
    items = work_list(sizes)
    need(len(items) + len(sizes) <= MAX_FOLD_PAIRS
         and r * len(items) <= MAX_BLOCKS,
         f"{len(items)} parts of {len(sizes)} segments at R = {r} exceed "
         f"the kernel's limits")
    table = _table(rows.device, sizes)
    parts = torch.empty((r, len(items), 2), dtype=torch.float32,
                        device=rows.device)
    out = torch.empty((r, 2), dtype=torch.float32, device=rows.device)
    err = _build.library("grad_stats").grad_stats_segments(
        rows.data_ptr(), out.data_ptr(), parts.data_ptr(), r,
        rows.stride(0) if r > 1 else d, table.data_ptr(), len(items),
        len(sizes), DTYPE_CODES[rows.dtype],
        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "grad_stats_segments")
    grad_stats_segments.launches += SEGMENT_LAUNCHES
    grad_stats_segments.shapes[(r, sizes)] += SEGMENT_LAUNCHES
    return out


grad_stats_segments.launches = 0
grad_stats_segments.shapes = collections.Counter()


def grad_stats_fixed(grads: Tensor, *, plain: bool = False) -> Tensor:
    """The fixed-order route on one segment: grads [R, D] f32|bf16, rows at
    any row stride with unit stride within a row (a leaf segment of the
    [R, D_total] slab) -> [R, 2] f32, `grad_stats_segments(grads, (D,))`
    (counted there)."""
    _, d = _check_rows(grads)
    return grad_stats_segments(grads, (d,), plain=plain)

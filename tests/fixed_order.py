"""A numpy mirror of the strict route's add order for the sum column.

`csrc/grad_stats.cu::segment_parts_kernel` adds element j of a part into
thread j % SEG_THREADS in increasing j, folds the 32 lanes of a warp by a
shuffle-down tree and the warps' sums by another, and
`segment_fold_kernel` adds each segment's parts in part order and the
segments in leaf order, from 0.  `fixed_order_sums` repeats those float32
adds in that order, for the parts of `grad_stats.work_list`.  The kernel's
sum column must equal it bit for bit (`tests/test_torch_gpu.py`).  Only the
sum is mirrored: the kernel takes the sum of squares with fused
multiply-adds, which numpy cannot round the same way.  No JAX.
"""
import numpy as np

from repro_torch.kernels import grad_stats as GS

SEG_THREADS = 256                    # csrc/grad_stats.cu::SEG_THREADS
SEG_WARPS = SEG_THREADS // 32


def part_sums(x: np.ndarray) -> np.ndarray:
    """x [R, m] (m <= PART_ELEMS) -> [R] float32: one part's block sum a
    row.  A thread past the part's end adds nothing; here it adds +0.0,
    which leaves its running sum alone (a sum that starts at +0.0 is never
    -0.0 under round-to-nearest)."""
    r, m = x.shape
    pad = np.zeros((r, GS.PART_ELEMS), np.float32)
    pad[:, :m] = x
    slots = pad.reshape(r, -1, SEG_THREADS)
    acc = np.zeros((r, SEG_THREADS), np.float32)
    for k in range(slots.shape[1]):
        acc = acc + slots[:, k]
    lanes = acc.reshape(r, SEG_WARPS, 32)
    for off in (16, 8, 4, 2, 1):
        lanes[..., :off] = lanes[..., :off] + lanes[..., off:2 * off]
    warps = lanes[..., 0].copy()
    off = SEG_WARPS // 2
    while off:
        warps[:, :off] = warps[:, :off] + warps[:, off:2 * off]
        off //= 2
    return warps[:, 0]


def fixed_order_sums(rows: np.ndarray, sizes) -> np.ndarray:
    """rows [R, D] (float32, or bf16 values widened to float32) -> [R]
    float32, the strict route's sum column: parts folded in part order
    from 0 a segment, segments in leaf order from 0."""
    rows = np.asarray(rows, np.float32)
    total = np.zeros(rows.shape[0], np.float32)
    seg, seg_sum = 0, np.zeros(rows.shape[0], np.float32)
    for s, start, n in GS.work_list(tuple(sizes)):
        if s != seg:
            total, seg, seg_sum = total + seg_sum, s, np.zeros_like(total)
        seg_sum = seg_sum + part_sums(rows[:, start:start + n])
    return total + seg_sum

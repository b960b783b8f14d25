"""Coordinate-sort kernels for the digital screening defenses.

Wrappers around the CUDA C++ kernels of `csrc/defense_sort.cu`, which
replace the two Pallas kernels of `repro/kernels/defense_sort.py`:

  sort_columns          U <= UNROLL_MAX_U (32): an unrolled odd-even
                        transposition network, one column per thread, the U
                        values in registers
  sort_columns_bitonic  U padded to a power of two U_pad (64 <= U_pad <=
                        BITONIC_MAX_U): the bitonic network in registers,
                        32 values per thread, shared memory only to stage
                        the tile and to move a thread's register window

Both take [U, D] or [S, U, D] (f32 or bf16, contiguous) and sort ascending
along the worker axis, computing in f32 and returning the input dtype.  The
[S, U, D] form is one launch with the lane as the grid's y dimension (the
JAX package gets that dimension from vmap); [U, D] is the same launch at
S = 1.  On finite inputs the result equals `torch.sort(...).values` exactly;
NaN ordering is out of contract, as in the reference.

The bitonic plan (`bitonic_plan`), re-derived for Hopper (the reference's
BITONIC_MAX_U = 8192 and `bitonic_tile_d` come from a TPU's VMEM budget):
each thread holds SORT_VALUES = 32 values of one column in registers, so a
column takes U_pad / 32 threads, and a block of SORT_THREADS = 256 threads
holds 256 / (U_pad / 32) columns (several per warp below U_pad = 1024, a
few warps per column above it).  Its shared memory is the block's values
once, column by column with one float of pad per 32 (U_pad * 33/32 * 4
bytes a column, ~34 KB a block at every U_pad).  A column must fit one
block, so BITONIC_MAX_U = 256 * 32 = 8192, the reference's cap.  Above it
there is no kernel: `core/defenses.py::sorted_columns` takes `torch.sort`
there, as the reference takes `jnp.sort` (ROADMAP.md Queue 2 item 6).
U > 32 pads to at least 64 (two threads a column).

CPU tensors take the plain versions (`kernels/ref.py`); CUDA tensors launch
the kernel or raise.  `plain=True` forces the plain version on the card; it
exists so a test can hold the kernel against it.  Each wrapper counts its
launches in its `launches` attribute, and by input shape in `shapes`.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

UNROLL_MAX_U = 32          # the odd-even switch instantiates U = 1..32
SORT_THREADS = 256         # bitonic threads per block
SORT_VALUES = 32           # bitonic values per thread, in registers
BITONIC_MIN_U = 64         # the smallest padded U: two threads a column
MAX_LANES = 65535          # grid.y limit


def pad_pow2(u: int) -> int:
    """The next power of two >= u: the bitonic network's row count."""
    return 1 << max(u - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def bitonic_plan(u_pad: int) -> dict:
    """The bitonic kernel's launch plan for U_pad rows (a power of two from
    BITONIC_MIN_U to BITONIC_MAX_U): values per thread, threads and warps
    per column, columns per block, and the block's shared memory (column
    stride U_pad + U_pad / 32 + a bank offset, in f32).  The launch takes
    its grid from `columns_per_block`, and the kernel's C entry point
    refuses a plan whose columns or shared memory differ from those its
    template instance `Bitonic<L>` was compiled with."""
    need(BITONIC_MIN_U <= u_pad <= SORT_THREADS * SORT_VALUES
         and u_pad & (u_pad - 1) == 0,
         f"bitonic_plan: U_pad={u_pad} is not a power of two in "
         f"[{BITONIC_MIN_U}, {SORT_THREADS * SORT_VALUES}]")
    threads = u_pad // SORT_VALUES
    columns = SORT_THREADS // threads
    offset = {1024: 4, 2048: 8, 4096: 16}.get(u_pad, 0)
    return {"values_per_thread": SORT_VALUES,
            "threads_per_column": threads,
            "warps_per_column": max(1, threads // 32),
            "columns_per_warp": max(1, 32 // threads),
            "columns_per_block": columns,
            "threads_per_block": SORT_THREADS,
            "smem_bytes": 4 * columns * (u_pad + u_pad // 32 + offset)}


# A column must fit one block: 256 threads x 32 values.
BITONIC_MAX_U = SORT_THREADS * SORT_VALUES
assert BITONIC_MAX_U == 8192


def _as_lanes(x: Tensor, name: str) -> Tensor:
    """Check x ([U, D] or [S, U, D]) and return it as [S, U, D]."""
    need(isinstance(x, torch.Tensor) and x.dim() in (2, 3),
         f"{name}: x must be a [U, D] or [S, U, D] tensor")
    need(x.device.type in ("cpu", "cuda"), f"unsupported device {x.device}")
    x3 = x if x.dim() == 3 else x[None]
    s, u, d = x3.shape
    need(1 <= s <= MAX_LANES, f"{name}: S={s} outside [1, {MAX_LANES}]")
    need(u >= 1 and d >= 1, f"{name}: bad shape {tuple(x.shape)}")
    check_tensor("x", x, tuple(x.shape), tuple(DTYPE_CODES), x.device)
    return x3


def _plain(x: Tensor) -> Tensor:
    return (ref.sort_columns_ref(x) if x.dim() == 2
            else ref.sort_columns_batched_ref(x))


def sort_columns(x: Tensor, *, plain: bool = False) -> Tensor:
    """[U, D] | [S, U, D] -> the same shape, ascending along U (U <= 32)."""
    x3 = _as_lanes(x, "sort_columns")
    s, u, d = x3.shape
    need(u <= UNROLL_MAX_U,
         f"sort_columns unrolls an O(U^2) network: U={u} exceeds the "
         f"U<={UNROLL_MAX_U} bound — use sort_columns_bitonic for large "
         f"worker populations")
    if x.device.type == "cpu" or plain:
        return _plain(x)
    out = torch.empty_like(x)
    err = _build.library("defense_sort").sort_columns(
        x.data_ptr(), out.data_ptr(), s, u, d, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sort_columns")
    sort_columns.launches += 1
    sort_columns.shapes[tuple(x.shape)] += 1
    return out


sort_columns.launches = 0
sort_columns.shapes = collections.Counter()


def sort_columns_bitonic(x: Tensor, *, plain: bool = False) -> Tensor:
    """[U, D] | [S, U, D] -> the same shape, ascending along U, for U padded
    to a power of two up to BITONIC_MAX_U."""
    x3 = _as_lanes(x, "sort_columns_bitonic")
    s, u, d = x3.shape
    u_pad = pad_pow2(u)
    need(u_pad <= BITONIC_MAX_U,
         f"sort_columns_bitonic: padded U={u_pad} exceeds "
         f"BITONIC_MAX_U={BITONIC_MAX_U} (a column no longer fits one "
         f"block of {SORT_THREADS} threads x {SORT_VALUES} values)")
    if x.device.type == "cpu" or plain:
        return _plain(x)
    u_pad = max(u_pad, BITONIC_MIN_U)
    plan = bitonic_plan(u_pad)
    out = torch.empty_like(x)
    err = _build.library("defense_sort").sort_columns_bitonic(
        x.data_ptr(), out.data_ptr(), s, u, u_pad.bit_length() - 1,
        plan["columns_per_block"], plan["smem_bytes"], d,
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sort_columns_bitonic")
    sort_columns_bitonic.launches += 1
    sort_columns_bitonic.shapes[tuple(x.shape)] += 1
    return out


sort_columns_bitonic.launches = 0
sort_columns_bitonic.shapes = collections.Counter()

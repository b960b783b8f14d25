"""Coordinate-sort kernels for the digital screening defenses.

Wrappers around the CUDA C++ kernels of `csrc/defense_sort.cu`, which
replace the two Pallas kernels of `repro/kernels/defense_sort.py`:

  sort_columns          U <= UNROLL_MAX_U (32): an unrolled odd-even
                        transposition network, one column per thread, the U
                        values in registers
  sort_columns_bitonic  U padded to a power of two U_pad <= BITONIC_MAX_U:
                        the bitonic network over a [U_pad, T] tile in shared
                        memory, rows U.. filled with +inf

Both take [U, D] or [S, U, D] (f32 or bf16, contiguous) and sort ascending
along the worker axis, computing in f32 and returning the input dtype.  The
[S, U, D] form is one launch with the lane as the grid's y dimension (the
JAX package gets that dimension from vmap); [U, D] is the same launch at
S = 1.  On finite inputs the result equals `torch.sort(...).values` exactly;
NaN ordering is out of contract, as in the reference.

The bitonic cap, re-derived for Hopper (the reference's BITONIC_MAX_U = 8192
and `bitonic_tile_d` come from a TPU's VMEM budget): a block may have
SMEM_BYTES = 227 KB (232 448 bytes) of shared memory.  The tile is
T = min(32, the largest power of two with U_pad * T * 4 <= SMEM_BYTES)
columns, and U_pad may grow while T >= 4 (a tile row of 16 bytes, half a
32-byte sector): BITONIC_MAX_U = 8192 (a [8192, 4] f32 tile, 128 KB), the
reference's cap.  Tiles are [U_pad, 32] up to U_pad = 1024, [2048, 16],
[4096, 8] and [8192, 4]; at U = 1000 the tile is [1024, 32], 128 KB.
Above 48 KB the kernel requests the memory with cudaFuncSetAttribute.
Above the cap there is no tile: `core/defenses.py::sorted_columns` raises
on the card (ROADMAP.md Queue 2 item 6).

CPU tensors take the plain versions (`kernels/ref.py`); CUDA tensors launch
the kernel or raise.  `plain=True` forces the plain version on the card; it
exists so a test can hold the kernel against it.  Each wrapper counts its
launches in its `launches` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

UNROLL_MAX_U = 32          # the odd-even switch instantiates U = 1..32
SMEM_BYTES = 232_448       # dynamic shared memory one block may have (H100)
BITONIC_TILE_MAX = 32      # one warp-wide 128-byte row per tile row (f32)
BITONIC_TILE_MIN = 4       # half a 32-byte sector per tile row (f32)
MAX_LANES = 65535          # grid.y limit


def pad_pow2(u: int) -> int:
    """The next power of two >= u: the bitonic network's row count."""
    return 1 << max(u - 1, 0).bit_length()


def bitonic_tile_d(u_pad: int) -> int:
    """Columns per block: the widest power of two, at most BITONIC_TILE_MAX,
    whose [u_pad, T] f32 tile fits SMEM_BYTES (below BITONIC_TILE_MIN the
    padded U is over the cap)."""
    t = BITONIC_TILE_MAX
    while t > 1 and u_pad * t * 4 > SMEM_BYTES:
        t //= 2
    return t


# The largest power of two whose [U_pad, BITONIC_TILE_MIN] f32 tile fits.
BITONIC_MAX_U = 1 << ((SMEM_BYTES // (4 * BITONIC_TILE_MIN)).bit_length() - 1)
assert BITONIC_MAX_U == 8192 and bitonic_tile_d(BITONIC_MAX_U) == 4


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
    return out


sort_columns.launches = 0


def sort_columns_bitonic(x: Tensor, *, plain: bool = False) -> Tensor:
    """[U, D] | [S, U, D] -> the same shape, ascending along U, for U padded
    to a power of two up to BITONIC_MAX_U."""
    x3 = _as_lanes(x, "sort_columns_bitonic")
    s, u, d = x3.shape
    u_pad = pad_pow2(u)
    need(u_pad <= BITONIC_MAX_U,
         f"sort_columns_bitonic: padded U={u_pad} exceeds "
         f"BITONIC_MAX_U={BITONIC_MAX_U} (a [U_pad, {BITONIC_TILE_MIN}] f32 "
         f"tile no longer fits a block's {SMEM_BYTES} bytes of shared "
         f"memory)")
    if x.device.type == "cpu" or plain:
        return _plain(x)
    tile = bitonic_tile_d(u_pad)
    out = torch.empty_like(x)
    err = _build.library("defense_sort").sort_columns_bitonic(
        x.data_ptr(), out.data_ptr(), s, u, u_pad.bit_length() - 1,
        tile.bit_length() - 1, d, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sort_columns_bitonic")
    sort_columns_bitonic.launches += 1
    return out


sort_columns_bitonic.launches = 0

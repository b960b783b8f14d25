"""Fused FLOA aggregation kernels (the paper's hot spot, eq. 7-8).

Wrappers around the CUDA C++ kernel of `csrc/floa_aggregate.cu`, which
replaces the three Pallas kernels of `repro/kernels/floa_aggregate.py`:

  floa_step_batched       gagg = c @ G + bias + eps z;  w_new = w - alpha gagg
  floa_aggregate_batched  the same combine without the update
  floa_aggregate          the unbatched combine: the batched launch at S = 1

The route follows the tensors: CPU tensors take the plain PyTorch version of
`kernels/ref.py`, CUDA tensors launch the kernel (or raise).  `plain=True`
forces the plain version on the card too; it exists only so that a test can
hold the kernel route against the plain one, and the sweep never sets it.
Each wrapper counts its kernel launches in its `launches` attribute.

Bound and design (details in the .cu source): the pass reads the [S, U, D]
slab once and is bound by bytes; the paper's shapes (2-11 MB, warm in L2)
are bound by latency before that.  A lane of a warp takes V neighbouring
columns (8- or 16-byte loads where D and the pointers allow,
`vector_width`) and walks a fixed slice of the workers; a block's 8 warps
are KU worker slices x 8 / KU column groups, the slices' partial sums added
in warp order in shared memory.  `combine_plan` picks (V, KU) per shape:
the widest vector D and every pointer allow (all U rows of a column share
it); then an f32 combine of at most MAX_FIXED_U workers (the paper's
U = 10) takes one slice and the kernel's compile-time U, which puts every
load of a lane in flight at once, and a larger U (the U = 1000 grid's single
lane) the fewest slices whose grid reaches TARGET_BLOCKS_PER_SM blocks an
SM.  The ragged D edge is masked per vector in the kernel, so the wrappers
never pad D.  The plan is cached per shape; launches are counted per
wrapper in `launches`, and by (S, U, D) in `shapes`.
"""
from __future__ import annotations

import collections
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

MAX_LANES = 65535          # grid.y limit
MAX_WORKERS = 2**31 - 1    # the kernel's int U
THREADS = 256              # csrc/floa_aggregate.cu::THREADS, 8 warps
WARPS = THREADS // 32
WORKER_SLICES = (1, 2, 4, 8)   # KU: warps that split one column group's U
# The fewest worker slices whose grid reaches this many blocks an SM.
TARGET_BLOCKS_PER_SM = 2
# f32 combines of at most this many workers take the kernel's compile-time
# U (every load of a lane in flight at once) and one worker slice.
MAX_FIXED_U = 16           # csrc/floa_aggregate.cu::MAX_FIXED_U


def vector_width(d: int, g_esize: int, w_esize: int, align: int) -> int:
    """V, the columns a lane loads at once: the widest of 8, 4, 2, 1 whose
    loads of G (and of w, `w_esize` bytes an element) are at most 16 bytes,
    divide D, and fit `align`, the largest power of two (at most 16) that
    divides every data pointer."""
    for v in (8, 4, 2):
        if (d % v == 0 and v * max(g_esize, w_esize) <= 16
                and align % (v * g_esize) == 0
                and align % (v * w_esize) == 0):
            return v
    return 1


def warp_slices(u: int, ku: int) -> List[Tuple[int, int]]:
    """The workers [u0, u1) that worker slice k of KU sums, as the kernel
    cuts them: [k*U // KU, (k+1)*U // KU)."""
    return [(k * u // ku, (k + 1) * u // ku) for k in range(ku)]


def combine_plan(s: int, u: int, d: int, g_esize: int, w_esize: int,
                 align: int, sms: int) -> Tuple[int, int]:
    """(V, KU) for an [S, U, D] combine on a card of `sms` SMs: V from
    `vector_width`; KU = 1 for an f32 combine of at most MAX_FIXED_U
    workers (the kernel's compile-time U), else the smallest of
    WORKER_SLICES (at most U) whose grid, S * ceil(D / V / (8 / KU * 32))
    blocks, reaches TARGET_BLOCKS_PER_SM * sms, else the largest at most
    U."""
    vec = vector_width(d, g_esize, w_esize, align)
    if g_esize == w_esize == 4 and u <= MAX_FIXED_U:
        return vec, 1
    n_vec = d // vec
    ku = 1
    for k in WORKER_SLICES:
        if k > u:
            break
        ku = k
        per_block = (WARPS // k) * 32
        if s * -(-n_vec // per_block) >= TARGET_BLOCKS_PER_SM * sms:
            break
    return vec, ku


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _plan(device_index: int, s: int, u: int, d: int, g_dtype, w_dtype,
          align: int) -> Tuple[int, int]:
    return combine_plan(s, u, d, g_dtype.itemsize, w_dtype.itemsize, align,
                        _sms(device_index))


def _align(*ptrs: int) -> int:
    """The largest power of two, at most 16, that divides every pointer."""
    bits = 16
    for p in ptrs:
        bits |= p
    return bits & -bits


def _check_combine(coeffs, grads, noise, bias, eps) -> Tuple[int, int, int]:
    need(isinstance(grads, torch.Tensor) and grads.dim() == 3,
         "grads must be an [S, U, D] tensor")
    s, u, d = grads.shape
    dev = grads.device
    need(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    need(1 <= s <= MAX_LANES, f"S={s} outside [1, {MAX_LANES}]")
    need(1 <= u <= MAX_WORKERS, f"U={u} outside [1, {MAX_WORKERS}]")
    need(d >= 1, "D must be positive")
    check_tensor("grads", grads, (s, u, d), tuple(DTYPE_CODES), dev)
    check_tensor("coeffs", coeffs, (s, u), (torch.float32,), dev)
    check_tensor("noise", noise, (s, d), (grads.dtype,), dev)
    check_tensor("bias", bias, (s,), (torch.float32,), dev)
    check_tensor("eps", eps, (s,), (torch.float32,), dev)
    return s, u, d


def _on_card(x: Tensor, plain: bool) -> bool:
    return x.device.type == "cuda" and not plain


def _launch_combine(coeffs, grads, noise, bias, eps) -> Tensor:
    s, u, d = grads.shape
    gp, zp = grads.data_ptr(), noise.data_ptr()
    vec, ku = _plan(grads.device.index, s, u, d, grads.dtype, grads.dtype,
                    _align(gp, zp))
    out = torch.empty((s, d), dtype=grads.dtype, device=grads.device)
    err = _build.library("floa_aggregate").floa_aggregate_batched(
        coeffs.data_ptr(), gp, zp, bias.data_ptr(), eps.data_ptr(),
        out.data_ptr(), s, u, d, DTYPE_CODES[grads.dtype], vec, ku,
        torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "floa_aggregate_batched")
    return out


def floa_aggregate_batched(coeffs: Tensor, grads: Tensor, noise: Tensor,
                           bias: Tensor, eps: Tensor, *,
                           plain: bool = False) -> Tensor:
    """coeffs [S, U] f32, grads [S, U, D] f32|bf16, noise [S, D] (grads'
    dtype), bias/eps [S] f32 -> [S, D] in grads' dtype."""
    _check_combine(coeffs, grads, noise, bias, eps)
    if not _on_card(grads, plain):
        return ref.floa_aggregate_batched_ref(coeffs, grads, noise, bias, eps)
    out = _launch_combine(coeffs, grads, noise, bias, eps)
    floa_aggregate_batched.launches += 1
    floa_aggregate_batched.shapes[tuple(grads.shape)] += 1
    return out


floa_aggregate_batched.launches = 0
floa_aggregate_batched.shapes = collections.Counter()


def floa_step_batched(w: Tensor, coeffs: Tensor, grads: Tensor, noise: Tensor,
                      bias: Tensor, eps: Tensor, alpha: Tensor, *,
                      plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Fused [S, U, D] combine + PS update (eq. 7 + eq. 8).

    w [S, D] f32|bf16, coeffs [S, U] f32, grads [S, U, D] f32|bf16,
    noise [S, D] (grads' dtype), bias/eps/alpha [S] f32 ->
    (w_new [S, D] in w's dtype, gagg [S, D] in grads' dtype)."""
    s, u, d = _check_combine(coeffs, grads, noise, bias, eps)
    check_tensor("w", w, (s, d), tuple(DTYPE_CODES), grads.device)
    check_tensor("alpha", alpha, (s,), (torch.float32,), grads.device)
    if not _on_card(grads, plain):
        return ref.floa_step_batched_ref(w, coeffs, grads, noise, bias, eps,
                                         alpha)
    wp, gp, zp = w.data_ptr(), grads.data_ptr(), noise.data_ptr()
    vec, ku = _plan(grads.device.index, s, u, d, grads.dtype, w.dtype,
                    _align(wp, gp, zp))
    w_new = torch.empty_like(w)
    gagg = torch.empty((s, d), dtype=grads.dtype, device=grads.device)
    err = _build.library("floa_aggregate").floa_step_batched(
        wp, coeffs.data_ptr(), gp, zp, bias.data_ptr(), eps.data_ptr(),
        alpha.data_ptr(), w_new.data_ptr(), gagg.data_ptr(), s, u, d,
        DTYPE_CODES[grads.dtype], DTYPE_CODES[w.dtype], vec, ku,
        torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "floa_step_batched")
    floa_step_batched.launches += 1
    floa_step_batched.shapes[(s, u, d)] += 1
    return w_new, gagg


floa_step_batched.launches = 0
floa_step_batched.shapes = collections.Counter()


def floa_aggregate(coeffs: Tensor, grads: Tensor, noise: Tensor, bias,
                   eps, *, plain: bool = False) -> Tensor:
    """coeffs [U] f32, grads [U, D], noise [D], bias/eps scalars -> [D].

    The batched kernel launched at S = 1 on unsqueezed views, with the
    S = 1 plan."""
    need(isinstance(grads, torch.Tensor) and grads.dim() == 2,
         "grads must be a [U, D] tensor")
    dev = grads.device
    bias = torch.as_tensor(bias, dtype=torch.float32, device=dev).reshape(1)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev).reshape(1)
    need(coeffs.dim() == 1 and noise.dim() == 1,
         "coeffs must be [U] and noise [D]")
    c2, g3, z2 = coeffs[None], grads[None], noise[None]
    _check_combine(c2, g3, z2, bias, eps)
    if not _on_card(grads, plain):
        return ref.floa_aggregate_ref(coeffs, grads, noise, bias[0], eps[0])
    out = _launch_combine(c2, g3, z2, bias, eps)
    floa_aggregate.launches += 1
    floa_aggregate.shapes[tuple(g3.shape)] += 1
    return out[0]


floa_aggregate.launches = 0
floa_aggregate.shapes = collections.Counter()

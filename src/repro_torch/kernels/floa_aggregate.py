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
slab once and is bound by bytes; one thread per column, the lane's U
coefficients in shared memory, the ragged D edge masked in the kernel, so
the wrappers never pad D.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

MAX_LANES = 65535          # grid.y limit
MAX_WORKERS = 48 * 1024 // 4  # the U coefficients fit the 48 KB default smem


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
    out = torch.empty((s, d), dtype=grads.dtype, device=grads.device)
    err = _build.library("floa_aggregate").floa_aggregate_batched(
        coeffs.data_ptr(), grads.data_ptr(), noise.data_ptr(),
        bias.data_ptr(), eps.data_ptr(), out.data_ptr(), s, u, d,
        DTYPE_CODES[grads.dtype],
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
    return out


floa_aggregate_batched.launches = 0


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
    w_new = torch.empty_like(w)
    gagg = torch.empty((s, d), dtype=grads.dtype, device=grads.device)
    err = _build.library("floa_aggregate").floa_step_batched(
        w.data_ptr(), coeffs.data_ptr(), grads.data_ptr(), noise.data_ptr(),
        bias.data_ptr(), eps.data_ptr(), alpha.data_ptr(), w_new.data_ptr(),
        gagg.data_ptr(), s, u, d, DTYPE_CODES[grads.dtype],
        DTYPE_CODES[w.dtype],
        torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "floa_step_batched")
    floa_step_batched.launches += 1
    return w_new, gagg


floa_step_batched.launches = 0


def floa_aggregate(coeffs: Tensor, grads: Tensor, noise: Tensor, bias,
                   eps, *, plain: bool = False) -> Tensor:
    """coeffs [U] f32, grads [U, D], noise [D], bias/eps scalars -> [D].

    The batched kernel launched at S = 1 on unsqueezed views."""
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
    return out[0]


floa_aggregate.launches = 0

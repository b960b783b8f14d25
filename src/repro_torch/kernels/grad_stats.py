"""Per-row gradient statistics kernel (standardization round, eq. 3).

Wrapper around the CUDA C++ kernel of `csrc/grad_stats.cu`, which replaces
the Pallas kernel `repro/kernels/grad_stats.py::grad_stats`: rows [R, D] ->
[R, 2] f32 (sum, sum of squares).  The sweep engine hands it the [S*U, D]
rows of its gradient slab; the mean/variance follow on scalars
(`core/standardize.py::flat_scalar_stats`).

CPU tensors take the plain version (`kernels/ref.py::grad_stats_ref`), CUDA
tensors launch the kernel or raise; `plain=True` forces the plain version
for kernel-vs-plain tests.  Launches are counted in `grad_stats.launches`.

Bound and design (details in the .cu source): one read of R*D elements,
bound by bytes; one block per row with a fixed warp-shuffle tree, so the
result is deterministic without atomics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

MAX_ROWS = 2**31 - 1  # grid.x limit


def grad_stats(grads: Tensor, *, plain: bool = False) -> Tensor:
    """grads [R, D] f32|bf16 -> [R, 2] f32 (sum, sum of squares)."""
    need(isinstance(grads, torch.Tensor) and grads.dim() == 2,
         "grads must be an [R, D] tensor")
    r, d = grads.shape
    need(grads.device.type in ("cpu", "cuda"),
         f"unsupported device {grads.device}")
    need(1 <= r <= MAX_ROWS and d >= 1, f"bad shape {(r, d)}")
    check_tensor("grads", grads, (r, d), tuple(DTYPE_CODES), grads.device)
    if grads.device.type == "cpu" or plain:
        return ref.grad_stats_ref(grads)
    out = torch.empty((r, 2), dtype=torch.float32, device=grads.device)
    err = _build.library("grad_stats").grad_stats(
        grads.data_ptr(), out.data_ptr(), r, d, DTYPE_CODES[grads.dtype],
        torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "grad_stats")
    grad_stats.launches += 1
    return out


grad_stats.launches = 0

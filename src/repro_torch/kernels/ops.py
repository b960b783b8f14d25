"""Public entry points for the port's CUDA kernels, plus the plain oracles.

The same names as `repro/kernels/ops.py`, without its `interpret` argument:
the route follows the tensors' device (CPU -> the plain PyTorch version,
CUDA -> the hand-written kernel).  The entry points here are the wrapper
functions themselves, so `ops.<name>.launches` is the wrapper's own launch
count.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.defense_sort import (
    BITONIC_MAX_U,
    UNROLL_MAX_U,
    sort_columns,
    sort_columns_bitonic,
)
from repro_torch.kernels.floa_aggregate import (
    floa_aggregate,
    floa_aggregate_batched,
    floa_step_batched,
)
from repro_torch.kernels.grad_stats import (
    grad_stats,
    grad_stats_fixed,
    grad_stats_segments,
)
from repro_torch.kernels.noisy_update import counter_trunc_normal, noisy_sgd

# Every ported kernel wrapper, by name.
KERNELS = {
    "floa_step_batched": floa_step_batched,
    "floa_aggregate_batched": floa_aggregate_batched,
    "floa_aggregate": floa_aggregate,
    "grad_stats": grad_stats,
    "grad_stats_segments": grad_stats_segments,
    "sort_columns": sort_columns,
    "sort_columns_bitonic": sort_columns_bitonic,
    "decode_attention": decode_attention,
    "noisy_sgd": noisy_sgd,
    "counter_trunc_normal": counter_trunc_normal,
}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0 (and its count by shape)."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_shapes() -> Dict[str, Dict[Tuple[int, ...], int]]:
    """Launches by input shape, for the wrappers that count them (the FLOA
    kernels by (S, U, D), grad_stats by (R, D) and its fixed-order route by
    (R, leaf sizes), the sorts by their input's shape, [U, D] or
    [S, U, D])."""
    return {name: dict(fn.shapes) for name, fn in KERNELS.items()
            if hasattr(fn, "shapes")}


# oracles re-exported for tests/benchmarks
floa_aggregate_ref = ref.floa_aggregate_ref
floa_aggregate_batched_ref = ref.floa_aggregate_batched_ref
floa_step_batched_ref = ref.floa_step_batched_ref
grad_stats_ref = ref.grad_stats_ref
sort_columns_ref = ref.sort_columns_ref
sort_columns_batched_ref = ref.sort_columns_batched_ref
decode_attention_ref = ref.decode_attention_ref

"""FLOA gradient aggregation — the paper's eq. (6)-(8) on flat gradients.

The wireless MAC's superposition is a weighted reduction over the worker
axis.  The sweep keeps per-worker gradients as one [S, U, D] slab and hands
it to the fused CUDA kernels of `kernels/floa_aggregate.py`:

    per-worker grads  g[S, U, D]    torch.func.vmap(torch.func.grad(...))
    round stats       gbar, eps2    core.standardize (grad_stats kernel)
    channel + power   s[S, U]       core.scenario
    OTA superposition + de-standardization bias + receiver noise (+ update)
                                    batched_floa_combine / batched_floa_step

Routing follows the tensors' device, with no size threshold: the JAX
package's `BATCHED_KERNEL_MIN_D = 1 << 16` was measured for a TPU, and the
port takes the kernel on CUDA at every D until the H100 has its own number.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core import attacks as A
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import PowerConfig
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FLOAConfig:
    """Everything needed to simulate one FLOA round."""

    channel: ChannelConfig
    power: PowerConfig
    attack: A.AttackConfig = dataclasses.field(
        default_factory=lambda: A.AttackConfig())

    @property
    def num_workers(self) -> int:
        return self.channel.num_workers

    def validate(self) -> "FLOAConfig":
        if self.channel.num_workers != self.power.num_workers:
            raise ValueError("channel and power configs disagree on U")
        if (self.attack.byzantine_mask
                and len(self.attack.byzantine_mask) != self.num_workers):
            raise ValueError("byzantine_mask must have one entry per worker")
        return self


def per_worker_grads(loss_fn: Callable, params, batch: Dict[str, Tensor],
                     num_workers: int):
    """Per-worker gradients of loss_fn(params, batch) over a worker-split
    batch: leaves [U*B, ...] -> [U, B, ...], then vmap(grad) over U.

    params may be one tensor (a flat row) or a dict of tensors; the result
    has the same structure with a leading U axis."""
    def split(x):
        if x.shape[0] % num_workers:
            raise ValueError(f"global batch {x.shape[0]} not divisible by "
                             f"U={num_workers}")
        return x.reshape(num_workers, x.shape[0] // num_workers, *x.shape[1:])

    worker_batch = {k: split(v) for k, v in batch.items()}
    return vmap(grad(loss_fn), in_dims=(None, 0))(params, worker_batch)


def flatten_worker_grads(grads_u: Dict[str, Tensor], batch_dims: int = 1):
    """Dict with [*lead, ...] leaves -> ([*lead, D] f32 matrix, unflatten).

    Leaves are concatenated in SORTED key order — the order in which
    `jax.tree_util.tree_flatten` visits a dict — so a flat row here is the
    JAX package's flat row (b1 | b2 | w1 | w2 for the paper MLP).
    unflatten maps a [*lead[:-1], D] aggregate back to the dict."""
    keys = sorted(grads_u)
    first = grads_u[keys[0]]
    lead = first.shape[:batch_dims]
    shapes = {k: grads_u[k].shape[batch_dims:] for k in keys}
    dtypes = {k: grads_u[k].dtype for k in keys}
    flat = torch.cat([grads_u[k].reshape(*lead, -1).float() for k in keys],
                     dim=-1)

    def unflatten(vec: Tensor) -> Dict[str, Tensor]:
        out, off = {}, 0
        for k in keys:
            n = shapes[k].numel()
            out[k] = (vec[..., off:off + n]
                      .reshape(*vec.shape[:-1], *shapes[k]).to(dtypes[k]))
            off += n
        return out

    return flat, unflatten


def batched_floa_combine(coeffs: Tensor, flat: Tensor, noise: Tensor,
                         bias: Tensor, eps: Tensor, *,
                         plain: bool = False) -> Tensor:
    """[S, U, D] OTA combine: out[s] = coeffs[s] @ flat[s] + bias[s] + eps[s] z[s]."""
    return ops.floa_aggregate_batched(coeffs, flat, noise, bias, eps,
                                      plain=plain)


def batched_floa_step(w: Tensor, alpha: Tensor, coeffs: Tensor, flat: Tensor,
                      noise: Tensor, bias: Tensor, eps: Tensor, *,
                      plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Fused [S, U, D] OTA combine + PS update (eq. 7 + eq. 8), flat state.

        gagg[s]  = coeffs[s] @ flat[s] + bias[s] + eps[s] * noise[s]
        w_new[s] = w[s] - alpha[s] * gagg[s]

    Returns (w_new, gagg); gagg is materialized so the sweep can log grad
    norms without re-deriving it from the update."""
    return ops.floa_step_batched(w, coeffs, flat, noise, bias, eps, alpha,
                                 plain=plain)

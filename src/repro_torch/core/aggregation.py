"""FLOA gradient aggregation — the paper's eq. (6)-(8).

The wireless MAC's superposition is a weighted reduction over the worker
axis.  Two paths compute it:

  - `aggregate` / `floa_grad`, the looped trainer's branching path on
    gradient dicts of one scenario: per-leaf stats, `signed_coefficients`,
    a per-leaf weighted sum over U (`_weighted_reduce`, a tensordot, as in
    the reference, where it reaches no Pallas kernel), bias, receiver noise
    and jamming per leaf;
  - the sweep's flat path, which keeps per-worker gradients as one
    [S, U, D] slab and hands it to the fused CUDA kernels of
    `kernels/floa_aggregate.py`:

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
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core import attacks as A
from repro_torch.core import standardize as S
from repro_torch.core.channel import ChannelConfig, sample_channel_gains
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.kernels import ops
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

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
                     num_workers: int, *, fixed_shapes: bool = False):
    """Per-worker gradients of loss_fn(params, batch) over a worker-split
    batch: leaves [U*B, ...] -> [U, B, ...], then vmap(grad) over U.

    params may be one tensor (a flat row) or a nested dict of tensors; the
    result has the same structure with a leading U axis.

    By default vmap folds the workers into the rows of each matmul (one
    [U*B, ...] product), whose rounding may depend on U.  fixed_shapes=True
    hands each worker its own (expanded, copy-free) view of params, so each
    worker's products are batch entries of [B, ...] rows: a worker's
    gradient is then bitwise the same whatever the number of workers in the
    call (the sweep's strict_numerics, where a worker-sharded rank holds
    ceil(U / W) of them)."""
    def split(x):
        if x.shape[0] % num_workers:
            raise ValueError(f"global batch {x.shape[0]} not divisible by "
                             f"U={num_workers}")
        return x.reshape(num_workers, x.shape[0] // num_workers, *x.shape[1:])

    worker_batch = {k: split(v) for k, v in batch.items()}
    if not fixed_shapes:
        return vmap(grad(loss_fn), in_dims=(None, 0))(params, worker_batch)
    params = tree_map(lambda p: p[None].expand(num_workers, *p.shape), params)
    return vmap(grad(loss_fn), in_dims=(0, 0))(params, worker_batch)


def _weighted_reduce(grads_u: Dict[str, Tensor], weights: Tensor
                     ) -> Dict[str, Tensor]:
    """sum_i weights[i] * g_i over the leading worker axis (the OTA sum),
    one tensordot per leaf."""
    return tree_map(lambda g: torch.tensordot(weights.to(g.dtype), g,
                                              dims=([0], [0])), grads_u)


def _leaf_noise(generator: Optional[torch.Generator],
               template: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Standard-normal f32 draws shaped like each leaf of `template` (a
    nested dict), drawn leaf by leaf in the JAX package's leaf order (keys
    sorted at every level) from one generator (the reference's
    `_sharded_noise` draws each leaf from its own folded key; the caller
    scales them)."""
    leaves, treedef = tree_flatten(template)
    return tree_unflatten(treedef, [
        torch.randn(x.shape, generator=generator, device=x.device)
        for x in leaves])


def round_draws(cfg: FLOAConfig, template: Dict[str, Tensor],
                generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None,
                jam_generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
    """The random draws one `aggregate` round of `cfg` consumes, on the
    device of `template` (a dict of aggregate-shaped leaves):
    {"h_abs": [U] or None, "z": leaf dict or None, "jam": leaf dict or
    None}.  Gains come from `generator`, noise and jamming from their own
    generators when given (else from `generator` too, in that order).
    EF rounds draw nothing."""
    out = {"h_abs": None, "z": None, "jam": None}
    if cfg.power.policy == Policy.EF:
        return out
    dev = tree_leaves(template)[0].device
    out["h_abs"] = sample_channel_gains(generator, cfg.channel, dev)
    if cfg.channel.noise_std > 0.0:
        out["z"] = _leaf_noise(noise_generator or generator, template)
    if (cfg.attack.attack == A.AttackType.GAUSSIAN
            and cfg.attack.num_attackers):
        out["jam"] = _leaf_noise(jam_generator or generator, template)
    return out


def aggregate(grads_u: Dict[str, Tensor], cfg: FLOAConfig, *,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, object]] = None
              ) -> Tuple[Dict[str, Tensor], dict]:
    """One FLOA round of one scenario: per-worker grads {k: [U, ...]} ->
    the noisy aggregate (eq. 7), and aux (the round's |h|, coefficients and
    stats).

    The round's random draws are an input: `draws` as `round_draws` builds
    them ({"h_abs": [U], "z" / "jam": dicts of leaf-shaped standard
    normals, or None}), else drawn from `generator` by `round_draws`.  EF
    is the error-free benchmark: h = 1, z = 0, attackers a sign-flipped
    mean share."""
    cfg.validate()
    u = cfg.num_workers
    dev = tree_leaves(grads_u)[0].device
    gbar_i, eps2_i = S.per_worker_scalar_stats(grads_u)
    gbar, eps2 = S.global_stats(gbar_i, eps2_i)

    if cfg.power.policy == Policy.EF:
        sign = torch.ones((u,), device=dev)
        if (cfg.attack.byzantine_mask
                and cfg.attack.attack != A.AttackType.NONE):
            sign = torch.where(cfg.attack.mask().to(dev), -1.0, 1.0)
        s = sign / u
        aux = dict(h_abs=torch.ones((u,), device=dev), coeffs=s, gbar=gbar,
                   eps2=eps2, bias_w=torch.zeros((), device=dev))
        return _weighted_reduce(grads_u, s), aux

    template = tree_map(lambda g: g[0], grads_u)
    if draws is None:
        draws = round_draws(cfg, template, generator)
    h_abs = draws["h_abs"]
    s, bias_w = A.signed_coefficients(h_abs, cfg.power, cfg.channel,
                                      cfg.attack, gbar, eps2)
    # OTA superposition, then the attackers' de-standardization bias
    gagg = _weighted_reduce(grads_u, s)
    gagg = tree_map(lambda g: g + (bias_w * gbar).to(g.dtype), gagg)
    # receiver AWGN, scaled by eps_t (eq. 7 fourth term)
    eps = torch.sqrt(eps2)
    if cfg.channel.noise_std > 0.0:
        z = draws["z"]
        gagg = tree_map(lambda g, zk: g + eps.to(g.dtype)
                        * (cfg.channel.noise_std * zk).to(g.dtype), gagg, z)
    # unstructured jamming (GAUSSIAN only)
    jam_std = A.gaussian_jam_std(h_abs, cfg.power, cfg.attack, eps2)
    if (cfg.attack.attack == A.AttackType.GAUSSIAN
            and cfg.attack.num_attackers):
        jam = draws["jam"]
        gagg = tree_map(lambda g, jk: g + jam_std.to(g.dtype)
                        * jk.to(g.dtype), gagg, jam)
    aux = dict(h_abs=h_abs, coeffs=s, gbar=gbar, eps2=eps2, bias_w=bias_w)
    return gagg, aux


def mean_aggregate(grads_u: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Plain FedSGD mean (the EF path without the FLOA bookkeeping)."""
    return tree_map(lambda g: g.mean(dim=0), grads_u)


def floa_grad(loss_fn: Callable, params, batch: Dict[str, Tensor],
              cfg: FLOAConfig, *, generator=None, draws=None):
    """Per-worker grads + FLOA aggregation in one call: (gagg, aux)."""
    grads_u = per_worker_grads(loss_fn, params, batch, cfg.num_workers)
    return aggregate(grads_u, cfg, generator=generator, draws=draws)


def flatten_worker_grads(grads_u: Dict[str, Tensor], batch_dims: int = 1):
    """Nested dict with [*lead, ...] leaves -> ([*lead, D] f32 matrix,
    unflatten).

    Leaves are concatenated in the order in which `jax.tree_util` visits a
    nested dict (keys sorted at every level, `repro_torch.tree`), so a flat
    row here is the JAX package's flat row (b1 | b2 | w1 | w2 for the paper
    MLP).  unflatten maps a [*lead[:-1], D] aggregate back to the tree."""
    leaves, treedef = tree_flatten(grads_u)
    lead = leaves[0].shape[:batch_dims]
    shapes = [x.shape[batch_dims:] for x in leaves]
    dtypes = [x.dtype for x in leaves]
    flat = torch.cat([x.reshape(*lead, -1).float() for x in leaves], dim=-1)

    def unflatten(vec: Tensor) -> Dict[str, Tensor]:
        out, off = [], 0
        for shape, dtype in zip(shapes, dtypes):
            n = shape.numel()
            out.append(vec[..., off:off + n]
                       .reshape(*vec.shape[:-1], *shape).to(dtype))
            off += n
        return tree_unflatten(treedef, out)

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

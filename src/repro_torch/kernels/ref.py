"""Plain PyTorch versions of every ported kernel (the allclose ground truth).

Same dtype rules as the JAX oracles in `repro/kernels/ref.py`: accumulate in
float32, cast each output as the JAX oracle casts it.  These run wherever a
kernel wrapper is handed CPU tensors, and `chip_smoke.py` holds each CUDA
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def floa_aggregate_ref(coeffs: Tensor, grads: Tensor, noise: Tensor,
                       bias: Tensor, eps: Tensor) -> Tensor:
    """out[d] = sum_u coeffs[u] grads[u,d] + bias + eps * noise[d].

    coeffs [U] f32, grads [U, D], noise [D], bias/eps scalars.  f32 accumulate.
    """
    acc = torch.einsum("u,ud->d", coeffs.float(), grads.float())
    return (acc + bias + eps * noise.float()).to(grads.dtype)


def floa_aggregate_batched_ref(coeffs: Tensor, grads: Tensor, noise: Tensor,
                               bias: Tensor, eps: Tensor) -> Tensor:
    """out[s,d] = sum_u coeffs[s,u] grads[s,u,d] + bias[s] + eps[s] noise[s,d].

    coeffs [S, U] f32, grads [S, U, D], noise [S, D], bias/eps [S].
    """
    acc = torch.einsum("su,sud->sd", coeffs.float(), grads.float())
    out = acc + bias[:, None] + eps[:, None] * noise.float()
    return out.to(grads.dtype)


def floa_step_batched_ref(w: Tensor, coeffs: Tensor, grads: Tensor,
                          noise: Tensor, bias: Tensor, eps: Tensor,
                          alpha: Tensor):
    """Fused combine + PS update for a scenario sweep.

    gagg[s,d]  = sum_u coeffs[s,u] grads[s,u,d] + bias[s] + eps[s] noise[s,d]
    w_new[s,d] = w[s,d] - alpha[s] * gagg[s,d]

    Returns (w_new, gagg).  As in the JAX oracle, gagg is rounded to the
    gradient dtype BEFORE the update (the CUDA kernel updates from the f32
    aggregate, as the Pallas kernel does; in bf16 the two differ within the
    bf16 tolerance).
    """
    gagg = floa_aggregate_batched_ref(coeffs, grads, noise, bias, eps)
    w_new = w.float() - alpha[:, None].float() * gagg.float()
    return w_new.to(w.dtype), gagg


def sort_columns_ref(x: Tensor) -> Tensor:
    """[U, D] -> [U, D] ascending along the worker axis (dim 0): the plain
    version of both coordinate-sort kernels (finite inputs; the kernels'
    min/max compare-exchanges do not reproduce sort's NaN ordering)."""
    return torch.sort(x, dim=0).values


def sort_columns_batched_ref(x: Tensor) -> Tensor:
    """[S, U, D] -> [S, U, D] ascending along the worker axis (dim 1)."""
    return torch.sort(x, dim=1).values


def grad_stats_ref(grads: Tensor) -> Tensor:
    """Per-row [R, 2] f32: (sum_d g, sum_d g^2) — the eq. (3) stats."""
    g = grads.float()
    return torch.stack([g.sum(dim=1), (g * g).sum(dim=1)], dim=1)


def grad_stats_segments_ref(rows: Tensor, sizes) -> Tensor:
    """Per-row [R, 2] f32 over leaf segments: `grad_stats_ref` of each
    segment of `sizes` (flatten order) on a view of the rows, the pairs
    added in leaf order from 0 (the strict_numerics stats)."""
    off, s1, s2 = 0, 0, 0
    for n in sizes:
        part = grad_stats_ref(rows[:, off:off + n])
        s1, s2 = s1 + part[:, 0], s2 + part[:, 1]
        off += n
    return torch.stack([s1, s2], dim=1)


def decode_attention_ref(q: Tensor, k: Tensor, v: Tensor, pos) -> Tensor:
    """GQA decode: one query token against a KV cache.

    q [B, H, dh]; k/v [B, S, KV, dh]; pos a scalar (Python int or 0-d
    tensor; cache positions > pos are masked with -1e30, so a pos >= S,
    a ring-buffer cache's, attends every slot).  Returns
    [B, H, dh].  As in the JAX oracle, the scores are the product in the
    input dtype, then f32 and scaled by 1/sqrt(dh); the softmax is f32 and
    the probabilities are cast to v's dtype before the PV product.
    """
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k).float() / math.sqrt(dh)
    future = torch.arange(s, device=q.device) > torch.as_tensor(
        pos, device=q.device)
    scores = scores.masked_fill(future, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v.dtype), v)
    return out.reshape(b, h, dh)

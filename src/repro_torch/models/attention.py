"""GQA attention of the port: weights, q/k/v with qk-norm and RoPE, and the
one-token KV-cache decode step (`repro/models/attention.py`).

Weight layout as in the JAX package: wq [d, H, hd], wk/wv [d, KV, hd],
wo [H, hd, d].  The projections are plain `torch.matmul`s over the
flattened head axes; the attention of a decode step is the hand-written
CUDA kernel behind `kernels/ops.py::decode_attention`.

Only the dense, native-dtype cache of full attention is ported.  A window
(the ring-buffer cache of sliding-window archs and of long_500k's SWA),
`kv_cache_dtype="int8"` and MLA raise NotImplementedError (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (ModelConfig, ParamInit, rms_norm,
                                       rope_cos_sin, rope_rotate)

Tensor = torch.Tensor

NOT_PORTED = "is not ported (ROADMAP.md Queue 1 item 10)"


def init_gqa(pi: ParamInit, cfg: ModelConfig) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": pi.param((d, h, hd), fan_in=d),
         "wk": pi.param((d, kv, hd), fan_in=d),
         "wv": pi.param((d, kv, hd), fan_in=d),
         "wo": pi.param((h, hd, d), fan_in=h * hd)}
    if cfg.qk_norm:
        p["q_norm"] = pi.param((hd,), init="zeros")
        p["k_norm"] = pi.param((hd,), init="zeros")
    return p


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """x [B, S, d] @ w [d, N, hd] -> [B, S, N, hd]."""
    d, n, hd = w.shape
    return (x @ w.reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _qkv(p: Dict, x: Tensor, cfg: ModelConfig,
         rope: Optional[Tuple[Tensor, Tensor]]
         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Projection, then qk-norm (RMS over hd), then RoPE on q and k; v gets
    neither.  x [B, S, d], rope the (cos, sin) of the positions [B, S]
    (`rope_cos_sin`) -> [B, S, heads, hd] each."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        q, k = rope_rotate(q, *rope), rope_rotate(k, *rope)
    return q, k, v


def check_cache_supported(cfg: ModelConfig, window: Optional[int]) -> None:
    """Raise on the cache layouts the port does not have yet."""
    if window:
        raise NotImplementedError(f"a windowed (ring-buffer) KV cache, "
                                  f"window={window}, {NOT_PORTED}")
    if cfg.kv_cache_dtype != "native":
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} "
                                  f"{NOT_PORTED}")
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA decode {NOT_PORTED}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], dtype, device=None) -> Dict[str, Tensor]:
    """Zeroed KV cache of one attention layer: k/v [B, max_len, KV, hd]."""
    check_cache_supported(cfg, window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(p: Dict, x1: Tensor, cache: Dict[str, Tensor], pos,
                cfg: ModelConfig, window: Optional[int] = None, *,
                rope: Optional[Tuple[Tensor, Tensor]] = None,
                plain: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode.  x1 [B, 1, d]; pos the 0-based index of the new
    token (an int, or a 0-d integer tensor on x1's device: then nothing
    syncs with the host); cache k/v [B, S, KV, hd] with pos < S.  `rope`,
    the (cos, sin) of pos, lets a caller compute them once for every layer.

    Unlike the JAX package, which returns a new cache, the port writes k1/v1
    into slot pos of the given cache tensors in place and returns the same
    dict.  The attention over slots <= pos is `ops.decode_attention` (the
    CUDA kernel on the card; `plain=True` takes its plain version)."""
    check_cache_supported(cfg, window)
    b = x1.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x1.device)
    if rope is None:
        rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    q, k1, v1 = _qkv(p, x1, cfg, rope)
    slot = pos.reshape(1).long()
    cache["k"].index_copy_(1, slot, k1)
    cache["v"].index_copy_(1, slot, v1)
    out = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                               pos, plain=plain)
    h, hd, d = p["wo"].shape
    y = out.reshape(b, 1, h * hd) @ p["wo"].reshape(h * hd, d)
    return y, cache

"""GQA attention of the port: weights, q/k/v with qk-norm and RoPE, the
full-sequence attention of training and prefill, and the one-token KV-cache
decode step (`repro/models/attention.py`).

Weight layout as in the JAX package: wq [d, H, hd], wk/wv [d, KV, hd],
wo [H, hd, d].  The projections are plain `torch.matmul`s over the
flattened head axes; the attention of a decode step is the hand-written
CUDA kernel behind `kernels/ops.py::decode_attention`.  The full-sequence
attention (`gqa_full`: `_gqa_core` over query chunks of Q_CHUNK) is plain
`torch.einsum` and softmax in f32, as the reference computes it in XLA
einsums outside any Pallas kernel.  The encoder-decoder
`cross_attention` is not ported (ROADMAP.md Queue 1 item 10).

Only the dense, native-dtype cache of full attention is ported.  A window
(the ring-buffer cache of sliding-window archs and of long_500k's SWA),
`kv_cache_dtype="int8"` and MLA raise NotImplementedError (ROADMAP.md
Queue 1 item 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (ModelConfig, ParamInit,
                                       make_causal_mask, rms_norm,
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


def _gqa_core(q: Tensor, k: Tensor, v: Tensor,
              mask: Optional[Tensor]) -> Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> [B, Sq, H, hd]; scores and
    softmax in f32, masked-out scores set to -1e30 (mask broadcasts to
    [B, KV, G, Sq, Sk])."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k).float()
    # sqrt(hd) rounded in f32, as the reference's jnp.sqrt(float32(hd)),
    # taken on the host: a device scalar built from a host value would
    # wait for the stream
    scores = scores / float(torch.tensor(float(hd)).sqrt())
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs, v)
    return out.reshape(b, sq, h, hd)


Q_CHUNK = 1024  # query-block size for memory-bounded full attention


def _chunked_attn(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: Optional[int], q_chunk: int = Q_CHUNK) -> Tensor:
    """Query-chunked attention: the scores never exceed
    [B, H, q_chunk, Sk] at once (the chunks run one after another; each
    chunk's causal mask is offset by its first query's position)."""
    b, sq, h, hd = q.shape
    if sq <= q_chunk:
        mask = (make_causal_mask(sq, sq, 0, window, q.device)[None, None, None]
                if causal else None)
        return _gqa_core(q, k, v, mask)
    if sq % q_chunk:
        raise ValueError(f"sequence {sq} is not a multiple of the query "
                         f"chunk {q_chunk}")
    outs = []
    for off in range(0, sq, q_chunk):
        mask = (make_causal_mask(q_chunk, sq, off, window,
                                 q.device)[None, None, None]
                if causal else None)
        outs.append(_gqa_core(q[:, off:off + q_chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def gqa_full(p: Dict, x: Tensor, cfg: ModelConfig, positions: Tensor,
             window: Optional[int] = None, causal: bool = True) -> Tensor:
    """Self-attention over a full [B, S, d] block (train / prefill);
    positions [B, S]."""
    rope = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, rope)
    out = _chunked_attn(q, k, v, causal, window)
    h, hd, d = p["wo"].shape
    return out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)


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

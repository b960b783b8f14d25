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

The native-dtype cache is ported, full or windowed: a window makes it a
ring buffer of min(max_len, window) slots (sliding-window archs, and
long_500k's SWA variant), written at slot pos % slots.  The reference
rebuilds each slot's true position and masks `kpos <= pos, kpos >= 0,
kpos > pos - window`; over a ring of `slots` that is exactly "every slot
<= min(pos, slots - 1)", which the decode attention applies itself (it
clamps its valid length to min(pos + 1, S)), and the softmax does not
depend on slot order (RoPE is applied to k at its true position when it
is written).  `kv_cache_dtype="int8"` and MLA raise NotImplementedError
(ROADMAP.md Queue 1 item 10).

Over a "model" axis of M ranks (`common.tensor_parallel`) each rank holds
the query heads axis.part(H) of wq and wo (the reference's `_wspec`
prefers the head dims) and computes their attention: the input enters
through `copy_in`, and wo's partial product leaves through one
`reduce_out`.  Its KV heads are axis.part(KV) when M divides KV.  When it
does not, the reference's spec shards wk / wv on d instead (the smoke
qwen3-4b and starcoder2-3b at M = 4): the rank's k / v projection is a
partial product over its d rows, summed over the ranks (one all_reduce,
and one in the backward), and the rank keeps the KV heads its query heads
read (`local_heads`; M a multiple of KV).  A rank's decode cache holds
those KV heads only: where KV does not divide, the reference's
`cache_specs` shards another dim of the cache (hd, or the sequence), and
the port does not copy that, since the decode kernel reads whole heads.
It changes no value.  Query heads M does not divide raise
NotImplementedError (`check_heads`).

The sequence-sharded decode of the reference (`decode_local_partial`,
`combine_partials`: each rank holds a shard of the cache's positions and
the partial softmax states are combined with a max and two sums) is plain
torch here, as the reference's is jnp; its pmax and psums are all_reduces
over a process group.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.launch.distributed import (all_reduce_max, all_reduce_sum,
                                            copy_in, reduce_out)
from repro_torch.launch.mesh import Q_MODEL_AXIS
from repro_torch.models.common import (ModelConfig, ParamInit,
                                       make_causal_mask, model_shards,
                                       rms_norm, rope_cos_sin, rope_rotate)

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


def check_heads(cfg: ModelConfig, m: int) -> None:
    """Raise NotImplementedError unless the port computes cfg's attention
    over m "model" ranks: m divides the query heads, and divides the KV
    heads or (wk / wv sharded on d) divides d and is a multiple of KV."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if m > 1 and (h % m or (kv % m and (m % kv or cfg.d_model % m))):
        raise NotImplementedError(
            f"{cfg.name} on {m} \"model\" ranks (H {h}, KV {kv}, d "
            f"{cfg.d_model}): {Q_MODEL_AXIS}")


def local_heads(cfg: ModelConfig, m: int, index: int) -> Tuple[slice, slice]:
    """(query heads, KV heads) of "model" rank `index` of m: its
    H / m query heads, and the KV heads they read (KV / m of them, or one
    when m is a multiple of KV)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hq = h // m
    if kv % m == 0:
        return slice(index * hq, (index + 1) * hq), slice(
            index * kv // m, (index + 1) * kv // m)
    g = index * hq * kv // h
    return slice(index * hq, (index + 1) * hq), slice(g, g + 1)


def _qkv(p: Dict, x: Tensor, cfg: ModelConfig,
         rope: Optional[Tuple[Tensor, Tensor]]
         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Projection, then qk-norm (RMS over hd), then RoPE on q and k; v gets
    neither.  x [B, S, d], rope the (cos, sin) of the positions [B, S]
    (`rope_cos_sin`) -> [B, S, heads, hd] each (this rank's heads under
    `tensor_parallel`)."""
    axis = model_shards()
    if axis is None:
        q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
        norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else None
    else:
        x = copy_in(x, axis.group)
        q = _proj(x, p["wq"])
        if cfg.n_kv_heads % axis.size == 0:
            k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
        else:   # wk / wv sharded on d: partial products, summed
            xd = x[..., axis.part(cfg.d_model)]
            kv = torch.cat([_proj(xd, p["wk"]), _proj(xd, p["wv"])], dim=-2)
            kv = copy_in(reduce_out(kv, axis.group), axis.group)
            heads = local_heads(cfg, axis.size, axis.index)[1]
            k = kv[..., heads, :]
            v = kv[..., cfg.n_kv_heads:, :][..., heads, :]
        # replicated scales on this rank's heads: their gradient is summed
        norms = (copy_in(torch.stack([p["q_norm"], p["k_norm"]]),
                         axis.group) if cfg.qk_norm else None)
    if norms is not None:
        q = rms_norm(q, norms[0], cfg.norm_eps)
        k = rms_norm(k, norms[1], cfg.norm_eps)
    if rope is not None:
        q, k = rope_rotate(q, *rope), rope_rotate(k, *rope)
    return q, k, v


def _out(p: Dict, out: Tensor) -> Tensor:
    """The output projection of [B, S, H, hd] attention: wo's product, the
    ranks' partial products summed under `tensor_parallel`."""
    h, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], h * hd) @ p["wo"].reshape(h * hd, d)
    axis = model_shards()
    return y if axis is None else reduce_out(y, axis.group)


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
    return _out(p, _chunked_attn(q, k, v, causal, window))


def check_cache_supported(cfg: ModelConfig) -> None:
    """Raise on the cache layouts the port does not have yet."""
    if cfg.kv_cache_dtype != "native":
        raise NotImplementedError(f"kv_cache_dtype={cfg.kv_cache_dtype!r} "
                                  f"{NOT_PORTED}")
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA decode {NOT_PORTED}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], dtype, device=None,
               model_parallel: int = 1) -> Dict[str, Tensor]:
    """Zeroed KV cache of one attention layer: k/v [B, slots, KV, hd], a ring
    of slots = min(max_len, window) if windowed, else max_len; over
    model_parallel ranks, the KV heads of one rank (`local_heads`)."""
    check_cache_supported(cfg)
    check_heads(cfg, model_parallel)
    slots = min(max_len, window) if window else max_len
    kv = local_heads(cfg, model_parallel, 0)[1]
    shape = (batch, slots, kv.stop - kv.start, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(p: Dict, x1: Tensor, cache: Dict[str, Tensor], pos,
                cfg: ModelConfig, window: Optional[int] = None, *,
                rope: Optional[Tuple[Tensor, Tensor]] = None,
                plain: bool = False) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode.  x1 [B, 1, d]; pos the 0-based index of the new
    token (an int, or a 0-d integer tensor on x1's device: then nothing
    syncs with the host); cache k/v [B, S, KV, hd] with pos < S, or, with
    a window, a ring of S slots and any pos >= 0.  `rope`, the (cos, sin)
    of pos, lets a caller compute them once for every layer.

    Unlike the JAX package, which returns a new cache, the port writes k1/v1
    into the given cache tensors in place, at slot pos (pos % S when
    windowed, computed on the device), and returns the same dict.  The
    attention over slots <= min(pos, S - 1) is `ops.decode_attention` with
    the true pos (the CUDA kernel on the card; `plain=True` takes its plain
    version)."""
    check_cache_supported(cfg)
    b = x1.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x1.device)
    if rope is None:
        rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    q, k1, v1 = _qkv(p, x1, cfg, rope)
    slot = pos.reshape(1).long()
    if window:
        slot = torch.remainder(slot, cache["k"].shape[1])
    cache["k"].index_copy_(1, slot, k1)
    cache["v"].index_copy_(1, slot, v1)
    out = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                               pos, plain=plain)
    return _out(p, out.reshape(b, 1, *out.shape[1:])), cache


def decode_local_partial(q: Tensor, k_loc: Tensor, v_loc: Tensor,
                         valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Partial flash-decode over a local shard of the KV positions.
    q [B, H, hd]; k_loc / v_loc [B, S_loc, KV, hd]; valid [B, S_loc] bool.
    Returns the partial softmax state (m [B, H], l [B, H], acc [B, H, hd]),
    f32: the largest score, the sum of exp(score - m) and the sum of
    exp(score - m) v over the shard's valid positions."""
    b, h, hd = q.shape
    kvh = k_loc.shape[2]
    qg = q.reshape(b, kvh, h // kvh, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_loc).float()
    s = s / float(torch.tensor(float(hd)).sqrt())
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    m = s.amax(dim=-1)                                       # [B, KV, G]
    e = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgs,bshd->bhgd", e.to(v_loc.dtype), v_loc)
    return (m.reshape(b, h), e.sum(dim=-1).reshape(b, h),
            acc.reshape(b, h, hd).float())


def combine_partials(m: Tensor, l: Tensor, acc: Tensor,
                     group=None) -> Tensor:
    """The partial softmax states of every rank of `group` combined into the
    attention output [B, H, hd] (f32): the reference's pmax of m, then the
    psums of l and acc rescaled to the global max (one all_reduce for
    both).  group None combines this rank's state alone."""
    mg = all_reduce_max(m, group)
    scale = torch.exp(m - mg)
    la = all_reduce_sum(torch.cat([(l * scale)[..., None],
                                   acc * scale[..., None]], dim=-1), group)
    return la[..., 1:] / torch.clamp_min(la[..., :1], 1e-30)

"""Attention of the port: GQA (weights, q/k/v with qk-norm and RoPE, the
full-sequence attention of training and prefill, the one-token KV-cache
decode step) and DeepSeek-V2's multi-head latent attention (MLA)
(`repro/models/attention.py`).

GQA weight layout as in the JAX package: wq [d, H, hd], wk/wv [d, KV, hd],
wo [H, hd, d].  The projections are plain `torch.matmul`s over the
flattened head axes; the attention of a decode step is the hand-written
CUDA kernel behind `kernels/ops.py::decode_attention`.  The full-sequence
attention (`gqa_full`: `_gqa_core` over query chunks of Q_CHUNK) is plain
`torch.einsum` and softmax in f32, as the reference computes it in XLA
einsums outside any Pallas kernel.  The encoder-decoder's cross-attention
(`encode_kv`, `cross_attention`, `cross_decode`: no RoPE, every encoder
position valid) is the same plain attention, non-causal, over a full
decoder block; one decoder token's runs through the decode-attention
kernel at pos = Se - 1.

The native-dtype cache is ported, full or windowed: a window makes it a
ring buffer of min(max_len, window) slots (sliding-window archs, and
long_500k's SWA variant), written at slot pos % slots.  The reference
rebuilds each slot's true position and masks `kpos <= pos, kpos >= 0,
kpos > pos - window`; over a ring of `slots` that is exactly "every slot
<= min(pos, slots - 1)", which the decode attention applies itself (it
clamps its valid length to min(pos + 1, S)), and the softmax does not
depend on slot order (RoPE is applied to k at its true position when it
is written).  A local_attn block (the RG-LRU hybrid) is this GQA
attention with window=cfg.local_window: its ring holds min(max_len,
local_window) slots.

`kv_cache_dtype="int8"` (the reference's `init_cache` / `_quantize_kv` /
`_dequantize_kv`) stores k / v as int8 [B, slots, KV, hd] with f16
absmax scales k_scale / v_scale [B, slots, KV]: the scale is max |x| /
127 over hd in f32, floored at 1e-8, and the values are
clip(round(x / scale), -127, 127), rounded half to even as `jnp.round`
rounds.  A decode step quantizes the new k / v, writes all four leaves in
place at its slot, dequantizes the whole cache to q's dtype (an f32
multiply, then the cast) and runs `ops.decode_attention` on it, the same
CUDA kernel as the native cache's; a kernel that reads int8 with its
scales fused in is not written (ROADMAP.md Queue 2 item 7).  The MLA
latent cache and the SSD and RG-LRU states ignore the flag, as in the
reference.

MLA (`init_mla`, `mla_full`, `init_mla_cache`, `mla_decode_step`) is plain
torch, as the reference's is plain einsums outside any Pallas kernel:
wq_a [d, q_lora] and q_norm, wq_b [q_lora, H, nope + rope], wkv_a
[d, kv_lora + rope] and kv_norm, wk_b [kv_lora, H, nope], wv_b
[kv_lora, H, v], wo [H, v, d].  Training and prefill materialize each
head's K / V from the latent (`mla_full`, the reference's query chunking
and its casts); decode is the absorbed form over a cache of the latent
c_kv [B, S, kv_lora] and the shared rope keys k_rope [B, S, rope], which
it writes in place at slot pos, as the GQA decode does (full attention
always: long_500k keeps its 524 288 slots).

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
NotImplementedError (`check_heads`).  MLA splits wq_a on q_lora (each
rank's columns of the latent query, gathered with
`launch.distributed.gather_shards`), wq_b / wk_b / wv_b / wo on the heads;
wkv_a and the norms are replicated and enter through `copy_in`, and every
rank keeps the whole latent cache, since each head reads all of it (the
reference's `cache_specs` splits kv_lora or the sequence; it changes no
value).  M must divide H and q_lora.

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
                                            copy_in, gather_shards,
                                            reduce_out)
from repro_torch.launch.mesh import Q_MODEL_AXIS
from repro_torch.models.common import (ModelConfig, ParamInit,
                                       make_causal_mask, model_shards,
                                       rms_norm, rope_cos_sin, rope_rotate)

Tensor = torch.Tensor

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
    """Raise NotImplementedError unless the port computes cfg's mixers
    over m "model" ranks: for GQA m divides the query heads, and divides
    the KV heads or (wk / wv sharded on d) divides d and is a multiple of
    KV; for MLA m divides the heads and q_lora; for the SSD block m
    divides its heads (d_inner / headdim); for the RG-LRU block m divides
    its width."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if m == 1:
        return
    bad = False
    if cfg.ssm is not None:
        bad = (cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim) % m != 0
    if "rglru" in cfg.block_pattern:
        bad = bad or (cfg.rglru_width or cfg.d_model) % m != 0
    if any(k not in ("ssm", "rglru") for k in cfg.block_pattern):
        if cfg.mla is not None:
            bad = bad or h % m != 0 or cfg.mla.q_lora % m != 0
        else:
            bad = bad or h % m != 0 or (kv % m != 0 and (
                m % kv != 0 or cfg.d_model % m != 0))
    if bad:
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


def _kv_heads(p: Dict, x: Tensor, cfg: ModelConfig,
              axis) -> Tuple[Tensor, Tensor]:
    """k and v [B, S, heads, hd] of x [B, S, d] (through `copy_in` under a
    "model" axis): every KV head, or this rank's (wk / wv split on the
    heads; or on d when M does not divide KV: the partial products
    summed, then the KV heads of this rank's query heads)."""
    if axis is None or cfg.n_kv_heads % axis.size == 0:
        return _proj(x, p["wk"]), _proj(x, p["wv"])
    xd = x[..., axis.part(cfg.d_model)]
    kv = torch.cat([_proj(xd, p["wk"]), _proj(xd, p["wv"])], dim=-2)
    kv = copy_in(reduce_out(kv, axis.group), axis.group)
    heads = local_heads(cfg, axis.size, axis.index)[1]
    return kv[..., heads, :], kv[..., cfg.n_kv_heads:, :][..., heads, :]


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
        k, v = _kv_heads(p, x, cfg, axis)
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


def _replicated(w: Tensor, axis) -> Tensor:
    """A replicated leaf read on this rank's heads (`copy_in`: its gradient
    summed over the "model" group)."""
    return w if axis is None else copy_in(w, axis.group)


def _cross_q(p: Dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The cross-attention query [B, S, heads, hd] of x [B, S, d]: no RoPE,
    q_norm under qk_norm; this rank's heads under `tensor_parallel`."""
    axis = model_shards()
    q = _proj(_replicated(x, axis), p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, _replicated(p["q_norm"], axis), cfg.norm_eps)
    return q


def encode_kv(p: Dict, enc_out: Tensor, cfg: ModelConfig
              ) -> Tuple[Tensor, Tensor]:
    """A decoder layer's cross K / V [B, Se, KV, hd] of the encoder output
    [B, Se, d]: no RoPE, k_norm under qk_norm (the reference's
    `encode_kv`); this rank's KV heads under `tensor_parallel`."""
    axis = model_shards()
    k, v = _kv_heads(p, _replicated(enc_out, axis), cfg, axis)
    if cfg.qk_norm:
        k = rms_norm(k, _replicated(p["k_norm"], axis), cfg.norm_eps)
    return k, v


def cross_attention(p: Dict, x: Tensor, enc_kv: Tuple[Tensor, Tensor],
                    cfg: ModelConfig) -> Tensor:
    """The decoder's cross-attention over a full [B, S, d] block (train /
    prefill): every query attends every encoder position of enc_kv
    (`encode_kv`), plain torch (`_chunked_attn`, non-causal), as the
    reference's XLA einsums."""
    k, v = enc_kv
    return _out(p, _chunked_attn(_cross_q(p, x, cfg), k, v, causal=False,
                                 window=None))


def cross_decode(p: Dict, x1: Tensor, enc_kv: Tuple[Tensor, Tensor],
                 cfg: ModelConfig, *, plain: bool = False) -> Tensor:
    """The cross-attention of one decoder token x1 [B, 1, d] over the Se
    encoder positions of enc_kv: the decode-attention kernel with
    pos = Se - 1, whose valid length min(pos + 1, Se) is every position
    and whose scale is the same 1 / sqrt(hd) (`plain=True` takes its plain
    version).  pos is made on the device, so the step needs no host
    sync."""
    k, v = enc_kv
    b = x1.shape[0]
    q = _cross_q(p, x1, cfg)
    pos = torch.full((), k.shape[1] - 1, dtype=torch.int32, device=k.device)
    out = ops.decode_attention(q[:, 0].contiguous(), k, v, pos, plain=plain)
    return _out(p, out.reshape(b, 1, *out.shape[1:]))


KV_CACHE_DTYPES = ("native", "int8")


def check_cache_supported(cfg: ModelConfig) -> None:
    """Raise ValueError on a kv_cache_dtype other than "native" and
    "int8"."""
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r}: not one "
                         f"of {KV_CACHE_DTYPES}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int], dtype, device=None,
               model_parallel: int = 1) -> Dict[str, Tensor]:
    """Zeroed KV cache of one attention layer: k/v [B, slots, KV, hd], a ring
    of slots = min(max_len, window) if windowed, else max_len; over
    model_parallel ranks, the KV heads of one rank (`local_heads`).  Under
    kv_cache_dtype="int8" k / v are int8 and k_scale / v_scale [B, slots,
    KV] f16 (the scales of the rank's KV heads)."""
    check_cache_supported(cfg)
    check_heads(cfg, model_parallel)
    slots = min(max_len, window) if window else max_len
    kv = local_heads(cfg, model_parallel, 0)[1]
    shape = (batch, slots, kv.stop - kv.start, cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """[..., hd] -> (int8 values [..., hd], f16 absmax scales [...]): the
    reference's `_quantize_kv`."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    """int8 values [..., hd] times their f16 scales [...], in f32, cast to
    `dtype`: the reference's `_dequantize_kv`."""
    return (q.float() * scale[..., None].float()).to(dtype)


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
    version).  An int8 cache (kv_cache_dtype="int8") gets the quantized
    k1 / v1 and their scales at the slot, and the attention reads the
    whole cache dequantized to q's dtype."""
    check_cache_supported(cfg)
    b = x1.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x1.device)
    if rope is None:
        rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    q, k1, v1 = _qkv(p, x1, cfg, rope)
    slot = pos.reshape(1).long()
    if window:
        slot = torch.remainder(slot, cache["k"].shape[1])
    if cfg.kv_cache_dtype == "int8":
        for name, x in (("k", k1), ("v", v1)):
            xq, xs = quantize_kv(x)
            cache[name].index_copy_(1, slot, xq)
            cache[name + "_scale"].index_copy_(1, slot, xs)
        ck = dequantize_kv(cache["k"], cache["k_scale"], q.dtype)
        cv = dequantize_kv(cache["v"], cache["v_scale"], q.dtype)
    else:
        cache["k"].index_copy_(1, slot, k1)
        cache["v"].index_copy_(1, slot, v1)
        ck, cv = cache["k"], cache["v"]
    out = ops.decode_attention(q[:, 0].contiguous(), ck, cv, pos,
                               plain=plain)
    return _out(p, out.reshape(b, 1, *out.shape[1:])), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(pi: ParamInit, cfg: ModelConfig) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {"wq_a": pi.param((d, m.q_lora), fan_in=d),
            "q_norm": pi.param((m.q_lora,), init="zeros"),
            "wq_b": pi.param((m.q_lora, h, qd), fan_in=m.q_lora),
            "wkv_a": pi.param((d, m.kv_lora + m.qk_rope_dim), fan_in=d),
            "kv_norm": pi.param((m.kv_lora,), init="zeros"),
            "wk_b": pi.param((m.kv_lora, h, m.qk_nope_dim),
                             fan_in=m.kv_lora),
            "wv_b": pi.param((m.kv_lora, h, m.v_dim), fan_in=m.kv_lora),
            "wo": pi.param((h, m.v_dim, d), fan_in=h * m.v_dim)}


def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope), rounded in f32 as the reference's
    1.0 / jnp.sqrt(float32(...)), taken on the host."""
    qd = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
    return float(1.0 / torch.tensor(float(qd)).sqrt())


def _mla_q(p: Dict, x: Tensor, cfg: ModelConfig,
           rope: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tensor]:
    """x [B, S, d] (already through `copy_in` under `tensor_parallel`),
    rope the (cos, sin) of the positions [B, S] at qk_rope_dim ->
    (q_nope [B, S, H, nope], q_rope [B, S, H, rope]), this rank's heads."""
    m = cfg.mla
    axis = model_shards()
    if axis is None:
        cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    else:   # this rank's q_lora columns, gathered
        cq = rms_norm(gather_shards(x @ p["wq_a"], axis.group),
                      copy_in(p["q_norm"], axis.group), cfg.norm_eps)
    q = _proj(cq, p["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope_rotate(q_rope, *rope)


def _mla_ckv(p: Dict, x: Tensor, cfg: ModelConfig,
             rope: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tensor]:
    """x [B, S, d] -> (c_kv [B, S, kv_lora], k_rope [B, S, rope]), whole on
    every rank (the replicated wkv_a and kv_norm enter through
    `copy_in`)."""
    m = cfg.mla
    axis = model_shards()
    wkv, norm = p["wkv_a"], p["kv_norm"]
    if axis is not None:
        wkv, norm = copy_in(wkv, axis.group), copy_in(norm, axis.group)
    kv_a = x @ wkv
    c_kv = rms_norm(kv_a[..., :m.kv_lora], norm, cfg.norm_eps)
    return c_kv, rope_rotate(kv_a[..., m.kv_lora:], *rope)


def _latent_proj(c: Tensor, w: Tensor) -> Tensor:
    """c [B, S, kv_lora] @ w [kv_lora, H, k] -> [B, S, H, k]."""
    e, h, k = w.shape
    return (c @ w.reshape(e, h * k)).reshape(*c.shape[:-1], h, k)


def _mla_out(p: Dict, out: Tensor) -> Tensor:
    """[B, S, H, v] through wo -> [B, S, d]; the ranks' partial products
    summed under `tensor_parallel`."""
    h, v, d = p["wo"].shape
    y = out.reshape(*out.shape[:-2], h * v) @ p["wo"].reshape(h * v, d)
    axis = model_shards()
    return y if axis is None else reduce_out(y, axis.group)


def mla_full(p: Dict, x: Tensor, cfg: ModelConfig, positions: Tensor,
             window: Optional[int] = None) -> Tensor:
    """Train / prefill MLA over x [B, S, d] at positions [B, S]: each head's
    K / V materialized from the latent (decode takes the absorbed form).
    The queries run in chunks of Q_CHUNK as the reference's do, with its
    rule: a length that is not a multiple of Q_CHUNK, or one chunk's
    worth, runs as one chunk.  Scores in the activation dtype, then f32
    times the scale; the probabilities cast to v's dtype."""
    m = cfg.mla
    axis = model_shards()
    if axis is not None:
        x = copy_in(x, axis.group)
    rope = rope_cos_sin(positions, m.qk_rope_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    c_kv, k_rope = _mla_ckv(p, x, cfg, rope)
    k_nope = _latent_proj(c_kv, p["wk_b"])
    v = _latent_proj(c_kv, p["wv_b"])
    scale = _mla_scale(cfg)
    sq = x.shape[1]
    qc = Q_CHUNK
    if sq % qc or max(sq // qc, 1) == 1:
        qc = sq
    outs = []
    for off in range(0, sq, qc):
        qn, qr = q_nope[:, off:off + qc], q_rope[:, off:off + qc]
        s = (torch.einsum("bqhk,bshk->bhqs", qn, k_nope)
             + torch.einsum("bqhk,bsk->bhqs", qr, k_rope)).float() * scale
        mask = make_causal_mask(qc, sq, off, window, x.device)
        s = s.masked_fill(~mask, -1e30)
        probs = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqs,bshk->bqhk", probs, v))
    return _mla_out(p, outs[0] if len(outs) == 1 else torch.cat(outs, 1))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None, model_parallel: int = 1) -> Dict[str, Tensor]:
    """Zeroed latent cache of one MLA layer: c_kv [B, max_len, kv_lora] and
    k_rope [B, max_len, rope], whole on every "model" rank (every head
    reads all of it)."""
    check_cache_supported(cfg)
    check_heads(cfg, model_parallel)
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode_step(p: Dict, x1: Tensor, cache: Dict[str, Tensor], pos,
                    cfg: ModelConfig, *,
                    rope: Optional[Tuple[Tensor, Tensor]] = None
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Absorbed-form MLA decode of x1 [B, 1, d] at pos (an int, or a 0-d
    integer tensor on x1's device): the new token's latent and rope key
    are written into the cache in place at slot pos (pos < S), then
    q_eff = q_nope . wk_b scores the [B, S, kv_lora] latent, q_rope the
    rope keys, over the slots <= pos (the rest set to -1e30); the context
    stays in the latent until wv_b and wo.  `rope`, the (cos, sin) of pos
    at qk_rope_dim, lets a caller compute them once for every layer.
    Returns ([B, 1, d], the same cache dict)."""
    m = cfg.mla
    axis = model_shards()
    if axis is not None:
        x1 = copy_in(x1, axis.group)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x1.device)
    if rope is None:
        rope = rope_cos_sin(pos.reshape(1, 1), m.qk_rope_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(p, x1, cfg, rope)            # [B, 1, H, *]
    c1, r1 = _mla_ckv(p, x1, cfg, rope)                  # [B, 1, *]
    slot = pos.reshape(1).long()
    cache["c_kv"].index_copy_(1, slot, c1)
    cache["k_rope"].index_copy_(1, slot, r1)
    ck, cr = cache["c_kv"], cache["k_rope"]
    # absorb wk_b into the query: q_eff [B, H, kv_lora]
    q_eff = torch.einsum("bhk,ehk->bhe", q_nope[:, 0], p["wk_b"])
    s = (torch.bmm(q_eff, ck.transpose(1, 2))
         + torch.bmm(q_rope[:, 0], cr.transpose(1, 2))).float()
    s = s * _mla_scale(cfg)
    valid = torch.arange(ck.shape[1], device=ck.device) <= pos
    s = s.masked_fill(~valid, -1e30)
    probs = torch.softmax(s, dim=-1).to(ck.dtype)
    ctx = torch.bmm(probs, ck)                           # [B, H, kv_lora]
    out = torch.einsum("bhe,ehk->bhk", ctx, p["wv_b"])   # [B, H, v]
    return _mla_out(p, out[:, None]), cache


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

"""The encoder-decoder of the port (SeamlessM4T-v2 large's text / speech
transformer; `repro/models/encdec.py`).

The modality frontend is stubbed, as in the reference: the encoder consumes
precomputed frame embeddings [B, T, feat] through `enc_in`.  The encoder is
a bidirectional GQA stack (RoPE at the frame positions, no mask), the
decoder a causal one with a cross-attention to the encoder output in every
layer (`attention.encode_kv` / `cross_attention`: no RoPE), each block
pre-norm with a SwiGLU.  The parameter tree is the reference's: `enc_in`
[feat, d], `enc_norm`, `embed` [Vp, d], `dec_norm`, `lm_head` [d, Vp], and
the stacked `enc_blocks` {ln1, attn, ln2, ffn} and `dec_blocks` {ln1,
self_attn, ln_x, cross_attn, ln2, ffn} with a leading layer axis, so JAX
weights carry across with `transformer.params_from_jax`.  The JAX scans
over layers are Python loops, as in `models/transformer.py`, whose
embedding, head (`logits_from_hidden`) and chunked CE (`chunked_ce`: the
256k vocab needs it) the decoder reuses.

Decode keeps one self-attention KV cache per decoder layer, stacked
[L, B, S, KV, hd] (`init_dec_caches`), written in place at slot pos by
`attention.decode_step`, and the cross K / V of every layer precomputed
once from the encoder output (`precompute_cross_kv`, stacked [L, B, Se,
KV, hd] x 2).  A decode step's cross-attention is one query token over
all Se encoder positions: the decode-attention kernel at pos = Se - 1
(`attention.cross_decode`), as its self-attention is the kernel at the
token's pos; the full-sequence passes (training, prefill) are plain torch,
as the reference's are XLA einsums.

Under `common.tensor_parallel` the layers split as `transformer.py`'s do:
`enc_in` on its columns (each rank's columns of the frames' projection,
gathered into the replicated stream), the self- and cross-attentions on
their heads (a rank's caches and cross K / V hold its KV heads), the
SwiGLU on f, the embedding, head and CE on the vocab.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as ATT
from repro_torch.models import ffn as FFN
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, ParamInit, rms_norm,
                                       rope_cos_sin)
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor


def _init_enc_block(pi: ParamInit, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": pi.param((d,), init="zeros"),
            "attn": ATT.init_gqa(pi, cfg),
            "ln2": pi.param((d,), init="zeros"),
            "ffn": FFN.init_swiglu(pi, cfg)}


def _init_dec_block(pi: ParamInit, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": pi.param((d,), init="zeros"),
            "self_attn": ATT.init_gqa(pi, cfg),
            "ln_x": pi.param((d,), init="zeros"),
            "cross_attn": ATT.init_gqa(pi, cfg),
            "ln2": pi.param((d,), init="zeros"),
            "ffn": FFN.init_swiglu(pi, cfg)}


def init_encdec(generator: Optional[torch.Generator], cfg: ModelConfig,
                device=None, keep=None) -> Dict[str, Any]:
    """Random weights in the reference's layout, drawn from `generator` on
    its device (or `device`; on "meta" nothing is allocated), the stacked
    blocks one layer at a time (`ParamInit`); `keep` maps each leaf as it
    is drawn (a rank's shard: `launch.sharding.init_shards`)."""
    ed = cfg.encdec
    pi = ParamInit(generator, cfg.dtype, device, keep=keep)
    vp, d = cfg.padded_vocab, cfg.d_model
    fd = cfg.frontend.feature_dim if cfg.frontend else d
    params: Dict[str, Any] = {
        "enc_in": pi.param((fd, d), fan_in=fd),
        "enc_norm": pi.param((d,), init="zeros"),
        "embed": pi.param((vp, d), fan_in=d),
        "dec_norm": pi.param((d,), init="zeros"),
        "lm_head": pi.param((d, vp), fan_in=d)}
    for name, n, block in (("enc_blocks", ed.n_enc_layers, _init_enc_block),
                           ("dec_blocks", ed.n_dec_layers, _init_dec_block)):
        params[name] = block(ParamInit(generator, cfg.dtype, pi.device,
                                       stack=n, keep=keep), cfg)
    return params


def _positions(x: Tensor) -> Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


def encode(params: Dict, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """frames [B, T, feat] -> the encoder output [B, T, d]
    (bidirectional)."""
    x = T._column_product(frames.to(cfg.dtype), params["enc_in"], cfg)
    positions = _positions(x)
    for p in T._unstack(params["enc_blocks"], cfg.encdec.n_enc_layers):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + ATT.gqa_full(p["attn"], h, cfg, positions, causal=False)
        x = x + T._ffn("attn", p["ffn"], rms_norm(x, p["ln2"],
                                                  cfg.norm_eps), cfg)[0]
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_hidden(params: Dict, tokens: Tensor, enc_out: Tensor,
                  cfg: ModelConfig) -> Tensor:
    """The teacher-forced decoder over tokens [B, S] attending enc_out
    [B, Se, d] -> the final hidden [B, S, d]."""
    x = T.embed_tokens(params, tokens, cfg)
    positions = _positions(x)
    for p in T._unstack(params["dec_blocks"], cfg.encdec.n_dec_layers):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + ATT.gqa_full(p["self_attn"], h, cfg, positions)
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        kv = ATT.encode_kv(p["cross_attn"], enc_out, cfg)
        x = x + ATT.cross_attention(p["cross_attn"], hx, kv, cfg)
        x = x + T._ffn("attn", p["ffn"], rms_norm(x, p["ln2"],
                                                  cfg.norm_eps), cfg)[0]
    return rms_norm(x, params["dec_norm"], cfg.norm_eps)


def decode_full(params: Dict, tokens: Tensor, enc_out: Tensor,
                cfg: ModelConfig) -> Tensor:
    """The teacher-forced decoder pass -> logits [B, S, Vp]."""
    return T.logits_from_hidden(params, decode_hidden(params, tokens,
                                                      enc_out, cfg), cfg)


def encdec_per_example_loss(params: Dict, batch: Dict,
                            cfg: ModelConfig) -> Tensor:
    """Per-sequence mean next-token CE [B] of batch {"frames" [B, T, feat],
    "tokens" [B, S + 1]}, the head applied lm_head_chunk positions at a
    time (`transformer.chunked_ce`)."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    h = decode_hidden(params, tokens[:, :-1], enc_out, cfg)
    return T.chunked_ce(params, h, tokens[:, 1:], cfg).mean(dim=-1)


def encdec_loss(params: Dict, batch: Dict, cfg: ModelConfig) -> Tensor:
    return encdec_per_example_loss(params, batch, cfg).mean()


# --- decode ------------------------------------------------------------------


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, device=None,
                    model_parallel: int = 1) -> Dict[str, Tensor]:
    """The decoder's self-attention caches, one GQA cache a layer
    (`attention.init_cache`, full attention) stacked [L, B, max_len, KV,
    hd]: the reference's `init_dec_caches`; over model_parallel "model"
    ranks, this rank's KV heads."""
    one = ATT.init_cache(cfg, batch, max_len, None, cfg.dtype, "meta",
                         model_parallel)
    return {k: torch.zeros((cfg.encdec.n_dec_layers,) + x.shape,
                           dtype=x.dtype, device=device)
            for k, x in one.items()}


def precompute_cross_kv(params: Dict, enc_out: Tensor,
                        cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Every decoder layer's cross K / V of enc_out [B, Se, d], stacked
    [L, B, Se, KV, hd] x 2 (this rank's KV heads under
    `tensor_parallel`)."""
    kv = [ATT.encode_kv(p["cross_attn"], enc_out, cfg) for p in
          T._unstack(params["dec_blocks"], cfg.encdec.n_dec_layers)]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def decode_step(params: Dict, caches: Dict[str, Tensor],
                cross_kv: Tuple[Tensor, Tensor], tokens1: Tensor, pos,
                cfg: ModelConfig, *, plain: bool = False
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decoder token: tokens1 [B, 1] at pos (an int or a 0-d integer
    tensor on the device), its self-attention against `caches`
    (`init_dec_caches`, written in place at slot pos) and its
    cross-attention against `cross_kv` (`precompute_cross_kv`), both
    through the decode-attention kernel (`plain=True`: its plain version).
    Returns (logits [B, 1, Vp], caches)."""
    ATT.check_cache_supported(cfg)
    n = cfg.encdec.n_dec_layers
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens1.device)
    rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    x = T.embed_tokens(params, tokens1, cfg)
    leaves, treedef = tree_flatten(caches)
    layer_caches = [tree_unflatten(treedef, list(c))
                    for c in zip(*(x.unbind(0) for x in leaves))]
    for p, c, ck, cv in zip(T._unstack(params["dec_blocks"], n),
                            layer_caches, cross_kv[0].unbind(0),
                            cross_kv[1].unbind(0)):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        h, _ = ATT.decode_step(p["self_attn"], h, c, pos, cfg, rope=rope,
                               plain=plain)
        x = x + h
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + ATT.cross_decode(p["cross_attn"], hx, (ck, cv), cfg,
                                 plain=plain)
        x = x + T._ffn("attn", p["ffn"], rms_norm(x, p["ln2"],
                                                  cfg.norm_eps), cfg)[0]
    h = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return T.logits_from_hidden(params, h, cfg), caches

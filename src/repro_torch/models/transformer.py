"""Decoder-only LM of the port: init, embeddings, the full-sequence forward
and loss of training and prefill, KV caches and the one-token decode step
(`repro/models/transformer.py`), for `block_pattern == ("attn",)` (dense
GQA blocks with SwiGLU, e.g. qwen3-4b).

The parameter and cache trees keep the JAX package's layout, including the
stacked `blocks` leaves with a leading layer axis, so JAX weights carry
across with `params_from_jax`.  The JAX scan over layers is a Python loop
over layer indices here, and `remat` has no counterpart: the backward
keeps every layer's activations.  `chunked_ce` projects `lm_head_chunk`
positions to logits at a time, as the reference does, without
`torch.utils.checkpoint` (it does not compose with `torch.func.grad` /
`vmap`, through which the sweep takes per-worker gradients).  Other block
kinds, MoE, MLA, SSM, encoder-decoder and frontends (a VLM's
`embeds_prefix`) raise NotImplementedError (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import ffn as FFN
from repro_torch.models.common import (ModelConfig, ParamInit, rms_norm,
                                       rope_cos_sin, softmax_xent)
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless cfg is a decoder-only stack of dense "attn" blocks."""
    if cfg.block_pattern != ("attn",):
        raise NotImplementedError(f"block_pattern {cfg.block_pattern} "
                                  f"{ATT.NOT_PORTED}")
    for sub in ("moe", "mla", "ssm", "encdec", "frontend"):
        if getattr(cfg, sub) is not None:
            raise NotImplementedError(f"{cfg.name}: {sub} {ATT.NOT_PORTED}")


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_scanned_repeats, n_tail_blocks)."""
    k = len(cfg.block_pattern)
    return cfg.n_layers // k, cfg.n_layers % k


def init_lm(generator: Optional[torch.Generator], cfg: ModelConfig,
            device=None) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn from `generator` on its
    device (or `device`; on "meta" nothing is allocated, for counting).
    Stacked leaves are drawn one layer at a time, so the model never exists
    in f32."""
    check_supported(cfg)
    pi = ParamInit(generator, cfg.dtype, device)
    vp, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {"embed": pi.param((vp, d), fan_in=d),
                              "final_norm": pi.param((d,), init="zeros")}
    if not cfg.tie_embeddings:
        params["lm_head"] = pi.param((d, vp), fan_in=d)
    n_rep, _ = layer_counts(cfg)
    stacked = ParamInit(generator, cfg.dtype, pi.device, stack=n_rep)
    params["blocks"] = {"b0": {
        "ln1": stacked.param((d,), init="zeros"),
        "attn": ATT.init_gqa(stacked, cfg),
        "ln2": stacked.param((d,), init="zeros"),
        "ffn": FFN.init_swiglu(stacked, cfg)}}
    return params


def _to_tensor(x: np.ndarray, device) -> Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":     # ml_dtypes' numpy bfloat16
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(x.copy(), device=device)


def params_from_jax(params_np: Dict[str, Any], device) -> Dict[str, Any]:
    """The JAX package's nested param dict (numpy leaves) -> the port's:
    the same layout, so a tree map."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else _to_tensor(v, device) for k, v in params_np.items()}


def embed_tokens(params: Dict, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params["embed"][tokens.long()]


def logits_from_hidden(params: Dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                window: Optional[int] = None, device=None) -> Dict:
    """Stacked decode caches {"blocks": {"b0": {"k", "v": [L, B, S, KV, hd]}}}.
    `window` overrides cfg.window (any window raises: not ported)."""
    check_supported(cfg)
    n_rep, _ = layer_counts(cfg)
    w_attn = window if window is not None else cfg.window
    one = ATT.init_cache(cfg, batch, max_len, w_attn, cfg.dtype, device)
    return {"blocks": {"b0": {
        k: torch.zeros((n_rep,) + x.shape, dtype=x.dtype, device=x.device)
        for k, x in one.items()}}}


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """The n layers of a stacked tree (views), each leaf unbound once: the
    backward of `unbind` stacks the layers' gradients in one pass, where a
    select per layer would each add a zero-filled gradient of the whole
    stack."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[i] for p in per_leaf])
            for i in range(n)]


def _apply_subblock(p: Dict, x: Tensor, positions: Tensor,
                    cfg: ModelConfig, window: Optional[int]) -> Tensor:
    """The full-sequence "attn" block: x + attn(norm(x)), then
    + swiglu(norm(x))."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + ATT.gqa_full(p["attn"], h, cfg, positions, window=window)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + FFN.swiglu(p["ffn"], h2)


def forward_hidden(params: Dict, x: Tensor, positions: Tensor,
                   cfg: ModelConfig, window: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Embedded inputs [B, S, d] -> (final hidden [B, S, d], aux loss).
    The aux loss is MoE's, so 0 for every ported config."""
    check_supported(cfg)
    window = window if window is not None else cfg.window
    n_rep, _ = layer_counts(cfg)
    for p in _unstack(params["blocks"]["b0"], n_rep):
        x = _apply_subblock(p, x, positions, cfg, window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def hidden_for_batch(params: Dict, tokens: Tensor, cfg: ModelConfig,
                     window: Optional[int] = None,
                     embeds_prefix: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> (final hidden [B, S, d], aux).  A projected
    prefix (`embeds_prefix`, the VLM / audio stubs) raises: the frontends
    are not ported."""
    if embeds_prefix is not None:
        raise NotImplementedError(f"embeds_prefix (the VLM / audio "
                                  f"frontends) {ATT.NOT_PORTED}")
    x = embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return forward_hidden(params, x, positions, cfg, window)


def forward(params: Dict, tokens: Tensor, cfg: ModelConfig,
            window: Optional[int] = None,
            embeds_prefix: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> (logits [B, S, Vp], aux)."""
    h, aux = hidden_for_batch(params, tokens, cfg, window, embeds_prefix)
    return logits_from_hidden(params, h, cfg), aux


def chunked_ce(params: Dict, h: Tensor, labels: Tensor,
               cfg: ModelConfig) -> Tensor:
    """Per-position CE [B, S] from hidden states [B, S, d], the lm_head
    applied to `cfg.lm_head_chunk` positions at a time (the last slice
    holds the remainder), so the [B, S, vocab] logits never exist at
    once."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    s = h.shape[1]
    ck = min(cfg.lm_head_chunk, s)
    return torch.cat([
        softmax_xent(h[:, i:i + ck] @ head, labels[:, i:i + ck],
                     cfg.vocab_size) for i in range(0, s, ck)], dim=1)


def lm_per_example_loss(params: Dict, batch: Dict, cfg: ModelConfig,
                        window: Optional[int] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Per-sequence mean next-token CE [B], and the aux loss.  batch:
    tokens [B, S + 1]; labels are the tokens shifted left."""
    tokens = batch["tokens"]
    h, aux = hidden_for_batch(params, tokens[:, :-1], cfg, window,
                              batch.get("embeds_prefix"))
    ce = chunked_ce(params, h, tokens[:, 1:], cfg)
    return ce.mean(dim=-1), aux


def lm_loss(params: Dict, batch: Dict, cfg: ModelConfig,
            window: Optional[int] = None) -> Tensor:
    """Next-token CE over the batch (the sweep's and the trainer's
    loss_fn: `lambda p, b: lm_loss(p, b, cfg)`)."""
    per_ex, _ = lm_per_example_loss(params, batch, cfg, window)
    return per_ex.mean()


def _decode_subblock(p: Dict, cache: Dict, x1: Tensor, pos,
                     cfg: ModelConfig, window: Optional[int],
                     rope: Tuple[Tensor, Tensor],
                     plain: bool) -> Tuple[Tensor, Dict]:
    """The "attn" block: x + attn(norm(x)), then + swiglu(norm(x))."""
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    h, cache = ATT.decode_step(p["attn"], h, cache, pos, cfg, window=window,
                               rope=rope, plain=plain)
    x1 = x1 + h
    h2 = rms_norm(x1, p["ln2"], cfg.norm_eps)
    return x1 + FFN.swiglu(p["ffn"], h2), cache


def decode_step(params: Dict, caches: Dict, tokens1: Tensor, pos,
                cfg: ModelConfig, window: Optional[int] = None, *,
                plain: bool = False) -> Tuple[Tensor, Dict]:
    """One decode step.  tokens1 [B, 1] integer, pos the 0-based index of the
    new token (an int or a 0-d integer tensor on the device).  Returns
    (logits [B, 1, Vp], caches); the caches are written in place (see
    `attention.decode_step`)."""
    check_supported(cfg)
    window = window if window is not None else cfg.window
    ATT.check_cache_supported(cfg, window)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens1.device)
    x = embed_tokens(params, tokens1, cfg)
    rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    n_rep, _ = layer_counts(cfg)
    for p, c in zip(_unstack(params["blocks"]["b0"], n_rep),
                    _unstack(caches["blocks"]["b0"], n_rep)):
        x, _ = _decode_subblock(p, c, x, pos, cfg, window, rope, plain)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, h, cfg), caches

"""Decoder-only LM of the port: init, embeddings, the full-sequence forward
and loss of training and prefill, KV caches and the one-token decode step
(`repro/models/transformer.py`), for the block kinds

  attn       causal self-attention (GQA) + SwiGLU
  attn_moe   causal self-attention (GQA) + MoE FFN (+ shared experts)

in any `block_pattern` of them (qwen3-4b, granite-8b and starcoder2-3b are
("attn",), moonshot ("attn_moe",), llama4 ("attn", "attn_moe")).  A
"super-block" is one repeat of the pattern: n_layers // len(pattern) of
them are stacked with a leading layer axis under `blocks` ({"b0", "b1",
...}, one sub-block per pattern entry), and the n_layers % len(pattern)
left over are unstacked `tail{t}` blocks of kind pattern[t].

The parameter and cache trees keep the JAX package's layout, so JAX weights
carry across with `params_from_jax` and a flat row lays its leaves out as
`jax.tree_util` does (`repro_torch.tree`).  The JAX scan over layers is a
Python loop over layer indices here, and `remat` has no counterpart: the
backward keeps every layer's activations.  `chunked_ce` projects
`lm_head_chunk` positions to logits at a time, as the reference does,
without `torch.utils.checkpoint` (it does not compose with
`torch.func.grad` / `vmap`, through which the sweep takes per-worker
gradients).  The other block kinds (local_attn, ssm, rglru), MLA, SSM,
encoder-decoder and frontends (a VLM's `embeds_prefix`) raise
NotImplementedError (ROADMAP.md Queue 1 item 10).

Under `common.tensor_parallel` (a "model" axis of M ranks, the parameters
this rank's shards, `launch/sharding.py`) the residual stream stays
replicated: the attention, the SwiGLU (wi / wg split on f, wo on f) and
the MoE each take their input through `copy_in` and reduce their output
once; the embedding is split on its vocab rows (each rank looks up the
ids in its rows, zeros elsewhere, one `reduce_out`), the head on its vocab
columns, and the CE is `softmax_xent_sharded`, so the [B, S, Vp] logits
are never gathered in training.  `logits_from_hidden` gathers the vocab
shards (prefill and decode).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import ffn as FFN
from repro_torch.models import moe as MOE
from repro_torch.launch.distributed import all_gather, copy_in, reduce_out
from repro_torch.models.common import (ModelConfig, ParamInit, model_shards,
                                       rms_norm, rope_cos_sin, softmax_xent,
                                       softmax_xent_sharded)
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor

BLOCK_KINDS = ("attn", "attn_moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless cfg is a decoder-only stack of ported block kinds
    ("attn", and "attn_moe" with a MoE config)."""
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise NotImplementedError(f"block_pattern {cfg.block_pattern}: "
                                      f"{kind!r} {ATT.NOT_PORTED}")
    if "attn_moe" in cfg.block_pattern and cfg.moe is None:
        raise ValueError(f"{cfg.name}: an attn_moe block needs cfg.moe")
    for sub in ("mla", "ssm", "encdec", "frontend"):
        if getattr(cfg, sub) is not None:
            raise NotImplementedError(f"{cfg.name}: {sub} {ATT.NOT_PORTED}")


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_scanned_repeats, n_tail_blocks)."""
    k = len(cfg.block_pattern)
    return cfg.n_layers // k, cfg.n_layers % k


def _init_subblock(pi: ParamInit, kind: str, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": pi.param((d,), init="zeros"),
            "attn": ATT.init_gqa(pi, cfg),
            "ln2": pi.param((d,), init="zeros"),
            "ffn": (MOE.init_moe(pi, cfg) if kind == "attn_moe"
                    else FFN.init_swiglu(pi, cfg))}


def init_lm(generator: Optional[torch.Generator], cfg: ModelConfig,
            device=None, keep=None) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn from `generator` on its
    device (or `device`; on "meta" nothing is allocated, for counting).
    Stacked leaves are drawn one layer at a time, so the model never exists
    in f32.  `keep` maps each leaf as it is drawn (`ParamInit`)."""
    check_supported(cfg)
    pi = ParamInit(generator, cfg.dtype, device, keep=keep)
    vp, d = cfg.padded_vocab, cfg.d_model
    params: Dict[str, Any] = {"embed": pi.param((vp, d), fan_in=d),
                              "final_norm": pi.param((d,), init="zeros")}
    if not cfg.tie_embeddings:
        params["lm_head"] = pi.param((d, vp), fan_in=d)
    n_rep, n_tail = layer_counts(cfg)
    if n_rep:
        stacked = ParamInit(generator, cfg.dtype, pi.device, stack=n_rep,
                            keep=keep)
        params["blocks"] = {f"b{i}": _init_subblock(stacked, kind, cfg)
                            for i, kind in enumerate(cfg.block_pattern)}
    for t in range(n_tail):
        params[f"tail{t}"] = {"b0": _init_subblock(pi, cfg.block_pattern[t],
                                                   cfg)}
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


def _vocab_axis(cfg: ModelConfig):
    """The `tensor_parallel` axis when it splits the vocab, else None."""
    axis = model_shards()
    return axis if axis is not None and axis.shards(cfg.padded_vocab) \
        else None


def embed_tokens(params: Dict, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    axis = _vocab_axis(cfg)
    if axis is None:
        return params["embed"][tokens.long()]
    emb = params["embed"]                        # this rank's vocab rows
    t = tokens.long() - axis.index * emb.shape[0]
    mine = (t >= 0) & (t < emb.shape[0])
    x = emb[torch.where(mine, t, 0)].masked_fill(~mine[..., None], 0.0)
    return reduce_out(x, axis.group)


def _head(params: Dict, cfg: ModelConfig) -> Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params: Dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    """h [..., d] -> the logits [..., Vp]; under `tensor_parallel` each
    rank's vocab columns, gathered."""
    axis = _vocab_axis(cfg)
    if axis is None:
        return h @ _head(params, cfg)
    return all_gather(copy_in(h, axis.group) @ _head(params, cfg),
                      axis.group, dim=-1)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                window: Optional[int] = None, device=None,
                model_parallel: int = 1) -> Dict:
    """Decode caches in the reference's layout: {"blocks": {"b<i>": {"k",
    "v": [L, B, S, KV, hd]}}} for the stacked super-blocks and
    {"tail<t>": {"b0": {"k", "v": [B, S, KV, hd]}}} for the tail blocks.
    `window` overrides cfg.window for every attention block (long_500k's
    SWA variant); a window makes each cache a ring of min(max_len, window)
    slots.  Over model_parallel "model" ranks, a rank's caches: the KV
    heads its query heads read (`attention.local_heads`)."""
    check_supported(cfg)
    n_rep, n_tail = layer_counts(cfg)
    w_attn = window if window is not None else cfg.window

    def one(stack=()):
        c = ATT.init_cache(cfg, batch, max_len, w_attn, cfg.dtype, "meta",
                           model_parallel)
        return {k: torch.zeros(stack + x.shape, dtype=x.dtype, device=device)
                for k, x in c.items()}

    caches: Dict[str, Any] = {}
    if n_rep:
        caches["blocks"] = {f"b{i}": one((n_rep,))
                            for i in range(len(cfg.block_pattern))}
    for t in range(n_tail):
        caches[f"tail{t}"] = {"b0": one()}
    return caches


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """The n layers of a stacked tree (views), each leaf unbound once: the
    backward of `unbind` stacks the layers' gradients in one pass, where a
    select per layer would each add a zero-filled gradient of the whole
    stack."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[i] for p in per_leaf])
            for i in range(n)]


def _layers(cfg: ModelConfig, tree: Dict) -> List[Tuple[str, Dict]]:
    """(kind, sub-block tree) of every layer in order: each stacked
    super-block's sub-blocks, then the tail blocks."""
    n_rep, n_tail = layer_counts(cfg)
    out = []
    if n_rep:
        for sb in _unstack(tree["blocks"], n_rep):
            out += [(kind, sb[f"b{i}"])
                    for i, kind in enumerate(cfg.block_pattern)]
    out += [(cfg.block_pattern[t], tree[f"tail{t}"]["b0"])
            for t in range(n_tail)]
    return out


def _ffn(kind: str, p: Dict, h: Tensor, cfg: ModelConfig
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's FFN: SwiGLU, or the MoE FFN and its aux loss; under
    `tensor_parallel` the SwiGLU's f is split when M divides it."""
    if kind == "attn_moe":
        return MOE.moe_ffn(p, h, cfg)
    axis = model_shards()
    if axis is None or not axis.shards(cfg.d_ff):
        return FFN.swiglu(p, h), None
    return reduce_out(FFN.swiglu(p, copy_in(h, axis.group)),
                      axis.group), None


def _apply_subblock(kind: str, p: Dict, x: Tensor, positions: Tensor,
                    cfg: ModelConfig, window: Optional[int]
                    ) -> Tuple[Tensor, Optional[Tensor]]:
    """The full-sequence block: x + attn(norm(x)), then + ffn(norm(x));
    returns (x, the MoE aux loss or None)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + ATT.gqa_full(p["attn"], h, cfg, positions, window=window)
    y, aux = _ffn(kind, p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def forward_hidden(params: Dict, x: Tensor, positions: Tensor,
                   cfg: ModelConfig, window: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Embedded inputs [B, S, d] -> (final hidden [B, S, d], aux loss):
    the aux loss is the sum of the MoE blocks' load-balance losses (0 for
    a dense model), f32."""
    check_supported(cfg)
    window = window if window is not None else cfg.window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in _layers(cfg, params):
        x, a = _apply_subblock(kind, p, x, positions, cfg, window)
        if a is not None:
            aux = aux + a
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
    once.  Under `tensor_parallel` each chunk's logits are this rank's
    vocab columns (`softmax_xent_sharded`)."""
    head = _head(params, cfg)
    s = h.shape[1]
    ck = min(cfg.lm_head_chunk, s)
    axis = _vocab_axis(cfg)
    if axis is None:
        return torch.cat([
            softmax_xent(h[:, i:i + ck] @ head, labels[:, i:i + ck],
                         cfg.vocab_size) for i in range(0, s, ck)], dim=1)
    h = copy_in(h, axis.group)
    return torch.cat([
        softmax_xent_sharded(h[:, i:i + ck] @ head, labels[:, i:i + ck],
                             cfg.vocab_size, axis)
        for i in range(0, s, ck)], dim=1)


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
    """Next-token CE over the batch, plus router_aux_coef times the MoE aux
    loss (the sweep's and the trainer's loss_fn: `lambda p, b: lm_loss(p,
    b, cfg)`)."""
    per_ex, aux = lm_per_example_loss(params, batch, cfg, window)
    moe_coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    return per_ex.mean() + moe_coef * aux if moe_coef else per_ex.mean()


def _decode_subblock(kind: str, p: Dict, cache: Dict, x1: Tensor, pos,
                     cfg: ModelConfig, window: Optional[int],
                     rope: Tuple[Tensor, Tensor],
                     plain: bool) -> Tuple[Tensor, Dict]:
    """One block of a decode step: x + attn(norm(x)), then + ffn(norm(x))
    (the MoE FFN's aux loss is dropped, as in the reference)."""
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    h, cache = ATT.decode_step(p["attn"], h, cache, pos, cfg, window=window,
                               rope=rope, plain=plain)
    x1 = x1 + h
    y, _ = _ffn(kind, p["ffn"], rms_norm(x1, p["ln2"], cfg.norm_eps), cfg)
    return x1 + y, cache


def decode_step(params: Dict, caches: Dict, tokens1: Tensor, pos,
                cfg: ModelConfig, window: Optional[int] = None, *,
                plain: bool = False) -> Tuple[Tensor, Dict]:
    """One decode step.  tokens1 [B, 1] integer, pos the 0-based index of the
    new token (an int or a 0-d integer tensor on the device).  `window`
    overrides cfg.window for every attention block; a windowed step
    writes slot pos % S of its ring caches (`init_caches` with the same
    window).  Returns (logits [B, 1, Vp], caches); the caches are written
    in place (see `attention.decode_step`)."""
    check_supported(cfg)
    window = window if window is not None else cfg.window
    ATT.check_cache_supported(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens1.device)
    x = embed_tokens(params, tokens1, cfg)
    rope = rope_cos_sin(pos.reshape(1, 1), cfg.hd, cfg.rope_theta)
    for (kind, p), (_, c) in zip(_layers(cfg, params), _layers(cfg, caches)):
        x, _ = _decode_subblock(kind, p, c, x, pos, cfg, window, rope, plain)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, h, cfg), caches

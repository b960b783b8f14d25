"""Decoder-only LM of the port: init, embeddings, the full-sequence forward
and loss of training and prefill, decode caches and the one-token decode
step (`repro/models/transformer.py`), for the block kinds

  attn       causal self-attention (GQA, or MLA when cfg.mla) + SwiGLU
  attn_moe   causal self-attention (GQA or MLA) + MoE FFN (+ shared experts)
  local_attn sliding-window GQA self-attention (cfg.local_window) + SwiGLU
  ssm        Mamba-2 SSD mixer (no separate FFN, per the paper)
  rglru      RG-LRU recurrent mixer + SwiGLU

in any `block_pattern` of them (qwen3-4b, granite-8b and starcoder2-3b are
("attn",), moonshot and deepseek-v2-236b (MLA) ("attn_moe",), llama4
("attn", "attn_moe"), mamba2-1.3b ("ssm",), recurrentgemma-9b ("rglru",
"rglru", "local_attn")).  A "super-block" is one
repeat of the pattern: n_layers // len(pattern) of them are stacked with a
leading layer axis under `blocks` ({"b0", "b1", ...}, one sub-block per
pattern entry), and the n_layers % len(pattern) left over are unstacked
`tail{t}` blocks of kind pattern[t].  An "ssm" sub-block is ln1 and the
mixer alone; an "rglru" sub-block is ln1, the mixer, ln2 and the SwiGLU.

The parameter and cache trees keep the JAX package's layout, so JAX weights
carry across with `params_from_jax` and a flat row lays its leaves out as
`jax.tree_util` does (`repro_torch.tree`).  The decode caches of a layer are
a GQA layer's k / v (int8 with f16 scales under kv_cache_dtype="int8"),
an MLA layer's latent c_kv / k_rope, an SSD layer's conv window and ssm
state, or an RG-LRU layer's conv window and h.  A local_attn layer's
cache is always a ring of min(max_len, cfg.local_window) slots; the
`window` of `init_caches` and `decode_step` (long_500k's) applies to the
attn / attn_moe blocks only.  The JAX scan over layers is a Python loop
over layer indices here, and `remat` has no counterpart: the backward
keeps every layer's activations.  `chunked_ce` projects `lm_head_chunk`
positions to logits at a time, as the reference does, without
`torch.utils.checkpoint` (it does not compose with `torch.func.grad` /
`vmap`, through which the sweep takes per-worker gradients).

A VLM (cfg.frontend, llava-next-mistral-7b) adds the `projector` leaves
w1 [feat, d], b1, w2 [d, d], b2: `hidden_for_batch` projects a batch's
`embeds_prefix` [B, P, feat] through them (w1, the tanh GELU, w2: the
reference's `jax.nn.gelu` default), prepends it to the token embeddings,
runs the stack over the whole row and returns the token region.  Decode
and serve take the text tokens alone, as the reference's do.  The
encoder-decoder (cfg.encdec) is `models/encdec.py`, which reuses this
module's embedding, head and CE.

Under `common.tensor_parallel` (a "model" axis of M ranks, the parameters
this rank's shards, `launch/sharding.py`) the residual stream stays
replicated: the attention (GQA or MLA), the SSD and RG-LRU mixers, the
SwiGLU (wi / wg split on f, wo on f) and the MoE each take their input
through `copy_in` and reduce their output once; the projector's w1 and w2
split their columns (each rank's columns of the product, gathered into
the replicated stream by `gather_out`); the embedding is split on
its vocab rows (each rank looks up the ids in its rows, zeros elsewhere,
one `reduce_out`), the head on its vocab columns, and the CE is
`softmax_xent_sharded`, so the [B, S, Vp] logits are never gathered in
training.  `logits_from_hidden` gathers the vocab shards (prefill and
decode).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import ffn as FFN
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RGL
from repro_torch.models import ssm as SSM
from repro_torch.launch.distributed import (all_gather, copy_in, gather_out,
                                            reduce_out)
from repro_torch.models.common import (ModelConfig, ParamInit, model_shards,
                                       rms_norm, rope_cos_sin, softmax_xent,
                                       softmax_xent_sharded)
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor

BLOCK_KINDS = ("attn", "attn_moe", "local_attn", "ssm", "rglru")
# the kinds whose decode reads a KV cache at a position (rotary keys)
ATTN_KINDS = ("attn", "attn_moe", "local_attn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError unless cfg is a decoder-only stack of known block
    kinds ("attn", "attn_moe" with a MoE config, "local_attn", "ssm" with
    an SSM config, "rglru"; the attention of attn / attn_moe GQA, or MLA
    with an MLA config; local_attn always GQA); an encoder-decoder config
    belongs to `models/encdec.py`."""
    if cfg.encdec is not None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: "
                         f"models/encdec.py builds and runs it")
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise ValueError(f"block_pattern {cfg.block_pattern}: unknown "
                             f"block kind {kind!r}")
    if "attn_moe" in cfg.block_pattern and cfg.moe is None:
        raise ValueError(f"{cfg.name}: an attn_moe block needs cfg.moe")
    if "ssm" in cfg.block_pattern and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: an ssm block needs cfg.ssm")


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_scanned_repeats, n_tail_blocks)."""
    k = len(cfg.block_pattern)
    return cfg.n_layers // k, cfg.n_layers % k


def _mla(kind: str, cfg: ModelConfig) -> bool:
    """Whether a block of this kind is MLA (local_attn never is)."""
    return cfg.mla is not None and kind != "local_attn"


def _init_subblock(pi: ParamInit, kind: str, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    if kind == "ssm":
        return {"ln1": pi.param((d,), init="zeros"),
                "mixer": SSM.init_ssm(pi, cfg)}
    if kind == "rglru":
        return {"ln1": pi.param((d,), init="zeros"),
                "mixer": RGL.init_rglru(pi, cfg),
                "ln2": pi.param((d,), init="zeros"),
                "ffn": FFN.init_swiglu(pi, cfg)}
    return {"ln1": pi.param((d,), init="zeros"),
            "attn": (ATT.init_mla(pi, cfg) if _mla(kind, cfg)
                     else ATT.init_gqa(pi, cfg)),
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
    if cfg.frontend is not None:
        fd = cfg.frontend.feature_dim
        params["projector"] = {"w1": pi.param((fd, d), fan_in=fd),
                               "b1": pi.param((d,), init="zeros"),
                               "w2": pi.param((d, d), fan_in=d),
                               "b2": pi.param((d,), init="zeros")}
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
    """Decode caches in the reference's layout: {"blocks": {"b<i>": {...}}}
    for the stacked super-blocks (a leading layer axis L) and {"tail<t>":
    {"b0": {...}}} for the tail blocks, each a GQA layer's {"k", "v":
    [B, S, KV, hd]}, an MLA layer's {"c_kv": [B, S, kv_lora], "k_rope":
    [B, S, rope]} or an SSD layer's {"conv": [B, d_conv - 1, conv_ch],
    "ssm": [B, H, N, P] f32} or an RG-LRU layer's {"conv": [B, 3, W],
    "h": [B, W] f32}; under kv_cache_dtype="int8" a GQA layer's k / v are
    int8 with f16 "k_scale" / "v_scale" [B, S, KV].  `window` overrides
    cfg.window for every attn / attn_moe GQA block (long_500k's SWA
    variant); a window makes each GQA cache a ring of min(max_len, window)
    slots (an MLA cache is always max_len slots, as the reference's); a
    local_attn cache is a ring of min(max_len, cfg.local_window) slots
    whatever `window` is.  Over model_parallel "model" ranks, a rank's
    caches: the KV heads its query heads read (`attention.local_heads`),
    the whole MLA latent, the SSD state of its heads (`ssm.py`), its W / M
    RG-LRU channels (`rglru.py`)."""
    check_supported(cfg)
    ATT.check_heads(cfg, model_parallel)
    n_rep, n_tail = layer_counts(cfg)
    w_attn = window if window is not None else cfg.window

    def one(kind, stack=()):
        if kind == "ssm":
            c = SSM.init_ssm_state(cfg, batch, cfg.dtype, "meta",
                                   model_parallel)
        elif kind == "rglru":
            c = RGL.init_rglru_state(cfg, batch, cfg.dtype, "meta",
                                     model_parallel)
        elif kind == "local_attn":
            c = ATT.init_cache(cfg, batch, max_len, cfg.local_window,
                               cfg.dtype, "meta", model_parallel)
        elif cfg.mla is not None:
            c = ATT.init_mla_cache(cfg, batch, max_len, cfg.dtype, "meta",
                                   model_parallel)
        else:
            c = ATT.init_cache(cfg, batch, max_len, w_attn, cfg.dtype,
                               "meta", model_parallel)
        return {k: torch.zeros(stack + x.shape, dtype=x.dtype, device=device)
                for k, x in c.items()}

    caches: Dict[str, Any] = {}
    if n_rep:
        caches["blocks"] = {f"b{i}": one(kind, (n_rep,))
                            for i, kind in enumerate(cfg.block_pattern)}
    for t in range(n_tail):
        caches[f"tail{t}"] = {"b0": one(cfg.block_pattern[t])}
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
    """The full-sequence block: x + attn(norm(x)) (or + rglru(norm(x))),
    then + ffn(norm(x)); or x + ssd(norm(x)); returns (x, the MoE aux loss
    or None).  A local_attn block attends within cfg.local_window."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        return x + SSM.ssd_full(p["mixer"], h, cfg), None
    if kind == "rglru":
        x = x + RGL.rglru_full(p["mixer"], h, cfg)
    elif kind == "local_attn":
        x = x + ATT.gqa_full(p["attn"], h, cfg, positions,
                             window=cfg.local_window)
    elif cfg.mla is not None:
        x = x + ATT.mla_full(p["attn"], h, cfg, positions, window=window)
    else:
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


def _column_product(x: Tensor, w: Tensor, cfg: ModelConfig) -> Tensor:
    """x @ w for a leaf w [n, d] whose columns the "model" axis splits when
    M divides d: this rank's columns, gathered into the replicated stream
    (x enters through `copy_in`: each rank's backward holds its columns'
    share of x's gradient)."""
    axis = model_shards()
    if axis is None or not axis.shards(cfg.d_model):
        return x @ w
    return gather_out(copy_in(x, axis.group) @ w, axis.group)


def project_prefix(params: Dict, embeds_prefix: Tensor,
                   cfg: ModelConfig) -> Tensor:
    """The VLM projector: embeds_prefix [B, P, feat], cast to cfg.dtype,
    through w1 + b1, the tanh GELU (`jax.nn.gelu`'s default), w2 + b2 ->
    [B, P, d]."""
    pr = params["projector"]
    e = _column_product(embeds_prefix.to(cfg.dtype), pr["w1"], cfg) + pr["b1"]
    e = torch.nn.functional.gelu(e, approximate="tanh")
    return _column_product(e, pr["w2"], cfg) + pr["b2"]


def hidden_for_batch(params: Dict, tokens: Tensor, cfg: ModelConfig,
                     window: Optional[int] = None,
                     embeds_prefix: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> (final hidden [B, S, d], aux).  With
    `embeds_prefix` [B, P, feat] (a VLM's stub features) the projected
    prefix (`project_prefix`) is prepended to the token embeddings and the
    stack runs over all P + S positions; the hidden states are the token
    region's.  A prefix on a config without a frontend raises
    ValueError."""
    x = embed_tokens(params, tokens, cfg)
    npfx = 0
    if embeds_prefix is not None:
        if cfg.frontend is None:
            raise ValueError(f"{cfg.name} has no frontend: no projector "
                             f"for embeds_prefix")
        e = project_prefix(params, embeds_prefix, cfg)
        x = torch.cat([e, x], dim=1)
        npfx = e.shape[1]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    h, aux = forward_hidden(params, x, positions, cfg, window)
    return h[:, npfx:], aux


def forward(params: Dict, tokens: Tensor, cfg: ModelConfig,
            window: Optional[int] = None,
            embeds_prefix: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> (logits [B, S, Vp], aux): the token region's,
    after a projected `embeds_prefix` when given."""
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
    """One block of a decode step: x + attn(norm(x)) (or + rglru(norm(x))),
    then + ffn(norm(x)) (the MoE FFN's aux loss is dropped, as in the
    reference); or x + ssd(norm(x)).  A local_attn block's ring holds
    cfg.local_window slots."""
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    if kind == "ssm":
        y, cache = SSM.ssd_decode_step(p["mixer"], h, cache, cfg)
        return x1 + y, cache
    if kind == "rglru":
        h, cache = RGL.rglru_decode_step(p["mixer"], h, cache, cfg)
    elif _mla(kind, cfg):
        h, cache = ATT.mla_decode_step(p["attn"], h, cache, pos, cfg,
                                       rope=rope)
    else:
        h, cache = ATT.decode_step(
            p["attn"], h, cache, pos, cfg,
            window=cfg.local_window if kind == "local_attn" else window,
            rope=rope, plain=plain)
    x1 = x1 + h
    y, _ = _ffn(kind, p["ffn"], rms_norm(x1, p["ln2"], cfg.norm_eps), cfg)
    return x1 + y, cache


def decode_step(params: Dict, caches: Dict, tokens1: Tensor, pos,
                cfg: ModelConfig, window: Optional[int] = None, *,
                plain: bool = False) -> Tuple[Tensor, Dict]:
    """One decode step.  tokens1 [B, 1] integer, pos the 0-based index of the
    new token (an int or a 0-d integer tensor on the device).  `window`
    overrides cfg.window for every attn / attn_moe GQA block; a windowed
    step writes slot pos % S of its ring caches (`init_caches` with the
    same window); a local_attn block always writes its ring of
    cfg.local_window slots.  MLA, SSD and RG-LRU layers take no window
    (SSD and RG-LRU layers no pos either).  Returns (logits [B, 1, Vp],
    caches); the caches are written in place (see
    `attention.decode_step`, `attention.mla_decode_step`,
    `ssm.ssd_decode_step`, `rglru.rglru_decode_step`)."""
    check_supported(cfg)
    window = window if window is not None else cfg.window
    ATT.check_cache_supported(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens1.device)
    x = embed_tokens(params, tokens1, cfg)
    rope = None
    if any(kind in ATTN_KINDS for kind in cfg.block_pattern):
        rope = rope_cos_sin(pos.reshape(1, 1), cfg.mla.qk_rope_dim
                            if cfg.mla is not None else cfg.hd,
                            cfg.rope_theta)
    for (kind, p), (_, c) in zip(_layers(cfg, params), _layers(cfg, caches)):
        x, _ = _decode_subblock(kind, p, c, x, pos, cfg, window, rope, plain)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(params, h, cfg), caches

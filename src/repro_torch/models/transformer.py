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
over layer indices here.  Under `cfg.remat`, as in the reference, each
super-block (all its sub-blocks) and each tail block is one region the
backward recomputes from its input (`run_block`, `common.recompute`), so
the backward keeps a layer's input and one layer's activations at a
time; `chunked_ce` projects `lm_head_chunk` positions to logits at a
time, each chunk recomputed in the backward whatever remat says.  Inside
a `torch.func` transform (the sweep's per-worker `vmap(grad)`, whose
configs set remat False) saved-tensor hooks are refused, so there both
run without recompute, with the same values.

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
decode).  Under `tensor_parallel(axis, sequence=True)` (the train and
prefill steps' default, the reference's `make_constrain`) each rank
holds its S / M positions of the stream: the embedding leaves through
`scatter_seq` (a VLM's prefix and tokens are joined whole, then split:
`common.local_seq`), the norms and residual adds run on the rank's rows
(the norms' scales: `launch.sharding.row_leaves`), each mixer and FFN gathers
the sequence where it enters its split and scatters its partial
product where it leaves (`common.enter` / `leave`), a recomputed block
keeps only its rows, the CE gathers the sequence before the vocab-split
head, and the prefill's last position comes from the last rank
(`last_hidden`).  Under `common.storage_sharded` (the large leaves' storage split
over the "data" ranks) a layer's leaves are gathered where the layer
runs (`_Layer.tree`: one layer at a time, inside its recomputed region
under remat, so the backward gathers it again rather than keep it), and
the embedding, the head and the projector where they are used
(`common.gathered`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as ATT
from repro_torch.models import ffn as FFN
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RGL
from repro_torch.models import ssm as SSM
from repro_torch.launch.distributed import all_gather, copy_in, gather_out
from repro_torch.models.common import (ModelConfig, ParamInit, enter,
                                       gather_storage_dim, gathered, leave,
                                       local_seq, model_shards, recompute,
                                       rms_norm, rope_cos_sin, seq_split,
                                       softmax_xent,
                                       softmax_xent_sharded, storage_dim,
                                       whole_residual, whole_seq)
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
            device=None, part=None, drawn=None) -> Dict[str, Any]:
    """Random weights in the JAX layout, drawn from the stream keyed by one
    int64 of `generator` on its device (or `device`; on "meta" nothing is
    allocated, for counting), each leaf filled in its own dtype, so the
    model never exists in f32.  `part` and `drawn` as `ParamInit`'s: the
    part of each leaf to draw and hold, the leaves in draw order."""
    check_supported(cfg)
    pi = ParamInit(generator, cfg.dtype, device, part=part, drawn=drawn)
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
        stacked = pi.stacked(n_rep)
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
    """tokens [B, S] -> [B, S, d] (under the sequence split this rank's
    rows [B, S / M, d]): a vocab-split embedding's lookups, zeros outside
    the rank's rows of it, leave through `common.leave`."""
    axis = _vocab_axis(cfg)
    emb = gathered(params["embed"])              # this rank's vocab rows
    if axis is None:
        return local_seq(emb[tokens.long()])
    t = tokens.long() - axis.index * emb.shape[0]
    mine = (t >= 0) & (t < emb.shape[0])
    x = emb[torch.where(mine, t, 0)].masked_fill(~mine[..., None], 0.0)
    return leave(x)


def _head(params: Dict, cfg: ModelConfig) -> Tensor:
    return gathered(params["embed"]).T if cfg.tie_embeddings \
        else gathered(params["lm_head"])


def logits_from_hidden(params: Dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    """h [..., d] -> the logits [..., Vp]; under `tensor_parallel` each
    rank's vocab columns, gathered."""
    axis = _vocab_axis(cfg)
    if axis is None:
        return h @ _head(params, cfg)
    return all_gather(copy_in(h, axis.group) @ _head(params, cfg),
                      axis.group, dim=-1)


def last_hidden(h: Tensor) -> Tensor:
    """h[:, -1] [B, d] of the stack's output h: under the sequence split,
    where h is this rank's rows, the last rank's last row (each rank's
    last row gathered; nothing else of the sequence moves)."""
    if not seq_split():
        return h[:, -1]
    return all_gather(h[:, -1:], model_shards().group, dim=1)[:, -1]


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
    caches: the KV heads its query heads read (`attention.local_heads`:
    every KV head where model_parallel does not divide H),
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


class _Layer(NamedTuple):
    """One layer's leaves as this rank holds them (`_layer_parts`): under
    `common.storage_sharded` a data-sharded leaf is this rank's part,
    with the dim to gather it on."""
    treedef: Any
    leaves: List[Tensor]
    dims: List[Optional[int]]

    def tree(self, leaves=None) -> Dict:
        """The layer's tree, each part gathered whole; `leaves` (the
        same tensors, passed through a recomputed region) in place of
        self.leaves."""
        return tree_unflatten(self.treedef, [
            x if d is None else gather_storage_dim(x, d)
            for x, d in zip(self.leaves if leaves is None else leaves,
                            self.dims)])


def _layer_parts(tree: Dict, n: int) -> Iterator[_Layer]:
    """The n layers of a stacked tree, one at a time (views, ungathered),
    each leaf unbound once: the backward of `unbind` stacks the layers'
    gradients in one pass, where a select per layer would each add a
    zero-filled gradient of the whole stack.  A leaf split over "data" on
    its layer dim is gathered whole first (a 2-dim stacked leaf: FSDP
    splits no layer's matrix on it), the others are gathered where the
    layer is used (`_Layer.tree`)."""
    leaves, treedef = tree_flatten(tree)
    dims = [storage_dim(x) for x in leaves]
    per_leaf = [(gather_storage_dim(x, 0) if d == 0 else x).unbind(0)
                for x, d in zip(leaves, dims)]
    layer_dims = [None if d in (None, 0) else d - 1 for d in dims]
    for i in range(n):
        yield _Layer(treedef, [p[i] for p in per_leaf], layer_dims)


def _unstack(tree: Dict, n: int) -> Iterator[Dict]:
    """The n layers of a stacked tree, one at a time, each gathered as it
    is produced (`_layer_parts`)."""
    for layer in _layer_parts(tree, n):
        yield layer.tree()


def _regions(cfg: ModelConfig, tree: Dict
             ) -> Iterator[Tuple[Tuple[str, ...], _Layer]]:
    """(kinds, layer parts) of every region `cfg.remat` recomputes, in
    order: each stacked super-block ({"b0", "b1", ...}, one sub-block a
    pattern entry), then each tail block ({"b0"})."""
    n_rep, n_tail = layer_counts(cfg)
    if n_rep:
        for layer in _layer_parts(tree["blocks"], n_rep):
            yield cfg.block_pattern, layer
    for t in range(n_tail):
        leaves, treedef = tree_flatten(tree[f"tail{t}"])
        yield (cfg.block_pattern[t],), _Layer(
            treedef, leaves, [storage_dim(x) for x in leaves])


def _layers(cfg: ModelConfig, tree: Dict) -> Iterator[Tuple[str, Dict]]:
    """(kind, sub-block tree) of every layer in order, one at a time, each
    gathered as it is produced: each stacked super-block's sub-blocks,
    then the tail blocks (a decode step's params and caches)."""
    for kinds, layer in _regions(cfg, tree):
        sub = layer.tree()
        yield from ((kind, sub[f"b{i}"]) for i, kind in enumerate(kinds))


def run_block(remat: bool, fn, layer: _Layer, *xs: Tensor):
    """fn(layer's gathered tree, *xs); under remat recomputed in the
    backward (`common.recompute`), the region taking the rank's parts and
    gathering them inside itself, so that the backward gathers them again
    and nothing gathered is kept for it."""
    if not remat:
        return fn(layer.tree(), *xs)
    n = len(xs)

    def region(*args):
        return fn(layer.tree(list(args[n:])), *args[:n])
    return recompute(region, *xs, *layer.leaves)


def _ffn(kind: str, p: Dict, h: Tensor, cfg: ModelConfig
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's FFN: SwiGLU, or the MoE FFN and its aux loss; under
    `tensor_parallel` the SwiGLU's f is split when M divides it."""
    if kind == "attn_moe":
        return MOE.moe_ffn(p, h, cfg)
    axis = model_shards()
    if axis is None or not axis.shards(cfg.d_ff):   # on the rows it has
        return FFN.swiglu(p, h), None
    return leave(FFN.swiglu(p, enter(h))), None


def _apply_subblock(kind: str, p: Dict, x: Tensor, positions: Tensor,
                    cfg: ModelConfig, window: Optional[int]
                    ) -> Tuple[Tensor, Optional[Tensor]]:
    """The full-sequence block: x + attn(norm(x)) (or + rglru(norm(x))),
    then + ffn(norm(x)); or x + ssd(norm(x)); returns (x, the MoE aux loss
    or None).  A local_attn block attends within cfg.local_window.  Under
    the sequence split x is the rank's rows and positions the whole
    sequence's."""
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
    y, aux = _ffn(kind, p["ffn"], rms_norm(x, p["ln2"],
                                          cfg.norm_eps), cfg)
    return x + y, aux


def forward_hidden(params: Dict, x: Tensor, positions: Tensor,
                   cfg: ModelConfig, window: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Embedded inputs [B, S, d] -> (final hidden [B, S, d], aux loss):
    the aux loss is the sum of the MoE blocks' load-balance losses (0 for
    a dense model), f32, each super-block's summed first, as the
    reference does.  Under cfg.remat each super-block and each tail block
    is recomputed in the backward (`run_block`).  Under the sequence
    split x and the hidden states are this rank's rows [B, S / M, d],
    positions [B, S] the whole sequence's."""
    check_supported(cfg)
    window = window if window is not None else cfg.window

    def blocks(kinds, p, x):
        aux = None
        for i, kind in enumerate(kinds):
            x, a = _apply_subblock(kind, p[f"b{i}"], x, positions, cfg,
                                   window)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kinds, layer in _regions(cfg, params):
        x, a = run_block(cfg.remat, functools.partial(blocks, kinds),
                         layer, x)
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
    pr = {k: gathered(v) for k, v in params["projector"].items()}
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
    region's.  Under the sequence split h is this rank's rows of all P + S
    positions (the token region is the last S of them: `chunked_ce` and
    `last_hidden` take it).  A prefix on a config without a frontend
    raises ValueError."""
    npfx = 0
    if embeds_prefix is None:
        x = embed_tokens(params, tokens, cfg)
    else:
        if cfg.frontend is None:
            raise ValueError(f"{cfg.name} has no frontend: no projector "
                             f"for embeds_prefix")
        with whole_residual():   # joined whole, then the rank's rows
            x = embed_tokens(params, tokens, cfg)
            e = project_prefix(params, embeds_prefix, cfg)
        x = local_seq(torch.cat([e, x], dim=1))
        npfx = e.shape[1]
    b, s = tokens.shape[0], npfx + tokens.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    h, aux = forward_hidden(params, x, positions, cfg, window)
    return (h if seq_split() else h[:, npfx:]), aux


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
    holds the remainder), each chunk's logits and softmax recomputed in
    the backward whatever cfg.remat says (`common.recompute`, as the
    reference's `jax.checkpoint`), so the [B, S, vocab] logits never
    exist at once, nor a chunk's past its forward.  Under
    `tensor_parallel` each chunk's logits are this rank's vocab columns
    (`softmax_xent_sharded`); under the sequence split h is this rank's
    rows, gathered first (`common.enter`, or `whole_seq` for a replicated
    head), and the CE is the last S = labels.shape[1] positions' (a VLM's
    token region)."""
    head = _head(params, cfg)
    axis = _vocab_axis(cfg)
    if axis is None:
        h = whole_seq(h)

        def ce(hc, lc, head):
            return softmax_xent(hc @ head, lc, cfg.vocab_size)
    else:
        h = enter(h)

        def ce(hc, lc, head):
            return softmax_xent_sharded(hc @ head, lc, cfg.vocab_size, axis)
    s = labels.shape[1]
    h = h[:, h.shape[1] - s:]
    ck = min(cfg.lm_head_chunk, s)
    return torch.cat([recompute(ce, h[:, i:i + ck], labels[:, i:i + ck],
                                head) for i in range(0, s, ck)], dim=1)


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

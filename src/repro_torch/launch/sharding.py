"""The layout of an LM over a "model" axis of M ranks (tensor parallelism):
which dim of each parameter leaf is split, and a rank's shards.

The counterpart of the "model" entries of the reference's specs: the
`ParamFactory` specs of `repro/models/attention.py::_wspec`,
`repro/models/common.py::ModelConfig.shard`, `repro/models/ffn.py`,
`repro/models/moe.py` and `repro/models/transformer.py::init_lm`.  The
rules, as the reference's (a dim is split when M divides it):

- attention wq / wk / wv split their head dim, or the first other dim M
  divides (`models.attention.wspec`, the reference's `_wspec`: d for
  the KV heads of the smoke qwen3-4b at M = 4, and d for all three of
  starcoder2-3b's and llama4's at M = 16), or nothing; wo its head dim
  the same way (hd for those two at M = 16); q_norm / k_norm are
  replicated;
- MLA (`repro/models/attention.py::init_mla`): wq_a its q_lora, wq_b /
  wk_b / wv_b their heads and wo its heads, each by `_wspec`'s rule;
  wkv_a, q_norm and kv_norm are replicated;
- the SSD mixer (`repro/models/ssm.py::init_ssm`): in_proj its output
  columns, A_log / D / dt_bias their heads, norm and out_proj's rows
  d_inner; conv_w / conv_b are replicated;
- the RG-LRU mixer (`repro/models/rglru.py::init_rglru`): in_x, in_gate,
  conv_w, w_a and w_i their W columns, conv_b, b_a, b_i and lam W, out
  its W rows;
- the SwiGLU's wi / wg split f, its wo f;
- the MoE experts split each expert's f ("scan_dense") or the experts
  ("capacity_gather"); the shared experts are a SwiGLU; the f32 router is
  replicated;
- embed splits its vocab rows, lm_head its vocab columns; the norms are
  replicated;
- a VLM's projector w1 / w2 and the encoder-decoder's enc_in split their
  columns (d), b1 / b2 are replicated; the encoder-decoder's attn,
  self_attn and cross_attn take the attention's rule, and its stacked
  enc_blocks / dec_blocks count the layer dim as `blocks` does.

A spec tree has the parameter tree's structure, each leaf the split dim
(an int, stacked layers' leading dim counted) or None.  The port's
`ModelConfig` has no `model_parallel`: M is an argument, and M = 1 splits
nothing.  A rank's decode caches are built by
`transformer.init_caches(..., model_parallel=M)`: its KV heads, whole
(every KV head where M does not divide H; the reference's `cache_specs`
splits another dim where M does not divide KV; `models/attention.py`),
the whole MLA latent, its heads' SSD state (`models/ssm.py`) and its
W / M channels of the RG-LRU state (`models/rglru.py`).

Storage over "data" (ZeRO-3, the reference's `fsdp_augment`): a leaf of
at least FSDP_MIN_SIZE elements is also split over the R "data" ranks on
its largest dim that the "model" axis leaves whole and R divides (dim 0 of
a stacked leaf of more than two dims skipped); `data_specs` is that tree,
each leaf's "data" dim or None, beside `param_specs`.  A rank stores the
slice of both dims (`shard_params`, `init_shards`), and each layer
gathers its data-sharded leaves over "data" where it is used
(`models.common.storage_sharded`, `launch.distributed.gather_storage`),
so the data gather of a leaf yields its "model" shard.  The activations'
layout of `make_constrain` (the residual stream [B, S, d] as P(batch
axes, "model", None): each "model" rank its S / M positions) is the
train and prefill steps' default route, `constrain="sequence"`
(`launch/steps.py`, `models.common.tensor_parallel(axis,
sequence=True)`); "batch_only" is the reference's
REPRO_PREFILL_CONSTRAIN=batch_only; decode's caches keep whole
sequences (the reference's sequence-split `cache_specs` is ROADMAP.md
Queue 1 item 8d.3).  `sweep_state_spec` is the sweep engine's column
split (`fl/sweep.py::_ModelShards`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import philox
from repro_torch.launch.distributed import all_gather
from repro_torch.launch.mesh import data_axis, model_axis
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.attention import wspec
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor

FSDP_MIN_SIZE = 1 << 22  # 4M elements: below this, replication is cheaper


def _split(n: int, dim: int, m: int) -> Optional[int]:
    return dim if n % m == 0 else None


# the parameter subtrees stacked with a leading layer axis
STACKED = ("blocks", "enc_blocks", "dec_blocks")
# the attention subtrees: a decoder-only block's, the encoder-decoder's
ATTENTION = ("attn", "self_attn", "cross_attn")


def _kind(path: Tuple[str, ...], cfg: ModelConfig) -> str:
    """The block kind of the decoder-only sub-block a leaf path lies in:
    blocks/b<i> is pattern[i], tail<t> pattern[t]."""
    if path[0] == "blocks":
        return cfg.block_pattern[int(path[1][1:])]
    return cfg.block_pattern[int(path[0][4:])]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None, part=None, drawn=None) -> Dict:
    """cfg's random weights: `encdec.init_encdec` for the encoder-decoder
    (arch_type "audio"), else `transformer.init_lm`; `part` and `drawn` as
    `models.common.ParamInit`'s."""
    init = ED.init_encdec if cfg.arch_type == "audio" else T.init_lm
    return init(generator, cfg, device, part=part, drawn=drawn)


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, m: int) -> Optional[int]:
    """The split dim of one unstacked leaf at `path`."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if path == ("embed",):
        return _split(shape[0], 0, m)
    if path == ("lm_head",):
        return _split(shape[1], 1, m)
    if path in (("projector", "w1"), ("projector", "w2"), ("enc_in",)):
        return _split(shape[1], 1, m)
    if parent in ATTENTION:
        if name in ("wq", "wk", "wv", "wq_a", "wq_b", "wk_b", "wv_b"):
            return wspec(shape, 1, m)
        return wspec(shape, 0, m) if name == "wo" else None
    if parent == "mixer" and _kind(path, cfg) == "rglru":
        if name in ("in_x", "in_gate", "conv_w", "w_a", "w_i"):
            return _split(shape[1], 1, m)
        return _split(shape[0], 0, m)   # conv_b, b_a, b_i, lam; out's rows
    if parent == "mixer":   # the SSD block
        if name == "in_proj":
            return _split(shape[1], 1, m)
        if name in ("A_log", "D", "dt_bias", "norm", "out_proj"):
            return _split(shape[0], 0, m)
        return None         # conv_w, conv_b
    if len(shape) == 3:   # stacked experts [E, d, f] / [E, f, d]
        if cfg.moe.impl == "scan_dense":
            f_dim = 1 if name == "w2" else 2
            return _split(shape[f_dim], f_dim, m)
        return _split(shape[0], 0, m)
    if name in ("wi", "wg"):   # a SwiGLU's (dense FFN, shared experts)
        return _split(shape[1], 1, m)
    if name == "wo":
        return _split(shape[0], 0, m)
    return None   # norms, the router


def _specs(tree: Dict, prefix: Tuple[str, ...], stacked: bool,
           cfg: ModelConfig, m: int) -> Dict:
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out[k] = _specs(v, path, stacked or k in STACKED, cfg, m)
            continue
        dim = _leaf_spec(path, tuple(v.shape[1:] if stacked else v.shape),
                         cfg, m)
        out[k] = None if dim is None else dim + int(stacked)
    return out


def param_specs(cfg: ModelConfig, m: int) -> Dict:
    """Each parameter leaf's "model" dim over m ranks (or None), in the
    parameter tree's structure (`repro_torch.tree` leaf order); shapes from
    an init on the "meta" device, so nothing is allocated.  m = 1 splits
    nothing."""
    specs = _specs(init_params(cfg, None, "meta"), (), False, cfg, m)
    return specs if m > 1 else tree_map(lambda _: None, specs)


# the scales of the norms that read the residual stream
ROW_NORMS = frozenset({"ln1", "ln2", "ln_x", "final_norm", "enc_norm",
                       "dec_norm"})


def row_leaves(cfg: ModelConfig, m: int) -> List[int]:
    """The indices, in the parameter tree's leaf order, of the leaves
    applied to the residual's rows under the sequence split over m
    "model" ranks, so each rank's gradient of one is its rows' share, to
    be summed over "model" once a step: the norms' scales (ROW_NORMS)
    and, where m does not divide d_ff, the SwiGLU FFNs that
    `models.transformer._ffn` runs replicated.  Every other leaf is split
    over "model" or meets the residual through a collective whose
    backward sums it.  m = 1: none."""
    def walk(tree: Dict, key: str) -> Dict:
        ffn = (key == "ffn" and set(tree) == {"wi", "wg", "wo"}
               and cfg.d_ff % m != 0)
        return {k: walk(v, k) if isinstance(v, dict)
                else ffn or k in ROW_NORMS for k, v in tree.items()}
    if m == 1:
        return []
    rows = tree_leaves(walk(init_params(cfg, None, "meta"), ""))
    return [i for i, r in enumerate(rows) if r]


def fsdp_augment(specs: Dict, shapes: Dict, data_size: int,
                 min_size: int = FSDP_MIN_SIZE) -> Dict:
    """Each leaf's "data" dim over data_size ranks, or None (the
    reference's `fsdp_augment`, as a tree beside the "model" `specs`):
    leaves of at least min_size elements only, on the largest dim that the
    leaf's "model" dim is not and that data_size divides; dim 0 of a leaf
    of more than two dims (a stacked layer dim) is skipped.  `shapes`: the
    parameter tree (tensors on the "meta" device will do)."""
    def aug(x, dim_m):
        shape = tuple(x.shape)
        if data_size == 1 or math.prod(shape) < min_size:
            return None
        cand, cand_sz = None, 0
        for i in range(1 if len(shape) > 2 else 0, len(shape)):
            if i != dim_m and shape[i] % data_size == 0 \
                    and shape[i] > cand_sz:
                cand, cand_sz = i, shape[i]
        return cand
    return tree_map(aug, shapes, specs)


def data_specs(cfg: ModelConfig, m: int, r: int) -> Dict:
    """`fsdp_augment` of cfg's parameters over r "data" ranks at
    FSDP_MIN_SIZE (read at the call), beside `param_specs(cfg, m)`.  As
    in the reference, whose specs name "model" on a leaf's dim even over
    one "model" rank, that dim is left to "model" at m = 1 too."""
    shapes = init_params(cfg, None, "meta")
    return fsdp_augment(_specs(shapes, (), False, cfg, m), shapes, r,
                        FSDP_MIN_SIZE)


def _shard(x: Tensor, dim_m: Optional[int], dim_d: Optional[int], axis,
           daxis) -> Tensor:
    """This rank's part of a leaf split on dim_m over `axis` and on dim_d
    over `daxis` (a copy, so the whole leaf can be freed), or the leaf
    itself when neither splits it."""
    if dim_m is None and dim_d is None:
        return x
    index = [slice(None)] * x.dim()
    for dim, ax in ((dim_m, axis), (dim_d, daxis)):
        if dim is not None:
            index[dim] = ax.part(x.shape[dim])
    return x[tuple(index)].clone()


def shard_params(params: Dict, specs: Dict, mesh,
                 data_specs: Optional[Dict] = None) -> Dict:
    """This rank's shards of a full parameter tree: each leaf's slice
    along its "model" dim (`specs`) and, given `data_specs`, its "data"
    dim; the replicated leaves as they are.  `mesh`: a
    `launch.mesh.SweepMesh`; with one "model" rank and no data sharding
    `params` itself."""
    axis, daxis = model_axis(mesh), data_axis(mesh)
    if data_specs is None or daxis.size == 1:
        if axis.size == 1:
            return params
        return tree_map(lambda x, dim: _shard(x, dim, None, axis, daxis),
                        params, specs)
    return tree_map(lambda x, dm, dd: _shard(x, dm, dd, axis, daxis),
                    params, specs, data_specs)


def draw_order(cfg: ModelConfig) -> list:
    """The tree position (`repro_torch.tree` leaf order) of each leaf in
    the order the init draws it (its leaf index in the stream), from an
    init on the "meta" device."""
    drawn = []
    meta = init_params(cfg, None, "meta", drawn=drawn)
    pos = {id(x): k for k, x in enumerate(tree_leaves(meta))}
    return [pos[id(x)] for x, _ in drawn]


def filled_leaves(cfg: ModelConfig) -> int:
    """How many leaves an init of cfg fills from the stream (the others
    are zeros): one `counter_trunc_normal` launch each on the card."""
    drawn = []
    init_params(cfg, None, "meta", drawn=drawn)
    return sum(filled for _, filled in drawn)


def init_shards(cfg: ModelConfig, generator: Optional[torch.Generator],
                device, mesh, fsdp: bool = True) -> Dict:
    """This rank's shards of `init_params(cfg, generator, device)` (over
    "model", and over "data" by `data_specs` when fsdp), bit for bit
    `shard_params` of the whole draw, without the whole draw: each leaf's
    part is drawn alone from the counter-based stream (`ParamInit`'s
    `part`; its values depend only on the global indices), so a rank holds
    its parts and, on the CPU, one chunk of the plain draw's transients."""
    axis, daxis = model_axis(mesh), data_axis(mesh)
    fsdp = fsdp and daxis.size > 1
    if axis.size == 1 and not fsdp:
        return init_params(cfg, generator, device)
    mspecs = tree_leaves(param_specs(cfg, axis.size))
    dspecs = tree_leaves(data_specs(cfg, axis.size, daxis.size)) if fsdp \
        else [None] * len(mspecs)
    order = draw_order(cfg)

    def part(leaf: int, full) -> Optional[philox.Part]:
        k = order[leaf]
        if mspecs[k] is None and dspecs[k] is None:
            return None
        return philox.split_part(full, ((mspecs[k], axis),
                                        (dspecs[k], daxis)))

    return init_params(cfg, generator, device, part=part)


def gather_params(local: Dict, specs: Dict, mesh,
                  data_specs: Optional[Dict] = None) -> Dict:
    """The full parameter tree from every rank's shards: each leaf
    gathered over "data" along its `data_specs` dim (given), then over
    "model" along its `specs` dim (a collective over both groups: every
    rank calls, and every rank gets the whole tree); for tests and
    checkpoints."""
    axis, daxis = model_axis(mesh), data_axis(mesh)
    if data_specs is not None and daxis.size > 1:
        local = tree_map(lambda x, dd: x if dd is None
                         else all_gather(x, daxis.group, dd),
                         local, data_specs)
    if axis.size == 1:
        return local
    return tree_map(lambda x, dim: x if dim is None
                    else all_gather(x, axis.group, dim), local, specs)


def stored_bytes(params: Dict) -> int:
    """Bytes of a (shard) parameter tree: what a rank stores."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))

"""The layout of an LM over a "model" axis of M ranks (tensor parallelism):
which dim of each parameter leaf is split, and a rank's shards.

The counterpart of the "model" entries of the reference's specs: the
`ParamFactory` specs of `repro/models/attention.py::_wspec`,
`repro/models/common.py::ModelConfig.shard`, `repro/models/ffn.py`,
`repro/models/moe.py` and `repro/models/transformer.py::init_lm`.  The
rules, as the reference's (a dim is split when M divides it):

- attention wq / wk / wv split their head dim, or the first other dim M
  divides (`_wspec`: d for the KV heads of the smoke qwen3-4b and
  starcoder2-3b at M = 4); wo its head dim the same way; q_norm / k_norm
  are replicated;
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
`transformer.init_caches(..., model_parallel=M)`: its KV heads, whole (the
reference's `cache_specs` splits another dim where M does not divide KV;
`models/attention.py`), the whole MLA latent, its heads' SSD state
(`models/ssm.py`) and its W / M channels of the RG-LRU state
(`models/rglru.py`).  `fsdp_augment`'s storage sharding over "data"
and the sequence-parallel residuals of `make_constrain` are not ported
(ROADMAP.md Queue 1 item 8d); `sweep_state_spec` is the sweep engine's
column split (`fl/sweep.py::_ModelShards`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.distributed import all_gather
from repro_torch.launch.mesh import model_axis
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def _first_split(shape: Sequence[int], prefer: int, m: int) -> Optional[int]:
    """The reference's `_wspec`: dim `prefer` if m divides it, else the
    first other dim m divides, else None."""
    for i in [prefer] + [j for j in range(len(shape)) if j != prefer]:
        if shape[i] % m == 0:
            return i
    return None


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
                device=None, keep=None) -> Dict:
    """cfg's random weights: `encdec.init_encdec` for the encoder-decoder
    (arch_type "audio"), else `transformer.init_lm`."""
    init = ED.init_encdec if cfg.arch_type == "audio" else T.init_lm
    return init(generator, cfg, device, keep=keep)


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
            return _first_split(shape, 1, m)
        return _first_split(shape, 0, m) if name == "wo" else None
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
        shape = tuple(v.shape[1:] if stacked else v.shape)
        dim = _leaf_spec(path, shape, cfg, m) if m > 1 else None
        out[k] = None if dim is None else dim + int(stacked)
    return out


def param_specs(cfg: ModelConfig, m: int) -> Dict:
    """Each parameter leaf's "model" dim over m ranks (or None), in the
    parameter tree's structure (`repro_torch.tree` leaf order); shapes from
    an init on the "meta" device, so nothing is allocated."""
    return _specs(init_params(cfg, None, "meta"), (), False, cfg, m)


def _slice(x: Tensor, dim: Optional[int], axis) -> Tensor:
    """This rank's slice of a leaf split on dim (a copy, so the whole leaf
    can be freed), or the leaf itself."""
    if dim is None:
        return x
    return x[(slice(None),) * dim + (axis.part(x.shape[dim]),)].clone()


def shard_params(params: Dict, specs: Dict, mesh) -> Dict:
    """This rank's shards of a full parameter tree: each split leaf's
    slice along its dim, the replicated leaves as they are.  `mesh`: a
    `launch.mesh.SweepMesh`; None or one "model" rank returns `params`."""
    axis = model_axis(mesh)
    if axis.size == 1:
        return params
    return tree_map(lambda x, dim: _slice(x, dim, axis), params, specs)


def init_shards(cfg: ModelConfig, generator: Optional[torch.Generator],
                device, mesh) -> Dict:
    """This rank's shards of `init_params(cfg, generator, device)`,
    bit for bit `shard_params` of the whole draw, without the whole draw:
    each leaf is drawn whole from the generator, so the stream is one
    rank's, and sliced at once, so a rank holds at most one whole leaf
    beside its shards."""
    axis = model_axis(mesh)
    if axis.size == 1:
        return init_params(cfg, generator, device)
    drawn = []   # the leaves in the order they are drawn
    meta = init_params(cfg, None, "meta",
                       keep=lambda x: drawn.append(x) or x)
    dim_of = {id(x): d for x, d in zip(tree_leaves(meta), tree_leaves(
        param_specs(cfg, axis.size)))}
    dims = iter([dim_of[id(x)] for x in drawn])
    return init_params(cfg, generator, device,
                       keep=lambda x: _slice(x, next(dims), axis))


def gather_params(local: Dict, specs: Dict, mesh) -> Dict:
    """The full parameter tree from every "model" rank's shards (a
    collective over the model group: every rank of it calls, and every rank
    gets the whole tree); for tests and checkpoints."""
    axis = model_axis(mesh)
    if axis.size == 1:
        return local
    return tree_map(lambda x, dim: x if dim is None
                    else all_gather(x, axis.group, dim), local, specs)

"""Shared model substrate of the port: the config, a parameter initialiser,
RMS norm and RoPE.

The counterpart of `repro/models/common.py` for the serving and training
paths: the config, the causal mask and the vocab-padded cross-entropy
beside the norms and RoPE.  The JAX package's sharding machinery
(PartitionSpecs, `shard_hint`) becomes explicit tensor parallelism: the
layout is `launch/sharding.py`'s, and inside `with tensor_parallel(axis):`
(a `launch.mesh.ModelAxis` of M > 1 ranks) each layer computes this rank's
shard and writes its own collectives, Megatron style
(`launch.distributed.copy_in` / `reduce_out`), where XLA derives them from
the specs; `softmax_xent_sharded` is the CE over vocab-sharded logits.
`tensor_parallel(axis, sequence=True)` is the reference's default
`make_constrain` layout (the train and prefill steps' "sequence" route):
each rank holds its S / M positions of the residual stream, the norms
and residual adds run on them, and each layer enters and leaves its
split through `enter` / `leave` (`gather_seq` / `scatter_seq` in place
of `copy_in` / `reduce_out`); a product of replicated weights reads the
whole sequence (`whole_seq`) and keeps its rows (`local_seq`), and a
replicated weight applied to the rows (a norm's scale) gets each rank's
rows' share of its gradient, which the train step sums over the axis
once a step (`launch.sharding.row_leaves`).  Beside it,
inside `with storage_sharded(axis, leaves, dims):` the listed weight
leaves are this rank's parts of leaves whose storage the "data" ranks
split (ZeRO-3, `launch.sharding.fsdp_augment`), and the model gathers
each where a layer uses it (`gathered`, `storage_dim`,
`gather_storage_dim`), so the model code stays layout-free.
`maybe_scan` has no counterpart: the port loops over layers in Python.
`recompute` is the reference's `jax.checkpoint`: a region's saved tensors
are dropped after the forward and recomputed in the backward, inside the
context variables the forward ran in (the "model" axis, the storage
split, and those the MoE registers: `carry_into_recompute`), so the
recompute makes the forward's shapes and collectives again.
Parameters are nested dicts of tensors in the JAX layout, so
`models/transformer.py::params_from_jax` carries JAX weights across as they
are.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, philox
from repro_torch.launch.distributed import (all_reduce_max, copy_in,
                                            gather_out, gather_seq,
                                            gather_storage, reduce_out,
                                            scatter_seq, split_seq)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts settings (`repro/models/common.py::MoEConfig`),
    every field and default as the reference's."""
    num_experts: int
    top_k: int
    d_expert: int                     # per-expert FFN hidden size
    num_shared: int = 0               # shared (always-on) experts
    interleave: int = 1               # every `interleave`-th block is MoE (1 = all)
    capacity_factor: float = 1.25
    impl: str = "capacity_gather"     # or "scan_dense" (masked full compute)
    router_aux_coef: float = 0.01     # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention (`repro/models/common.py::
    MLAConfig`), every field and default as the reference's:
    `models/attention.py`'s `mla_full` / `mla_decode_step`."""
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The Mamba-2 SSD block (`repro/models/common.py::SSMConfig`), every
    field and default as the reference's: `models/ssm.py`."""
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    d_conv: int = 4
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """The encoder-decoder's stacks (`repro/models/common.py::
    EncDecConfig`), every field and default as the reference's:
    `models/encdec.py`."""
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    enc_seq_cap: int = 4096           # the encoder's (stub frames') length cap


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """A stubbed modality frontend (`repro/models/common.py::
    FrontendConfig`): a VLM's projected prefix (`transformer.
    project_prefix`) or an encoder-decoder's frames (`encdec.encode`)."""
    kind: str                         # "vision" | "audio" (stubbed per spec)
    feature_dim: int = 1024
    n_prefix: int = 2880              # vision: anyres patch count; audio: n/a


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX `ModelConfig` without its XLA execution knobs
    (model_parallel, scan_layers, unroll_for_analysis); `dtype` is a torch
    dtype.  `remat` stays, with the reference's default: under it the
    train step's backward recomputes each super-block, tail block and
    encoder-decoder block from its input (`recompute`) rather than keep
    its activations; the full configs keep True, the smoke and lm_sweep
    configs set False, as the reference's do.  `lm_head_chunk` stays: it
    decides how many positions the training loss projects to logits at
    once (`transformer.chunked_ce`, each chunk recomputed whatever remat
    says).  `skip_shapes` stays: it is a model property, the input shapes
    a config does not run (`configs.registry.shape_applicable`).  `moe` is
    a `MoEConfig`, `mla` an `MLAConfig` (deepseek-v2-236b) and `ssm` an
    `SSMConfig` (mamba2-1.3b); `rglru_width` and `local_window` shape the
    RG-LRU hybrid (recurrentgemma-9b); `frontend` a VLM's projected prefix
    (llava-next-mistral-7b, `transformer.project_prefix`) or, with
    `encdec`, the encoder-decoder's frames (seamless-m4t-large-v2,
    `models/encdec.py`)."""
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None      # native sliding window (None = full attn)
    long_context_window: Optional[int] = None  # SWA used only for long_500k
    block_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None
    rglru_width: Optional[int] = None
    local_window: int = 2048
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6
    citation: str = ""
    # decode-shape applicability: the input shapes this config skips
    skip_shapes: Tuple[str, ...] = ()
    # CE/logits are computed in sequence chunks of this many positions so the
    # [B, S, vocab] tensor never materializes.
    lm_head_chunk: int = 1024
    kv_cache_dtype: str = "native"    # or "int8" (models/attention.py)
    # recompute each block in the backward (`recompute`) instead of keeping
    # its activations
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        mult = 256
        return ((self.vocab_size + mult - 1) // mult) * mult


class _Stream:
    """An init's draws: the stream seed and the next leaf index (the draw
    order), shared by the `ParamInit`s of one init."""

    def __init__(self, seed: Optional[int]):
        self.seed = seed
        self.next = 0

    def take(self) -> int:
        leaf, self.next = self.next, self.next + 1
        return leaf


class ParamInit:
    """Draws parameters as the JAX `ParamFactory` does: truncated normal on
    [-2, 2] in f32, times 1/sqrt(fan_in) (fan_in defaults to shape[0]), cast
    to `dtype` (or the parameter's own `dtype`: the MoE router is f32
    whatever the model's dtype); `init="zeros"` for norm scales.  The draws
    come from the counter-based stream (`kernels/philox.py`, purpose INIT)
    keyed by one int64 drawn from `generator` when the init starts
    (`philox.stream_seed`), each element a function of (that seed, the
    leaf's index in the draw order, its index in the leaf's whole shape):
    the bits are the port's own, not JAX's, and they do not depend on
    which part of a leaf is drawn.  The fill is `ops.counter_trunc_normal`
    (the CUDA kernel on the card, its plain version on the CPU), into the
    parameter's own storage: no f32 copy of a leaf is formed.

    With `stack=n` every parameter gets a leading layer axis of n
    (`stacked(n)`: the same stream).  On the "meta" device nothing is drawn
    or allocated (shapes only).  `part`, given, maps (leaf index, whole
    shape) to the `philox.Part` of the leaf this rank draws and holds, or
    None for all of it (`launch.sharding.init_shards`); `drawn`, given, is
    a list each parameter is appended to as it is made, in draw order, as
    (tensor, whether it is filled from the stream: not zeros)."""

    def __init__(self, generator: Optional[torch.Generator], dtype,
                 device=None, stack: int = 0,
                 part: Optional[Callable] = None,
                 drawn: Optional[list] = None, stream=None):
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None else generator.device)
        self.stack = stack
        self.part = part
        self.drawn = drawn
        if stream is None:
            stream = _Stream(None if generator is None
                             or self.device.type == "meta"
                             else philox.stream_seed(generator))
        self.stream = stream

    def stacked(self, n: int) -> "ParamInit":
        """A ParamInit of the same stream whose parameters have a leading
        layer axis of n."""
        return ParamInit(None, self.dtype, self.device, stack=n,
                         part=self.part, drawn=self.drawn,
                         stream=self.stream)

    def param(self, shape: Tuple[int, ...], fan_in: Optional[int] = None,
              init: str = "normal", dtype=None) -> Tensor:
        leaf = self.stream.take()
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        part = self.part(leaf, full) if self.part is not None else None
        part = part or philox.Part.whole(full)
        dtype = dtype or self.dtype
        if init == "zeros":
            out = torch.zeros(part.shape, dtype=dtype, device=self.device)
        else:
            out = torch.empty(part.shape, dtype=dtype, device=self.device)
            if self.device.type != "meta":
                if self.stream.seed is None:
                    raise ValueError("ParamInit: drawing needs a generator")
                ops.counter_trunc_normal(
                    out, self.stream.seed, leaf, part,
                    1.0 / math.sqrt(fan_in if fan_in else shape[0]))
        if self.drawn is not None:
            self.drawn.append((out, init != "zeros"))
        return out


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm over the last axis, in f32, times (1 + scale), cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions: Tensor, head_dim: int,
                 theta: float) -> Tuple[Tensor, Tensor]:
    """cos and sin of the f32 angles positions[..., None] * rope_freqs:
    [..., head_dim // 2] each.  A decode step computes them once for all
    its layers."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x [..., S, H?, Dh] rotated pairwise by cos/sin [..., S, Dh/2].

    The pairs are interleaved, (x[..., 0::2], x[..., 1::2]), re-stacked on
    the last axis as the JAX package does (not the half-split layout).  The
    rotation is f32; the result is cast back to x's dtype."""
    while cos.dim() < x.dim():     # broadcast over head axes before Dh
        cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return xr.reshape(x.shape).to(x.dtype)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """RoPE of x [..., S, H?, Dh] at positions [..., S] (`rope_rotate`)."""
    return rope_rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def make_causal_mask(sq: int, sk: int, q_offset, window: Optional[int],
                     device=None) -> Tensor:
    """Boolean [Sq, Sk] mask (True = attend); query i sits at position
    q_offset + i, key j at j."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def softmax_xent(logits: Tensor, labels: Tensor, vocab: int) -> Tensor:
    """Stable CE over possibly vocab-padded logits, in f32: logits
    [..., Vp], labels [...] -> [...].  The padding columns (ids >= vocab)
    are set to -1e30, out of the log-sum-exp."""
    logits = logits.float()
    vp = logits.shape[-1]
    if vp > vocab:
        pad = torch.arange(vp, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


def softmax_xent_sharded(logits: Tensor, labels: Tensor, vocab: int,
                         axis) -> Tensor:
    """`softmax_xent` over logits whose last dim is split over the "model"
    ranks of `axis` (this rank's [..., Vp / M] columns, global ids
    axis.part(Vp)): the row max by an all_reduce MAX, the sum of exps by an
    all_reduce SUM, and the label's logit from the rank that holds it
    (zeros elsewhere, in the same SUM).  The padding ids (>= vocab) are
    masked in global ids, so they may fill the last ranks' columns."""
    logits = logits.float()
    v_loc = logits.shape[-1]
    lo = axis.index * v_loc
    if lo + v_loc > vocab:
        pad = torch.arange(lo, lo + v_loc, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    # the max only shifts the exps: the log-sum-exp's gradient is the
    # softmax whatever it is
    m = all_reduce_max(logits.detach().amax(dim=-1), axis.group)
    t = labels.long() - lo
    mine = (t >= 0) & (t < v_loc)
    ll = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    sums = reduce_out(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        ll.masked_fill(~mine, 0.0)], dim=-1), axis.group)
    return m + torch.log(sums[..., 0]) - sums[..., 1]


# the "model" axis of the innermost `tensor_parallel` block (as the
# reference scopes its sharding hints, `repro/models/common.py::_SHARD_CTX`)
_MODEL_AXIS = contextvars.ContextVar("repro_torch_model_axis", default=None)
# whether that block's residual stream is split over the axis on the
# sequence (`make_constrain`'s "model" entry)
_SEQ_SPLIT = contextvars.ContextVar("repro_torch_seq_split", default=False)


@contextlib.contextmanager
def tensor_parallel(axis, sequence: bool = False) -> Iterator[None]:
    """Inside the block every layer runs split over `axis` (a
    `launch.mesh.ModelAxis`): the parameters are this rank's shards
    (`launch.sharding.shard_params`) and the residual stream is
    replicated over the axis, or with sequence=True split over it on the
    sequence: each rank holds positions [r S / M, (r + 1) S / M) of every
    [B, S, d] activation between the layers, and M must divide S.  None
    or an axis of one rank changes nothing."""
    on = axis is not None and axis.size > 1
    token = _MODEL_AXIS.set(axis if on else None)
    seq = _SEQ_SPLIT.set(on and sequence)
    try:
        yield
    finally:
        _SEQ_SPLIT.reset(seq)
        _MODEL_AXIS.reset(token)


def model_shards():
    """The `ModelAxis` of the innermost `tensor_parallel` block, None
    outside one (or for one rank)."""
    return _MODEL_AXIS.get()


def seq_split() -> bool:
    """Whether the innermost `tensor_parallel` block splits the residual
    stream over its axis on the sequence."""
    return _SEQ_SPLIT.get()


@contextlib.contextmanager
def whole_residual() -> Iterator[None]:
    """Inside the block the residual stream is replicated over the
    `tensor_parallel` axis, split or not outside it (a VLM's prefix and
    token embeddings, joined before the stream is split)."""
    token = _SEQ_SPLIT.set(False)
    try:
        yield
    finally:
        _SEQ_SPLIT.reset(token)


def enter(x: Tensor) -> Tensor:
    """The residual x [B, S(/M), d] as this rank's shard of a layer reads
    it: through `copy_in`, or under the sequence split every rank's rows
    gathered (`gather_seq`); each rank's backward holds its shard's share
    of the gradient, summed over the axis.  x itself outside a
    `tensor_parallel` block."""
    axis = _MODEL_AXIS.get()
    if axis is None:
        return x
    return (gather_seq if _SEQ_SPLIT.get() else copy_in)(x, axis.group)


def leave(y: Tensor) -> Tensor:
    """A shard's partial product y [B, S, d] back into the residual: the
    sum over the axis (`reduce_out`), or under the sequence split this
    rank's rows of it (`scatter_seq`).  y itself outside a
    `tensor_parallel` block."""
    axis = _MODEL_AXIS.get()
    if axis is None:
        return y
    return (scatter_seq if _SEQ_SPLIT.get() else reduce_out)(y, axis.group)


def whole_seq(x: Tensor) -> Tensor:
    """The residual x whole on every rank, for a product of replicated
    weights (whose gradient is whole and the same on every rank): under
    the sequence split every rank's rows gathered, its backward this
    rank's rows of the gradient (`gather_out` on the sequence); else x."""
    if not _SEQ_SPLIT.get():
        return x
    return gather_out(x, _MODEL_AXIS.get().group, dim=1)


def local_seq(y: Tensor) -> Tensor:
    """y [B, S, d], whole and the same on every rank (a product of
    replicated weights, a gathered output), as the residual holds it:
    under the sequence split this rank's rows (`split_seq`); else y."""
    if not _SEQ_SPLIT.get():
        return y
    return split_seq(y, _MODEL_AXIS.get().group)


# the "data" axis and the data-sharded leaves of the innermost
# `storage_sharded` block: (axis, {id(leaf): (leaf, dim)})
_STORAGE = contextvars.ContextVar("repro_torch_storage", default=None)


@contextlib.contextmanager
def storage_sharded(axis, leaves, dims) -> Iterator[None]:
    """Inside the block each of `leaves` whose `dims` entry is not None is
    this rank's part of a leaf split on that dim over `axis` (a
    `launch.mesh.DataAxis`); `gathered` and `transformer._Layer.tree`
    join it where it is used.  An axis of one rank, or no split leaf,
    changes nothing."""
    split = {id(x): (x, d) for x, d in zip(leaves, dims) if d is not None}
    token = _STORAGE.set((axis, split) if split and axis is not None
                         and axis.size > 1 else None)
    try:
        yield
    finally:
        _STORAGE.reset(token)


def storage_dim(x: Tensor) -> Optional[int]:
    """The dim along which the innermost `storage_sharded` block splits
    leaf x over "data", or None."""
    ctx = _STORAGE.get()
    if ctx is None:
        return None
    hit = ctx[1].get(id(x))
    return hit[1] if hit is not None and hit[0] is x else None


def gather_storage_dim(x: Tensor, dim: int) -> Tensor:
    """x, a part along dim of a leaf the "data" ranks split, gathered
    whole (`launch.distributed.gather_storage`)."""
    return gather_storage(x, _STORAGE.get()[0].group, dim)


def gathered(x: Tensor) -> Tensor:
    """The whole of leaf x, where the innermost `storage_sharded` block
    splits it over "data"; else x itself."""
    dim = storage_dim(x)
    return x if dim is None else gather_storage_dim(x, dim)


# the context variables a recomputed region re-enters, each with what its
# value at the forward gives the recompute (`carry_into_recompute`)
_CARRIED: Dict[contextvars.ContextVar, Callable] = {}


def _as_is(value):
    return lambda: value


def carry_into_recompute(var: contextvars.ContextVar,
                         at_forward: Callable = _as_is) -> None:
    """Have every region `recompute` wraps re-enter `var` when its forward
    is recomputed: `at_forward(value)`, called at the forward with var's
    value then, returns the function that gives the value var holds
    during each recompute (by default that same value)."""
    _CARRIED[var] = at_forward


class _Reentered:
    """The recompute's side of `recompute`'s context: each carried
    variable set for the recompute, reset after it (reusable: a second
    backward recomputes again)."""

    def __init__(self, values):
        self.values = values
        self.tokens = []

    def __enter__(self):
        self.tokens = [(var, var.set(value())) for var, value in self.values]

    def __exit__(self, *exc):
        for var, token in reversed(self.tokens):
            var.reset(token)
        self.tokens = []


def recompute(fn: Callable, *args):
    """fn(*args) with the tensors its backward needs dropped after the
    forward and recomputed when the backward reaches them (a non-reentrant
    `torch.utils.checkpoint`, the reference's `jax.checkpoint`), the
    recompute run inside the context variables the forward ran in
    (`carry_into_recompute`): the backward runs after the step's `with`
    blocks have closed, and on the card in autograd's device thread.
    Collectives inside fn run again in the recompute, in the same order on
    every rank.  The recompute repeats the forward's operations on the
    same inputs, so it gives the same bits.  Where no backward can follow
    (grad off, or no tensor of args requires grad: prefill, decode) or a
    saved-tensor hook is refused (inside a `torch.func` transform: the
    sweep's per-worker `vmap(grad)`), fn runs as it is; so fn takes every
    tensor that may require grad as an argument."""
    if (torch._C._functorch.peek_interpreter_stack() is not None
            or not torch.is_grad_enabled()
            or not any(isinstance(a, Tensor) and a.requires_grad
                       for a in args)):
        return fn(*args)
    values = [(var, at(var.get())) for var, at in _CARRIED.items()]
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _Reentered(values)))


carry_into_recompute(_MODEL_AXIS)
carry_into_recompute(_SEQ_SPLIT)
carry_into_recompute(_STORAGE)


def count_params(params: Dict) -> int:
    """Number of elements over every tensor of a nested param dict."""
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())

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
`maybe_scan` has no counterpart: the port loops over layers in Python.
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

from repro_torch.launch.distributed import all_reduce_max, reduce_out

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
    """The JAX `ModelConfig` without its XLA execution knobs (model_parallel,
    remat, scan_layers, unroll_for_analysis); `dtype` is a torch dtype.
    `lm_head_chunk` stays: it decides how many positions the training loss
    projects to logits at once (`transformer.chunked_ce`).  `skip_shapes`
    stays: it is a model property, the input shapes a config does not run
    (`configs.registry.shape_applicable`).  `moe` is a `MoEConfig`, `mla`
    an `MLAConfig` (deepseek-v2-236b) and `ssm` an `SSMConfig`
    (mamba2-1.3b); `rglru_width` and `local_window` shape the RG-LRU
    hybrid (recurrentgemma-9b); encdec and frontend are carried only as None here: the
    port's model raises NotImplementedError on either (ROADMAP.md Queue 1
    item 10)."""
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

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        mult = 256
        return ((self.vocab_size + mult - 1) // mult) * mult


class ParamInit:
    """Draws parameters as the JAX `ParamFactory` does: truncated normal on
    [-2, 2] in f32, times 1/sqrt(fan_in) (fan_in defaults to shape[0]), cast
    to `dtype` (or the parameter's own `dtype`: the MoE router is f32
    whatever the model's dtype); `init="zeros"` for norm scales.  The draws
    come from an
    explicit `torch.Generator` on the parameters' device, so the bits are
    the port's own, not JAX's.

    With `stack=n` every parameter gets a leading layer axis of n and is
    drawn one layer at a time, so at most one layer's slice exists in f32.
    On the "meta" device nothing is drawn or allocated (shapes only).
    `keep`, given, maps each parameter as soon as it is drawn to what is
    kept of it (a rank's shard: `launch.sharding.init_shards`)."""

    def __init__(self, generator: Optional[torch.Generator], dtype,
                 device=None, stack: int = 0,
                 keep: Optional[Callable[[Tensor], Tensor]] = None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(
            device if device is not None else generator.device)
        self.stack = stack
        self.keep = keep

    def param(self, shape: Tuple[int, ...], fan_in: Optional[int] = None,
              init: str = "normal", dtype=None) -> Tensor:
        out = self._draw(shape, fan_in, init, dtype)
        return out if self.keep is None else self.keep(out)

    def _draw(self, shape, fan_in, init, dtype) -> Tensor:
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        dtype = dtype or self.dtype
        if init == "zeros":
            return torch.zeros(full, dtype=dtype, device=self.device)
        out = torch.empty(full, dtype=dtype, device=self.device)
        if self.device.type == "meta":
            return out
        scale = 1.0 / math.sqrt(fan_in if fan_in else shape[0])
        for piece in (out if self.stack else (out,)):
            draw = torch.empty(piece.shape, dtype=torch.float32,
                               device=self.device)
            torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.generator)
            piece.copy_(draw.mul_(scale))
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


@contextlib.contextmanager
def tensor_parallel(axis) -> Iterator[None]:
    """Inside the block every layer runs split over `axis` (a
    `launch.mesh.ModelAxis`): the parameters are this rank's shards
    (`launch.sharding.shard_params`) and the residual stream is replicated
    over the axis.  None or an axis of one rank changes nothing."""
    token = _MODEL_AXIS.set(axis if axis is not None and axis.size > 1
                            else None)
    try:
        yield
    finally:
        _MODEL_AXIS.reset(token)


def model_shards():
    """The `ModelAxis` of the innermost `tensor_parallel` block, None
    outside one (or for one rank)."""
    return _MODEL_AXIS.get()


def count_params(params: Dict) -> int:
    """Number of elements over every tensor of a nested param dict."""
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())

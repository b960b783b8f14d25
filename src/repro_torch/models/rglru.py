"""RG-LRU recurrent block of the port (Griffin / RecurrentGemma,
arXiv:2402.19427; `repro/models/rglru.py`).

Recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_i x_t + b_i)
    log a_t = -c softplus(Lambda) r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The block follows RecurrentGemma: x -> [gelu gate branch] * [conv1d ->
RG-LRU branch] -> out projection.  `jax.nn.gelu` defaults to the tanh
approximation, so the port's GELU is `approximate="tanh"`.  r and i are
computed in the input dtype and cast to f32; a, b and h are f32, and h is
cast back to x's dtype before the gate.

Training and prefill (`rglru_full`) run the recurrence as a scan over S of
the pairs (a_t, b_t) under the associative combine (a1 a2, b1 a2 + b2),
the reference's `jax.lax.associative_scan`: here a log-depth doubling
(Hillis-Steele) scan in f32, ceil(log2 S) rounds of a few elementwise
ops over the whole [B, S, W] block, so autograd runs through it and no
Python loop over S is made.  It is plain torch, as the reference is plain
jnp outside any Pallas kernel.  Decode (`rglru_decode_step`) is the O(1)
update against a constant state, the conv window [B, 3, W] in the model
dtype and h [B, W] in f32, written in place (as the SSD decode writes
its state), so the step stays capturable as a CUDA graph; it ignores pos.
The convolution pads 3 on the left and takes its 4 taps in the
reference's order in both forms, so decode agrees with prefill.

Over a "model" axis of M ranks (`common.tensor_parallel`; the reference's
specs, `cfg.shard(w)`): in_x, in_gate, conv_w, w_a and w_i are split on
their W columns, conv_b, b_a, b_i and lam on W, out on its W rows.  The
input enters through `copy_in`; a rank's gate branch, convolution and
recurrence are its W / M channels.  w_a and w_i keep whole rows, so the
convolved x of every rank is gathered (`launch.distributed.
gather_shards`: the backward is this rank's slice of the summed
gradient); the gates, the scan and the gate product are local, and one
`reduce_out` of out's partial products finishes the block.  A rank's
decode state is its W / M channels of the conv window and of h (the
reference's `cache_specs` splits W too).  M must divide W.  Under the
sequence split (`common.tensor_parallel(axis, sequence=True)`) the input
is the rank's rows: it enters through `common.enter` (the rows gathered:
the convolution and the scan need the whole sequence) and the output
leaves through `common.leave` (a reduce_scatter to the rank's rows).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.distributed import gather_shards
from repro_torch.models.common import (ModelConfig, ParamInit, enter, leave,
                                       model_shards)

Tensor = torch.Tensor
_C = 8.0


def width(cfg: ModelConfig) -> int:
    """The recurrent width W (cfg.rglru_width, default d_model)."""
    return cfg.rglru_width or cfg.d_model


def init_rglru(pi: ParamInit, cfg: ModelConfig) -> Dict:
    d, w = cfg.d_model, width(cfg)
    return {"in_x": pi.param((d, w), fan_in=d),
            "in_gate": pi.param((d, w), fan_in=d),
            "conv_w": pi.param((4, w), fan_in=4),
            "conv_b": pi.param((w,), init="zeros"),
            "w_a": pi.param((w, w), fan_in=w),
            "b_a": pi.param((w,), init="zeros"),
            "w_i": pi.param((w, w), fan_in=w),
            "b_i": pi.param((w,), init="zeros"),
            "lam": pi.param((w,), init="ones"),
            "out": pi.param((w, d), fan_in=w)}


def _gates(p: Dict, xr: Tensor, xr_all: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, b) of the recurrence, f32: xr the convolved x of this rank's
    channels, xr_all of every channel (the same tensor on one rank)."""
    r = torch.sigmoid(xr_all @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(xr_all @ p["w_i"] + p["b_i"])
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a ** 2, 1e-12))
    return a, beta * (i.float() * xr.float())


def _conv(p: Dict, x: Tensor) -> Tensor:
    """Causal depthwise conv over [B, S, W] with the 4 taps of conv_w,
    padded 3 on the left, then + conv_b."""
    k = p["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * p["conv_w"][i]
               for i in range(k)) + p["conv_b"]


def scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, as the
    inclusive scan of (a, b) under (a1, b1) . (a2, b2) = (a1 a2, b1 a2 +
    b2): at offset d each position combines the pair d back (positions
    below d keep theirs), for d = 1, 2, 4, ... < S."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = F.pad(a[:, :s - d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :s - d], (0, 0, d, 0))
        b = torch.addcmul(b, b_prev, a)
        a = a * a_prev
        d *= 2
    return b


def _local(p: Dict, x: Tensor) -> Tuple[Tensor, Tensor, object]:
    """x [..., d] -> (the gate branch's and the recurrent branch's
    projections of this rank's channels, the model group or None)."""
    axis = model_shards()
    group = None if axis is None else axis.group
    x = enter(x)
    return (F.gelu(x @ p["in_gate"], approximate="tanh"), x @ p["in_x"],
            group)


def _out(p: Dict, y: Tensor) -> Tensor:
    return leave(y @ p["out"])


def rglru_full(p: Dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """[B, S, d] -> [B, S, d]: the whole sequence through the scan."""
    gate, xr, group = _local(p, x)
    xr = _conv(p, xr)
    a, b = _gates(p, xr, gather_shards(xr, group))
    y = scan(a, b).to(x.dtype) * gate
    return _out(p, y)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None,
                     model_parallel: int = 1) -> Dict[str, Tensor]:
    """Zeroed decode state of one RG-LRU layer: the conv window [B, 3, W]
    in `dtype` and h [B, W] in f32; over model_parallel ranks, one rank's
    W / M channels."""
    w = width(cfg) // model_parallel
    return {"conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}


def rglru_decode_step(p: Dict, x1: Tensor, state: Dict[str, Tensor],
                      cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token update.  x1 [B, 1, d] -> ([B, 1, d], state); the conv
    window and h are written in place."""
    gate, xr1, group = _local(p, x1[:, 0])
    window = torch.cat([state["conv"], xr1[:, None]], dim=1)    # [B, 4, W]
    xr = torch.sum(window * p["conv_w"], dim=1) + p["conv_b"]
    a, b = _gates(p, xr, gather_shards(xr, group))
    h = a * state["h"] + b
    y = h.to(x1.dtype) * gate
    state["conv"].copy_(window[:, 1:])
    state["h"].copy_(h)
    return _out(p, y)[:, None], state

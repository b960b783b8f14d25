"""Mamba-2 SSD block of the port (state-space duality, arXiv:2405.21060;
`repro/models/ssm.py`).

Chunked dual form for training and prefill: within a chunk the quadratic
(attention-like) form, across chunks a linear recurrence over the
[H, N, P] states, carried in f32 (a Python loop over the chunks, where the
reference runs `lax.scan`).  Decode is the recurrent update

    state <- state * exp(dt A) + dt B (outer) x;   y = C . state

so long_500k decodes against a constant [B, H, N, P] state (no KV cache).
Plain torch, as the reference is plain jnp outside any Pallas kernel;
`ssd_full` keeps the reference's order of operations and casts (the
right-pad to a chunk multiple, the f32 cumsum / exp segments and the
causal tril, `att` cast to x's dtype, the chunk states in the input
dtype, the D skip, the gated RMS norm).  One difference: the segments
above the diagonal are masked before their exp, not after, which gives
the same values; the reference's `where(tril, exp(seg), 0)` overflows to
inf above the diagonal at long chunks (seg reaches ~+180 at the full
config's chunk of 256) and its gradient there is 0 * inf = NaN.  The
decode step writes its state (the [B, d_conv - 1, conv_ch] conv window
and the f32 ssm state) in place, so it stays capturable as a CUDA graph;
it ignores pos, as the reference does.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads; B / C are
grouped (ngroups, broadcast over heads with `repeat_interleave`, the
reference's `jnp.repeat`).  Over a "model" axis of M ranks
(`common.tensor_parallel`, the reference's specs): in_proj is split on
its output columns, in contiguous blocks that do not line up with the
z / xBC / dt boundaries, so each rank's product is gathered over the
group (`launch.distributed.gather_shards`); each rank convolves the
channels it needs (its heads' x and the shared B and C), computes y for
its heads (A_log / D / dt_bias split on heads), sums the gated norm's
mean square over the group (one all_reduce of the per-token sum of
squares), applies its slice of `norm` and its rows of out_proj, and
reduces the output once.  Its decode state holds its heads: the conv
window of its x channels plus B and C, the ssm state of its heads (the
reference's `cache_specs` splits the conv channels evenly, and the ssm
state's heads, or at full width its headdim; it changes no value).  M
must divide H.  Under the sequence split (`common.tensor_parallel(axis,
sequence=True)`) the block's input is the rank's rows: it enters through
`common.enter` (the rows gathered: the chunked scan needs the whole
sequence) and the output leaves through `common.leave` (a
reduce_scatter to the rank's rows); the gated norm's sum is unchanged.
The right-pad to a chunk multiple is applied to the projection's
outputs (the product of the zero rows the reference pads is zero).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.distributed import copy_in, gather_shards, reduce_out
from repro_torch.models.common import (ModelConfig, ParamInit, enter, leave,
                                       model_shards, rms_norm)

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.headdim


def init_ssm(pi: ParamInit, cfg: ModelConfig) -> Dict:
    s, d_in, nheads = _dims(cfg)
    d = cfg.d_model
    conv_ch = d_in + 2 * s.ngroups * s.d_state
    return {"in_proj": pi.param((d, d_in + conv_ch + nheads), fan_in=d),
            "conv_w": pi.param((s.d_conv, conv_ch), fan_in=s.d_conv),
            "conv_b": pi.param((conv_ch,), init="zeros"),
            "A_log": pi.param((nheads,), init="zeros"),
            "D": pi.param((nheads,), init="zeros"),
            "dt_bias": pi.param((nheads,), init="zeros"),
            "norm": pi.param((d_in,), init="zeros"),
            "out_proj": pi.param((d_in, d), fan_in=d_in)}


def _split_proj(proj: Tensor, cfg: ModelConfig):
    """The whole projection -> (z, xBC, dt)."""
    s, d_in, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    return (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * gn],
            proj[..., 2 * d_in + 2 * gn:])


def _split_xbc(xbc: Tensor, cfg: ModelConfig):
    """(x, B, C) of the channels a rank holds: its x channels, then the
    whole B and C."""
    s = cfg.ssm
    gn = s.ngroups * s.d_state
    d_x = xbc.shape[-1] - 2 * gn
    return xbc[..., :d_x], xbc[..., d_x:d_x + gn], xbc[..., d_x + gn:]


def _local(p: Dict, u: Tensor, cfg: ModelConfig):
    """The in_proj product of u [..., d] and the parts of it this rank
    reads: (z, xBC over its channels, dt of its heads, conv_w, conv_b of
    those channels, this rank's head slice of the whole heads)."""
    s, d_in, nheads = _dims(cfg)
    axis = model_shards()
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    if axis is None:
        z, xbc, dt = _split_proj(u @ w, cfg)
        return z, xbc, dt, cw, cb, slice(0, nheads)
    group = axis.group
    u = enter(u)
    if w.shape[1] < d_in + d_in + 2 * s.ngroups * s.d_state + nheads:
        proj = gather_shards(u @ w, group)   # this rank's columns, gathered
    else:                                    # in_proj replicated
        proj = u @ copy_in(w, group)
    z, xbc, dt = _split_proj(proj, cfg)
    hs, ds = axis.part(nheads), axis.part(d_in)
    cw, cb = copy_in(cw, group), copy_in(cb, group)
    return (z[..., ds], torch.cat([xbc[..., ds], xbc[..., d_in:]], dim=-1),
            dt[..., hs], torch.cat([cw[:, ds], cw[:, d_in:]], dim=-1),
            torch.cat([cb[ds], cb[d_in:]]), hs)


def _heads(bc: Tensor, cfg: ModelConfig, hs: slice) -> Tensor:
    """B or C [..., G * N] -> [..., H_loc, N]: the groups broadcast over
    the heads (repeat_interleave), this rank's heads."""
    s, _, nheads = _dims(cfg)
    g = bc.reshape(*bc.shape[:-1], s.ngroups, s.d_state)
    return g.repeat_interleave(nheads // s.ngroups, dim=-2)[..., hs, :]


def _gated_norm(y: Tensor, z: Tensor, scale: Tensor, cfg: ModelConfig,
                d_in: int) -> Tensor:
    """rms_norm(y * silu(z)) over d_inner; under `tensor_parallel` y, z
    and scale are this rank's slice and the sum of squares is summed over
    the group (its gradient too: every rank's slice reads it)."""
    g = y * F.silu(z)
    axis = model_shards()
    if axis is None:
        return rms_norm(g, scale, cfg.norm_eps)
    gf = g.float()
    ss = copy_in(reduce_out(gf.square().sum(dim=-1, keepdim=True),
                            axis.group), axis.group)
    out = gf * torch.rsqrt(ss / d_in + cfg.norm_eps)
    return (out * (1.0 + scale.float())).to(g.dtype)


def _out(p: Dict, y: Tensor) -> Tensor:
    return leave(y @ p["out_proj"])


def _causal_conv(xbc: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    """Depthwise causal conv1d over [B, S, C] with kernel [K, C], then
    silu."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + bias)


def ssd_full(p: Dict, u: Tensor, cfg: ModelConfig) -> Tensor:
    """Mamba-2 block over a full sequence.  u [B, S, d] -> [B, S, d] (under
    the sequence split the rank's rows of both)."""
    s, d_in, _ = _dims(cfg)
    q = s.chunk
    z, xbc, dt, cw, cb, hs = _local(p, u, cfg)
    bsz, slen, _ = xbc.shape
    if slen % q:   # right-pad to a chunk multiple (causal: nothing leaks)
        xbc, dt = (F.pad(t, (0, 0, 0, q - slen % q)) for t in (xbc, dt))
    nck = -(-slen // q)
    x, bmat, cmat = _split_xbc(_causal_conv(xbc, cw, cb), cfg)
    nh = hs.stop - hs.start
    xh = x.reshape(bsz, nck * q, nh, s.headdim)
    bh, ch = _heads(bmat, cfg, hs), _heads(cmat, cfg, hs)     # [B, S, H, N]

    a = -torch.exp(p["A_log"].float())                        # [H], < 0
    dt = F.softplus(dt.float() + p["dt_bias"].float())        # [B, S, H]
    da = dt * a

    def ck(t):
        return t.reshape(bsz, nck, q, *t.shape[2:])

    xc, bc, cc, dac, dtc = map(ck, (xh, bh, ch, da, dt))

    # intra-chunk (quadratic) term
    cs = torch.cumsum(dac, dim=2)                             # [B, C, Q, H]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # [B, C, Q, Q, H]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=u.device))[None, None, :, :, None]
    el = torch.exp(seg.masked_fill(~causal, float("-inf")))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cc, bc).float()
    att = scores * el * dtc[:, :, None, :, :]                 # dt at source
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", att.to(xc.dtype), xc)

    # chunk states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    wts = (torch.exp(cs[:, :, -1:, :] - cs) * dtc).to(xc.dtype)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", wts, bc, xc)

    # inter-chunk recurrence over the chunks, f32; the state entering each
    chunk_decay = torch.exp(torch.sum(dac, dim=2))            # [B, C, H]
    carry = torch.zeros(states[:, 0].shape, dtype=torch.float32,
                        device=u.device)
    prev = []
    for c in range(nck):
        prev.append(carry)
        carry = (carry * chunk_decay[:, c, :, None, None]
                 + states[:, c].float())
    prev_states = torch.stack(prev, dim=1)                    # [B, C, H, N, P]

    # the entering state's contribution to each position
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", cc,
                         prev_states.to(cc.dtype), torch.exp(cs).to(cc.dtype))

    y = (y_diag + y_off).reshape(bsz, nck * q, nh, s.headdim)
    y = (y + xh * p["D"].to(xh.dtype)[None, None, :, None])[:, :slen]
    y = _gated_norm(y.reshape(bsz, slen, nh * s.headdim), z, p["norm"], cfg,
                    d_in)
    return _out(p, y)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device=None,
                   model_parallel: int = 1) -> Dict[str, Tensor]:
    """Zeroed decode state of one SSD layer: the conv window [B, d_conv - 1,
    conv_ch] in `dtype` and the ssm state [B, H, N, P] in f32; over
    model_parallel ranks, one rank's (its x channels plus B and C, its
    heads)."""
    s, d_in, nheads = _dims(cfg)
    m = model_parallel
    conv_ch = d_in // m + 2 * s.ngroups * s.d_state
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, nheads // m, s.d_state, s.headdim),
                               dtype=torch.float32, device=device)}


def ssd_decode_step(p: Dict, u1: Tensor, state: Dict[str, Tensor],
                    cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token recurrent update.  u1 [B, 1, d] -> ([B, 1, d], state); the
    state's conv window and ssm state are written in place."""
    s, d_in, _ = _dims(cfg)
    bsz = u1.shape[0]
    z, xbc, dt, cw, cb, hs = _local(p, u1[:, 0], cfg)
    window = torch.cat([state["conv"], xbc[:, None]], dim=1)  # [B, K, C]
    xbc = F.silu(torch.sum(window * cw, dim=1) + cb)
    x, bvec, cvec = _split_xbc(xbc, cfg)
    nh = hs.stop - hs.start
    xh = x.reshape(bsz, nh, s.headdim)
    bh, chd = _heads(bvec, cfg, hs), _heads(cvec, cfg, hs)   # [B, H, N]

    a = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    decay = torch.exp(dt * a)                                 # [B, H]
    upd = (dt[..., None, None] * bh[..., :, None].float()
           * xh[..., None, :].float())                        # [B, H, N, P]
    new_ssm = state["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", chd.float(), new_ssm)
    y = y + xh.float() * p["D"].float()[None, :, None]
    y = y.reshape(bsz, nh * s.headdim).to(u1.dtype)
    y = _gated_norm(y, z, p["norm"], cfg, d_in)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(new_ssm)
    return _out(p, y)[:, None], state

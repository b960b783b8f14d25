"""Power-control policies for FLOA transmitters (paper §II-B.1/2).

Every policy maps (channel gains |h| [U], config) -> transmit amplitudes p [U]
subject to the per-worker constraint  D p_i^2 <= p_i^max   (paper eq. 4).

CI  (channel inversion, eq. 10):  p_i = b0 / |h_i| with
    b0^2 = P0_max * lambda,  P0_max = min_i p_i^max / D,
    lambda = E[min_i |h_i|^2] = 1 / sum_i (1/(2 sigma_i^2)).
BEV (best-effort voting, eq. 11):  p_i = sqrt(p_i^max / D), CSI-independent.
EF  (error-free benchmark, §IV-A): h == 1, z == 0, aggregate = mean.
TRUNCATED_CI (beyond paper): p_i = min(b0/|h_i|, sqrt(p_i^max/D)).

The `*_arrays` helpers take per-worker arrays [..., U] and per-lane scalars
[...] (dim), and reduce over the LAST axis, so they serve one scenario ([U]
arrays, scalar dim) and a stacked sweep ([S, U] arrays, dim [S]) alike.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Union

import torch

from repro_torch.core.channel import ChannelConfig, min_sq_gain_from_sigmas

Tensor = torch.Tensor


class Policy(str, enum.Enum):
    CI = "ci"
    BEV = "bev"
    EF = "ef"
    TRUNCATED_CI = "truncated_ci"


@dataclasses.dataclass(frozen=True)
class PowerConfig:
    """p_max: per-worker max transmit power (scalar or [U]); dim: gradient dim D."""

    num_workers: int
    dim: int
    p_max: Union[float, tuple] = 1.0
    policy: Policy = Policy.BEV

    def p_maxes(self) -> Tensor:
        p = torch.as_tensor(self.p_max, dtype=torch.float32)
        return torch.broadcast_to(p, (self.num_workers,)).clone()


def per_worker(x):
    """A per-lane scalar ([...] tensor, or a Python number) made to broadcast
    against per-worker arrays [..., U]."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def ci_b0_arrays(p_maxes: Tensor, sigmas: Tensor, dim) -> Tensor:
    """b0 = sqrt(P0_max * lambda) from raw arrays — the one CI power formula,
    shared by the dataclass path below and `core.scenario`."""
    p0_max = p_maxes.min(dim=-1).values / dim
    return torch.sqrt(p0_max * min_sq_gain_from_sigmas(sigmas))


def ci_b0(power: PowerConfig, channel: ChannelConfig) -> Tensor:
    """b0 = sqrt(P0_max * lambda), the common received amplitude under CI."""
    return ci_b0_arrays(power.p_maxes(), channel.sigmas(), float(power.dim))


def max_amplitude_arrays(p_maxes: Tensor, dim) -> Tensor:
    """sqrt(p_i^max / D) from raw arrays (shared with core.scenario)."""
    return torch.sqrt(p_maxes / per_worker(dim))


def max_amplitude(power: PowerConfig) -> Tensor:
    """sqrt(p_i^max / D): the BEV amplitude and the per-draw cap, [U]."""
    return max_amplitude_arrays(power.p_maxes(), float(power.dim))


def placed_amplitudes(power: PowerConfig, channel: ChannelConfig,
                      device) -> Dict[str, Tensor]:
    """`ci_b0` and `max_amplitude`, computed on the host as
    `transmit_amplitudes` computes them and placed on `device` once: a
    step captured in a CUDA graph may copy nothing from the host."""
    return {"ci_b0": ci_b0(power, channel).to(device),
            "max_amp": max_amplitude(power).to(device)}


def transmit_amplitudes(h_abs: Tensor, power: PowerConfig,
                        channel: ChannelConfig,
                        placed: Optional[Dict[str, Tensor]] = None
                        ) -> Tensor:
    """Per-worker transmit amplitude p_i for this round's channel draw.  [U].
    `placed`: `placed_amplitudes` on h_abs's device (else made here)."""
    if power.policy in (Policy.CI, Policy.TRUNCATED_CI, Policy.BEV):
        placed = placed or placed_amplitudes(power, channel, h_abs.device)
    if power.policy == Policy.CI:
        return placed["ci_b0"] / h_abs
    if power.policy == Policy.TRUNCATED_CI:
        return torch.minimum(placed["ci_b0"] / h_abs, placed["max_amp"])
    if power.policy == Policy.BEV:
        return torch.broadcast_to(placed["max_amp"], h_abs.shape)
    if power.policy == Policy.EF:
        # Error-free: the aggregate is the plain mean; model it as
        # p_i|h_i| = 1/U with h forced to 1 by the caller.
        return torch.full_like(h_abs, 1.0 / power.num_workers)
    raise ValueError(f"unknown policy {power.policy}")


def received_coefficients(h_abs: Tensor, power: PowerConfig,
                          channel: ChannelConfig) -> Tensor:
    """s_i = p_i |h_i|: the per-worker weight the MAC applies to worker i."""
    if power.policy == Policy.EF:
        return torch.full_like(h_abs, 1.0 / power.num_workers)
    return transmit_amplitudes(h_abs, power, channel) * h_abs

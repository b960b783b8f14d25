"""Wireless channel model for FLOA (paper §II-B).

Block Rayleigh fading: the channel gain of worker i at round t is
|h_{i,t}| ~ Rayleigh(scale=sigma_i), i.e. h ~ CN(0, 2 sigma_i^2) with
E[|h|] = sigma_i sqrt(pi/2) and E[|h|^2] = 2 sigma_i^2 (so |h|^2 ~ Exp with
rate lambda_i = 1/(2 sigma_i^2), paper §II-B.1).  Channels are resampled
independently every round and known perfectly at workers and PS.

AWGN: z_t ~ N(0, z^2 I_D) added to the received superposition; the paper sets
the receive SNR via p_max/(D z^2) = 10 dB and `noise_std_for_snr` inverts it.

The port covers the paper's block-i.i.d. model only; Gauss-Markov fading
(`markov_rho > 0`) is refused by the sweep (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Static description of the multiple-access channel.

    sigma: per-worker Rayleigh scale sigma_i (scalar broadcast or [U] tuple).
    noise_std: AWGN std z (per received symbol).
    markov_rho: Gauss-Markov round-to-round fading correlation in [0, 1);
        0 (default) is the paper's block-i.i.d. model.
    """

    num_workers: int
    sigma: Union[float, tuple] = 1.0
    noise_std: float = 0.0
    markov_rho: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.markov_rho < 1.0:
            raise ValueError(
                f"markov_rho must be in [0, 1), got {self.markov_rho} "
                f"(rho = 1 freezes the channel forever; use a static sigma "
                f"instead)")

    def sigmas(self) -> Tensor:
        s = torch.as_tensor(self.sigma, dtype=torch.float32)
        return torch.broadcast_to(s, (self.num_workers,)).clone()


def rayleigh_gains(generator: Optional[torch.Generator],
                   sigmas: Tensor) -> Tensor:
    """|h| = sigma * sqrt(2 * E), E ~ Exp(1), drawn from `generator` on
    sigmas' device (so |h|^2 ~ Exp(mean 2 sigma^2))."""
    e = torch.empty(sigmas.shape, dtype=torch.float32,
                    device=sigmas.device).exponential_(generator=generator)
    return sigmas * torch.sqrt(2.0 * e)


def min_sq_gain_from_sigmas(sigmas: Tensor) -> Tensor:
    """E[min_i |h_i|^2] = 1 / sum_i lambda_i with lambda_i = 1/(2 sigma_i^2),
    over the last (worker) axis: the minimum of independent exponentials is
    exponential with rate = sum of rates."""
    lam = 1.0 / (2.0 * sigmas**2)
    return 1.0 / lam.sum(dim=-1)


def noise_std_for_snr(p_max: float, dim: int, snr_db: float) -> float:
    """Solve p_max / (D z^2) = SNR for z (paper §IV: SNR = 10 dB)."""
    snr = 10.0 ** (snr_db / 10.0)
    return float((p_max / (dim * snr)) ** 0.5)

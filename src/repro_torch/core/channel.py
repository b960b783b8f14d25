"""Wireless channel model for FLOA (paper §II-B).

Block Rayleigh fading: the channel gain of worker i at round t is
|h_{i,t}| ~ Rayleigh(scale=sigma_i), i.e. h ~ CN(0, 2 sigma_i^2) with
E[|h|] = sigma_i sqrt(pi/2) and E[|h|^2] = 2 sigma_i^2 (so |h|^2 ~ Exp with
rate lambda_i = 1/(2 sigma_i^2), paper §II-B.1).  Channels are resampled
independently every round and known perfectly at workers and PS.

Time-varying extension (beyond the paper): Gauss-Markov fading with
per-round correlation rho on the complex gain, kept as a [..., 2] re/im
state,

    h_t = rho * h_{t-1} + sqrt(1 - rho^2) * w_t,   w_t ~ CN(0, 2 sigma^2),

so each component is N(0, sigma^2) at every t and |h_t| stays Rayleigh.
rho = 0 is the i.i.d. model; the sweep keeps rho = 0 lanes on the
`rayleigh_gains` draw.

AWGN: z_t ~ N(0, z^2 I_D) added to the received superposition; the paper sets
the receive SNR via p_max/(D z^2) = 10 dB and `noise_std_for_snr` inverts it.
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


def sample_channel_gains(generator: Optional[torch.Generator],
                         cfg: ChannelConfig, device=None) -> Tensor:
    """Draw |h_{i,t}| for all U workers for one round.  Shape [U]."""
    return rayleigh_gains(generator, cfg.sigmas().to(device))


def complex_gain_init(generator: Optional[torch.Generator],
                      sigmas: Tensor) -> Tensor:
    """Stationary complex-gain state for Gauss-Markov fading: re/im each
    N(0, sigma^2), shape sigmas.shape + (2,), so `complex_gain_abs` of it
    is Rayleigh(sigma), the marginal of `rayleigh_gains`.  The innovations
    of `gauss_markov_step` are fresh draws of the same law."""
    z = torch.randn(sigmas.shape + (2,), generator=generator,
                    device=sigmas.device)
    return sigmas[..., None] * z


def gauss_markov_step(h_prev: Tensor, innovation: Tensor, rho) -> Tensor:
    """One Gauss-Markov update h_t = rho h_{t-1} + sqrt(1-rho^2) w_t on
    [..., 2] states; rho is a number or a tensor broadcasting against them
    (one per lane)."""
    return rho * h_prev + torch.sqrt(
        torch.clamp_min(torch.as_tensor(1.0 - rho**2), 0.0)) * innovation


def complex_gain_abs(h: Tensor) -> Tensor:
    """|h| from the [..., 2] re/im state."""
    return torch.sqrt(torch.square(h).sum(dim=-1))


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

"""Closed-form convergence theory of the paper (Thms 2-3, Lemma 1, Remarks).

Everything is NumPy-scalar level (no jax needed) so benchmarks/tests can probe
the theory cheaply.  Notation matches the paper:

  U = M + N workers (M honest, N Byzantine), gradient dim D,
  sigma_i = Rayleigh scale of worker i's channel, p_i^max = max power,
  b0^2 = P0_max * lambda (CI amplitude), L = Lipschitz smoothness,
  delta^2 = per-worker gradient variance bound, eps = std bound, z = AWGN std.

CI  (Thm 2):  omega_CI   = M b0 - sum_n sqrt(pi sigma_n^2 p_n^max / (2D))
              Omega_CI   = (U+N) (U b0^2 + sum_n 2 sigma_n^2 p_n^max / D)
BEV (Thm 3):  omega_BEV  = sum_{i honest} sqrt(p_i^max pi/(2D)) sigma_i
                          - sum_{n byz}  sqrt(p_n^max pi/(2D)) sigma_n
              Omega_BEV  = (U+N) sum_{i=1..U} 2 sigma_i^2 p_i^max / D

Convergence iff  alpha^2 L/2 * Omega - alpha * omega < 0, i.e.
alpha < 2 omega / (L Omega) and omega > 0 (Remarks 1 & 4).

Attacker-count thresholds (iso case, Remarks 2 & 4):
  CI:  N <= U / (1 + sqrt(pi U));   BEV: N <= U/2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


def _vec(x, u: int) -> list:
    if isinstance(x, (int, float)):
        return [float(x)] * u
    xs = list(map(float, x))
    assert len(xs) == u
    return xs


@dataclasses.dataclass(frozen=True)
class TheoryParams:
    num_workers: int
    num_attackers: int
    dim: int
    sigma: object = 1.0  # scalar or [U]
    p_max: object = 1.0  # scalar or [U]
    byzantine_idx: Sequence[int] = ()  # which workers attack; default first N

    def __post_init__(self):
        idx = tuple(self.byzantine_idx) or tuple(range(self.num_attackers))
        object.__setattr__(self, "byzantine_idx", idx)
        assert len(idx) == self.num_attackers

    @property
    def sigmas(self) -> list:
        return _vec(self.sigma, self.num_workers)

    @property
    def p_maxes(self) -> list:
        return _vec(self.p_max, self.num_workers)

    @property
    def honest_idx(self) -> tuple:
        byz = set(self.byzantine_idx)
        return tuple(i for i in range(self.num_workers) if i not in byz)


def ci_b0(tp: TheoryParams) -> float:
    """b0 = sqrt(P0_max * lambda) with lambda = 1/sum_i 1/(2 sigma_i^2)."""
    p0 = min(tp.p_maxes) / tp.dim
    lam = 1.0 / sum(1.0 / (2.0 * s**2) for s in tp.sigmas)
    return math.sqrt(p0 * lam)


def omega_ci(tp: TheoryParams) -> float:
    b0 = ci_b0(tp)
    m = tp.num_workers - tp.num_attackers
    atk = sum(
        math.sqrt(math.pi * tp.sigmas[n] ** 2 * tp.p_maxes[n] / (2.0 * tp.dim))
        for n in tp.byzantine_idx
    )
    return m * b0 - atk


def Omega_ci(tp: TheoryParams) -> float:
    b0 = ci_b0(tp)
    u, n = tp.num_workers, tp.num_attackers
    atk = sum(2.0 * tp.sigmas[i] ** 2 * tp.p_maxes[i] / tp.dim for i in tp.byzantine_idx)
    return (u + n) * (u * b0**2 + atk)


def omega_bev(tp: TheoryParams) -> float:
    def term(i):
        return math.sqrt(tp.p_maxes[i] * math.pi / (2.0 * tp.dim)) * tp.sigmas[i]

    return sum(term(i) for i in tp.honest_idx) - sum(
        term(n) for n in tp.byzantine_idx
    )


def Omega_bev(tp: TheoryParams) -> float:
    u, n = tp.num_workers, tp.num_attackers
    return (u + n) * sum(
        2.0 * tp.sigmas[i] ** 2 * tp.p_maxes[i] / tp.dim for i in range(u)
    )


def omega_Omega(tp: TheoryParams, policy: str):
    policy = policy.lower()
    if policy == "ci":
        return omega_ci(tp), Omega_ci(tp)
    if policy == "bev":
        return omega_bev(tp), Omega_bev(tp)
    if policy == "ef":
        # Ideal: coefficients 1/U each, no channel/noise: omega = 1, Omega = 1
        # in the normalized sense of Lemma 1 (omega^2 == Omega when N=0).
        return 1.0, 1.0
    raise ValueError(policy)


def lr_upper_bound(tp: TheoryParams, policy: str, lipschitz: float) -> float:
    """alpha < 2 omega / (L Omega) (Remarks 1 & 4).  <=0 means divergence."""
    w, W = omega_Omega(tp, policy)
    return 2.0 * w / (lipschitz * W)


def converges(tp: TheoryParams, policy: str, alpha: float, lipschitz: float) -> bool:
    """The paper's convergence condition alpha^2 L/2 Omega - alpha omega < 0."""
    w, W = omega_Omega(tp, policy)
    return alpha**2 * lipschitz / 2.0 * W - alpha * w < 0.0


def alpha_from_alpha_hat(tp: TheoryParams, policy: str, alpha_hat: float,
                         lipschitz: float = 1.0, total_steps: int = 1) -> float:
    """Paper §IV: experiments set the scaled rate alpha_hat = (Omega/omega) alpha
    (= abar/(L sqrt(T))).  Returns raw alpha.  omega<=0 -> returns alpha for
    |omega| so experiments can still *run* (and visibly diverge, as in Fig 3).
    """
    w, W = omega_Omega(tp, policy)
    w = abs(w) if w != 0 else 1e-12
    return alpha_hat * w / W


def max_attackers_ci_iso(u: int) -> float:
    """Remark 2's stated bound N <= U / (1 + sqrt(pi U)) (iso case).

    Note: this is the paper's (conservative, sufficient) bound.  Solving
    omega_CI > 0 exactly from eq. (21) in the iso case gives the slightly
    larger `max_attackers_ci_iso_exact` = U / (1 + sqrt(pi U)/2); both are
    far below BEV's U/2 — the paper's qualitative claim is unaffected.
    """
    return u / (1.0 + math.sqrt(math.pi * u))


def max_attackers_ci_iso_exact(u: int) -> float:
    """Exact iso-case CI threshold: omega_CI > 0  <=>  N < this."""
    return u / (1.0 + math.sqrt(math.pi * u) / 2.0)


def max_attackers_bev_iso(u: int) -> float:
    """Remark 4: N <= U/2."""
    return u / 2.0


def rate_bound(
    tp: TheoryParams,
    policy: str,
    lipschitz: float,
    f0_minus_fstar: float,
    delta2: float,
    eps_bound: float,
    noise_std: float,
    total_steps: int,
    alpha_bar: float,
) -> float:
    """Thm 2/3 RHS: the bound on E[ (1/T) sum ||g_t||^2 ].

    (1/sqrt(T)) * ( 2 L Omega / (omega^2 abar) (F0-F*) +
                    abar (delta^2 + eps^2 z^2 / Omega) ).
    Requires omega > 0 (otherwise the bound is vacuous -> returns inf).
    """
    w, W = omega_Omega(tp, policy)
    if w <= 0:
        return float("inf")
    t = float(total_steps)
    return (1.0 / math.sqrt(t)) * (
        2.0 * lipschitz * W / (w**2 * alpha_bar) * f0_minus_fstar
        + alpha_bar * (delta2 + eps_bound**2 * noise_std**2 / W)
    )

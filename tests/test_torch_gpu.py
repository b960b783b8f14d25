"""The port's CUDA kernels on a card, against their plain PyTorch versions.

CUDA kernels have no CPU mode, so every test here carries the `gpu` marker
and skips without a card.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP
from repro_torch.core.attacks import AttackType
from repro_torch.core.power_control import Policy
from repro_torch.kernels import ops, ref

# tests/test_kernels.py: combine 1e-5 (f32) / 0.15 (bf16); stats 1e-4/1e-3.
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.15}
ROUNDS = 5
SMOKE = dataclasses.replace(PAPER_MLP.smoke(), d_hidden=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def _inputs(dev, seed, s, u, d, dtype):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    return (f(s, d).to(dev, dtype), f(s, u).to(dev), f(s, u, d).to(dev, dtype),
            f(s, d).to(dev, dtype), f(s).to(dev), f(s).to(dev),
            (torch.rand(s, generator=gen) * 0.2).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("s,u,d", [(4, 10, 50890), (1, 4, 512),
                                   (3, 32, 5000), (2, 8, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, s, u, d, dtype):
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, d, s, u, d, dtype)
    tol = TOL[dtype]
    ops.reset_launches()
    args = (w, c, g, z, bias, eps, alpha)
    for k, p in zip(ops.floa_step_batched(*args),
                    ops.floa_step_batched(*args, plain=True)):
        _close(k, p, tol)
    _close(ops.floa_aggregate_batched(c, g, z, bias, eps),
           ref.floa_aggregate_batched_ref(c, g, z, bias, eps), tol)
    _close(ops.floa_aggregate(c[0], g[0], z[0], bias[0], eps[0]),
           ref.floa_aggregate_ref(c[0], g[0], z[0], bias[0], eps[0]), tol)
    rows = g.reshape(s * u, d)
    np.testing.assert_allclose(ops.grad_stats(rows).cpu().numpy(),
                               ref.grad_stats_ref(rows).cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {k: 1 for k in ops.KERNELS}


@pytest.mark.gpu
def test_cuda_wrappers_reject_mixed_devices(cuda_device):
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, 0, 2, 3, 64,
                                           torch.float32)
    with pytest.raises(ValueError, match="on cpu"):
        ops.floa_step_batched(w, c.cpu(), g, z, bias, eps, alpha)


LANES = {
    "fig1": [TF.Experiment(n, p, rounds=ROUNDS)
             for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                          ("BEV", Policy.BEV)]],
    "fig3": [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                           attacker_sigma=3.0, rounds=ROUNDS)
             for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                               ("BEV", Policy.BEV)]],
    "gaussian": [TF.Experiment("BEV-gauss", Policy.BEV, n_attackers=2,
                               attack=AttackType.GAUSSIAN, rounds=ROUNDS),
                 TF.Experiment("CI-strong", Policy.CI, n_attackers=1,
                               rounds=ROUNDS)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("fig", sorted(LANES))
def test_kernel_route_matches_plain_route(cuda_device, fig):
    """One sweep through the kernels and again through their plain
    versions, from the same seeded draws; each round launches the path's
    kernels once."""
    exps = LANES[fig]
    ops.reset_launches()
    rk = TF.run_figure(exps, eval_every=2, mc=SMOKE, device=cuda_device)
    counts = ops.launch_counts()
    rp = TF.run_figure(exps, eval_every=2, mc=SMOKE, device=cuda_device,
                       force_plain=True)
    assert ops.launch_counts() == counts
    fused = fig != "gaussian"
    assert counts["grad_stats"] == ROUNDS
    assert counts["floa_step_batched"] == (ROUNDS if fused else 0)
    assert counts["floa_aggregate_batched"] == (0 if fused else ROUNDS)
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    for k in rk.params:
        torch.testing.assert_close(rk.params[k], rp.params[k], rtol=1e-4,
                                   atol=1e-6)

"""The paper's §IV claims on the port, with the port's own random draws.

The four claims of tests/test_convergence.py, at its thresholds, on the
port's looped `FLTrainer` (the same miniature: 1200 training and 400 test
digits, U = 10, the full 784-64-10 MLP, 80 rounds, batches of 32 per
worker from sampler seed 1).  Where the reference fixes PRNGKey(0) for
the weights and PRNGKey(42) / PRNGKey(1) for the rounds, each claim here
runs at two seeds s of the port's CPU generators: the He-normal init from
`torch.Generator().manual_seed(s)` and the rounds' gains and noise from the
trainer's seeded Philox streams (`rng = 42 + s`, Krum `1 + s`).  Nothing is
replayed from JAX, so this is the statistical check of the port's own draw
schedule: the claims must hold for the port's draws as they do for the
reference's.
"""
import functools

import pytest
import torch

from repro_torch.configs import PAPER_MLP
from repro_torch.core import theory
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig, noise_std_for_snr
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.data import FederatedSampler, make_dataset, worker_split
from repro_torch.fl import FLTrainer
from repro_torch.launch.staging import as_device_array
from repro_torch.models.mlp import init_mlp, mlp_accuracy, mlp_loss

pytestmark = pytest.mark.slow

U, ROUNDS = 10, 80
SEEDS = (0, 1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs are small (batches of 32 a worker on a 50 890-parameter
    MLP): one intra-op thread keeps them from oversubscribing the cores
    that the suite's other xdist workers share, which at the default
    thread count slows them by more than an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _data():
    x, y = make_dataset(1200, seed=0)
    xt, yt = make_dataset(400, seed=99)
    return (worker_split(x, y, U), as_device_array(xt, "cpu"),
            as_device_array(yt, "cpu"))


def _trainer(floa, alpha, **kw):
    _, xt, yt = _data()
    return FLTrainer(loss_fn=mlp_loss, floa=floa, alpha=alpha, device="cpu",
                     eval_fn=lambda p: {"accuracy": mlp_accuracy(p, xt, yt)},
                     **kw)


def _final(tr, seed, rng):
    """The last round's log of an 80-round run from seed's init."""
    shards, _, _ = _data()
    params = init_mlp(torch.Generator().manual_seed(seed))
    sampler = FederatedSampler(shards, batch_per_worker=32, seed=1)
    _, logs = tr.run(params, sampler, ROUNDS, rng, eval_every=ROUNDS - 1)
    return logs[-1]


@functools.lru_cache(maxsize=None)
def run(policy, n_atk, seed, alpha_hat=0.1, sigma=1.0):
    """tests/test_convergence.py::run on the port."""
    d = PAPER_MLP.full().dim
    tp = theory.TheoryParams(num_workers=U, num_attackers=n_atk, dim=d,
                             sigma=sigma)
    pol = "ef" if policy == Policy.EF else policy.value
    alpha = theory.alpha_from_alpha_hat(tp, pol, alpha_hat)
    floa = FLOAConfig(
        channel=ChannelConfig(num_workers=U, sigma=sigma,
                              noise_std=0.0 if policy == Policy.EF
                              else noise_std_for_snr(1.0, d, 10.0)),
        power=PowerConfig(num_workers=U, dim=d, p_max=1.0, policy=policy),
        attack=AttackConfig(
            attack=AttackType.STRONGEST if n_atk else AttackType.NONE,
            byzantine_mask=first_n_mask(U, n_atk)))
    return _final(_trainer(floa, alpha), seed, 42 + seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_fig1_benign_ci_close_to_ef(seed):
    ef = run(Policy.EF, 0, seed)
    ci = run(Policy.CI, 0, seed)
    bev = run(Policy.BEV, 0, seed)
    assert ef.accuracy > 0.8
    assert abs(ci.accuracy - ef.accuracy) < 0.05          # CI ~ EF
    assert bev.accuracy > 0.7                             # BEV converges too
    assert bev.accuracy <= ci.accuracy + 0.03             # ... a bit behind


@pytest.mark.parametrize("seed", SEEDS)
def test_fig4_ci_breaks_at_4_attackers_bev_survives(seed):
    ci = run(Policy.CI, 4, seed)
    bev = run(Policy.BEV, 4, seed)
    # N=4 > U/(1+sqrt(pi U)) = 1.51: CI diverges (loss explodes / chance acc)
    assert ci.accuracy < 0.35 or ci.loss > 2.0
    # BEV threshold U/2=5: still converging in the right direction
    assert bev.loss < ci.loss
    assert bev.accuracy > ci.accuracy


@pytest.mark.parametrize("seed", SEEDS)
def test_single_attacker_bev_beats_ci(seed):
    ci = run(Policy.CI, 1, seed)
    bev = run(Policy.BEV, 1, seed)
    assert bev.accuracy >= ci.accuracy - 0.02


@pytest.mark.parametrize("seed", SEEDS)
def test_digital_krum_defends(seed):
    """Beyond paper: in digital mode Krum screens the sign-flippers out."""
    d = PAPER_MLP.full().dim
    floa = FLOAConfig(
        channel=ChannelConfig(num_workers=U, sigma=1.0, noise_std=0.0),
        power=PowerConfig(num_workers=U, dim=d, p_max=1.0, policy=Policy.EF),
        attack=AttackConfig(attack=AttackType.STRONGEST,
                            byzantine_mask=first_n_mask(U, 3)))
    tr = _trainer(floa, 0.1, mode="digital", defense="krum",
                  defense_kwargs=dict(num_byzantine=3))
    assert _final(tr, seed, 1 + seed).accuracy > 0.8

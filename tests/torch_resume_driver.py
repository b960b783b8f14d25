"""Subprocess driver of the port's SIGKILL resume test
(tests/test_torch_resume.py::test_resume_after_sigkill), the counterpart of
tests/resume_driver.py.  It imports neither JAX nor the JAX package, so a
process starts in about a second.

One mixed sweep on the CPU (analog BEV, a Markov-fading lane carrying the
[S, U, 2] gain state, a colluding cohort, a digital median lane under the
grouped dispatch, an eval every 3rd round, the default seeded draws), run
in one of three modes:

  full <out>          uninterrupted chunked run; SweepResult.save(out)
  ckpt <dir>          checkpointed run that SIGKILLs itself right after its
                      2nd checkpoint commits (no clean-up, no atexit)
  resume <dir> <out>  a fresh process: run(resume=True) off <dir>'s latest
                      committed checkpoint; SweepResult.save(out)
"""
import os
import signal
import sys

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.fl import ExecutionPlan, ScenarioCase, SweepEngine, SweepSpec

ROUNDS = 10
CHUNK = 2
KILL_AFTER_SAVES = 2   # SIGKILL right after the 2nd checkpoint commits
U, BATCH, D_IN, D_H = 4, 8, 6, 5


def loss_fn(params, b):
    pred = torch.relu(b["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - b["y"]) ** 2)


def eval_fn(params):
    return {"accuracy": params["w1"].mean()}


def _floa(dim, policy, n_atk, noise=0.05, attack=AttackType.STRONGEST,
          rho=0.0):
    return FLOAConfig(
        channel=ChannelConfig(num_workers=U, sigma=1.0,
                              noise_std=0.0 if policy == Policy.EF else noise,
                              markov_rho=rho),
        power=PowerConfig(num_workers=U, dim=dim, p_max=1.0, policy=policy),
        attack=AttackConfig(attack=attack if n_atk else AttackType.NONE,
                            byzantine_mask=first_n_mask(U, n_atk)))


def build_problem(rounds=ROUNDS):
    """(params0, batches, spec): a regression MLP from seed 0."""
    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((D_IN, D_H)).astype(np.float32),
              "w2": rng.standard_normal((D_H, 1)).astype(np.float32)}
    x = rng.standard_normal((rounds, U * BATCH, D_IN)).astype(np.float32)
    y = (x @ rng.standard_normal((D_IN, 1))).astype(np.float32)
    dim = D_IN * D_H + D_H
    cases = [
        ScenarioCase("bev", _floa(dim, Policy.BEV, 1), 0.05, seed=400),
        ScenarioCase("markov", _floa(dim, Policy.BEV, 1, rho=0.9), 0.05,
                     seed=401),
        ScenarioCase("collude", _floa(dim, Policy.CI, 2,
                                      attack=AttackType.COLLUDING), 0.05,
                     seed=402),
        ScenarioCase("median", _floa(dim, Policy.EF, 1, 0.0), 0.05,
                     seed=403, defense=DefenseSpec(name="median")),
    ]
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            {"x": x, "y": y}, SweepSpec.build(cases))


def make_engine(spec, checkpoint_dir=None, **plan):
    plan = ExecutionPlan(chunk_rounds=CHUNK, checkpoint_dir=checkpoint_dir,
                         **plan)
    return SweepEngine(loss_fn, spec, eval_fn=eval_fn, eval_every=3,
                       plan=plan, device="cpu")


def main() -> None:
    torch.set_num_threads(1)
    mode = sys.argv[1]
    params, batches, spec = build_problem()
    if mode == "full":
        make_engine(spec).run(params, batches).save(sys.argv[2])
    elif mode == "ckpt":
        orig, count = ckpt_mod.save_pytree, [0]

        def save_then_die(*a, **k):
            out = orig(*a, **k)
            count[0] += 1
            if count[0] >= KILL_AFTER_SAVES:
                os.kill(os.getpid(), signal.SIGKILL)
            return out

        # The engine calls save_pytree through the module attribute, so
        # this is a preemption at an exact commit.
        ckpt_mod.save_pytree = save_then_die
        make_engine(spec, sys.argv[2]).run(params, batches)
        raise SystemExit("unreachable: the sweep outlived its SIGKILL")
    elif mode == "resume":
        make_engine(spec, sys.argv[2]).run(params, batches,
                                           resume=True).save(sys.argv[3])
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()

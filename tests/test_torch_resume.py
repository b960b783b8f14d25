"""Preemption-safe resume in the port: a checkpointed chunked sweep
continued with `run(..., resume=True)` is BITWISE the uninterrupted run.

The contracts of tests/test_sweep_resume.py restated on the port, on
tests/torch_resume_driver.py's mixed grid (flat state, grouped dispatch, a
Markov lane carrying the gain state, a colluding cohort, an eval every 3rd
round) with the default seeded draws, whose generator states the
checkpoint carries: in-process resume after chunk 1 and chunk 3 (under the
flat, tree-state and switch plans), the checkpoint cadence, a fresh start
on an empty directory, resume=True without a directory, incompatible
manifests (another chunking, another draw scheme, the JAX engine's own
checkpoints, and the JAX engine refusing the port's), `SweepResult`
save / load across both packages, a failed checkpoint write raising out of
`run`, a SIGKILLed subprocess, and `figures.run_showdown`'s
checkpoint_dir / resume.  Exact equality throughout.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.fl as JFL
    from sweep_testlib import tiny_problem

import torch_resume_driver as RD
from repro_torch import checkpoint as CK
from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP
from repro_torch.fl import ExecutionPlan, SweepEngine, SweepResult, SweepSpec
from torch_parity import axis_grids, jax_case, tiny_torch_loss, torch_params

ROOT = pathlib.Path(__file__).resolve().parents[1]


def assert_bitwise(a, b):
    assert tuple(a.names) == tuple(b.names)
    np.testing.assert_array_equal(np.asarray(a.loss), np.asarray(b.loss))
    np.testing.assert_array_equal(np.asarray(a.grad_norm),
                                  np.asarray(b.grad_norm))
    assert set(a.metrics) == set(b.metrics)
    for k in a.metrics:   # assert_array_equal treats NaN == NaN
        np.testing.assert_array_equal(np.asarray(a.metrics[k]),
                                      np.asarray(b.metrics[k]))
    assert set(a.params) == set(b.params)
    for k in a.params:
        np.testing.assert_array_equal(np.asarray(a.params[k]),
                                      np.asarray(b.params[k]))


def _steps(ckpt_dir):
    return sorted(int(f[len("ckpt_"):-len(".npz")])
                  for f in os.listdir(ckpt_dir) if f.endswith(".npz"))


def _prune_after(ckpt_dir, keep_step):
    """A preemption at `keep_step` rounds: drop every later checkpoint the
    uninterrupted run left behind."""
    for f in os.listdir(ckpt_dir):
        step = f[len("ckpt_"):].split(".")[0]
        if step.isdigit() and int(step) > keep_step:
            os.remove(os.path.join(ckpt_dir, f))
    assert CK.latest_step(str(ckpt_dir)) == keep_step


PLANS = {"flat_grouped": {}, "tree": dict(flat_state=False),
         "switch": dict(grouped_dispatch=False)}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("stop_after_rounds", [RD.CHUNK, 3 * RD.CHUNK])
def test_resume_bitwise_in_process(tmp_path, stop_after_rounds, plan):
    """Stop after chunk 1 or chunk 3, resume in a FRESH engine: the
    trajectories, metrics and final params equal the uninterrupted run."""
    params, batches, spec = RD.build_problem()
    full = RD.make_engine(spec, str(tmp_path), **PLANS[plan]).run(params,
                                                                   batches)
    assert _steps(tmp_path) == list(range(RD.CHUNK, RD.ROUNDS, RD.CHUNK))
    _prune_after(tmp_path, stop_after_rounds)
    resumed = RD.make_engine(spec, str(tmp_path), **PLANS[plan]).run(
        params, batches, resume=True)
    assert_bitwise(full, resumed)
    assert_bitwise(full, RD.make_engine(spec, **PLANS[plan]).run(params,
                                                                 batches))


def test_resume_checkpoint_cadence(tmp_path):
    """checkpoint_every_chunks=2: every 2nd boundary, the final chunk
    excluded; resume off the sparser schedule stays bitwise."""
    params, batches, spec = RD.build_problem()

    def engine():
        return SweepEngine(RD.loss_fn, spec, eval_fn=RD.eval_fn,
                           eval_every=3, device="cpu", plan=ExecutionPlan(
                               chunk_rounds=RD.CHUNK,
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every_chunks=2))

    full = engine().run(params, batches)
    assert _steps(tmp_path) == [4, 8]
    _prune_after(tmp_path, 4)
    assert_bitwise(full, engine().run(params, batches, resume=True))


def test_resume_fresh_start_when_no_checkpoint(tmp_path):
    params, batches, spec = RD.build_problem()
    baseline = RD.make_engine(spec).run(params, batches)
    resumed = RD.make_engine(spec, str(tmp_path)).run(params, batches,
                                                      resume=True)
    assert_bitwise(baseline, resumed)
    assert CK.latest_step(str(tmp_path)) is not None


def test_resume_requires_checkpoint_dir():
    params, batches, spec = RD.build_problem()
    with pytest.raises(ValueError, match="resume=True needs a checkpoint"):
        RD.make_engine(spec).run(params, batches, resume=True)


def test_resume_rejects_incompatible_checkpoint(tmp_path):
    """Another chunking or another draw scheme than the checkpoint's:
    a loud ValueError, not a silent drift."""
    params, batches, spec = RD.build_problem()
    RD.make_engine(spec, str(tmp_path)).run(params, batches)
    other = SweepEngine(RD.loss_fn, spec, eval_fn=RD.eval_fn, eval_every=3,
                        device="cpu", plan=ExecutionPlan(
                            chunk_rounds=5, checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="incompatible"):
        other.run(params, batches, resume=True)
    same = RD.make_engine(spec, str(tmp_path))
    draws = same.seeded_draws(RD.D_IN * RD.D_H + RD.D_H)
    with pytest.raises(ValueError, match="incompatible.*draws"):
        same.run(params, batches, draws=draws, resume=True)
    with pytest.raises(ValueError, match="incompatible.*flat_state"):
        RD.make_engine(spec, str(tmp_path), flat_state=False).run(
            params, batches, resume=True)


def test_resume_with_caller_draws_is_bitwise(tmp_path):
    """A caller's draws(t) is addressed by the absolute round: the
    checkpoint carries no generator state for it, and resume is bitwise."""
    params, batches, spec = RD.build_problem()
    d = RD.D_IN * RD.D_H + RD.D_H
    recorded = RD.make_engine(spec).seeded_draws(d)
    table = [recorded(t) for t in range(RD.ROUNDS)]
    full = RD.make_engine(spec, str(tmp_path)).run(
        params, batches, draws=lambda t: table[t])
    _prune_after(tmp_path, 2 * RD.CHUNK)
    resumed = RD.make_engine(spec, str(tmp_path)).run(
        params, batches, draws=lambda t: table[t], resume=True)
    assert_bitwise(full, resumed)
    assert_bitwise(full, RD.make_engine(spec).run(params, batches))


def test_failed_checkpoint_write_raises_out_of_run(tmp_path, monkeypatch):
    params, batches, spec = RD.build_problem()

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(CK.ckpt, "save_pytree", boom)
    with pytest.raises(OSError, match="disk full"):
        RD.make_engine(spec, str(tmp_path)).run(params, batches)


# ----------------------------------------------- across the two packages


def _tiny_grid():
    loss, jp, dim, batches = tiny_problem(rounds=6)
    cases = axis_grids(dim)["mixed"]
    return loss, jp, dim, batches, cases


def test_resume_rejects_a_jax_engine_checkpoint(tmp_path):
    """A resume directory the JAX engine wrote (same lanes, rounds, chunks
    and eval schedule) is refused: its carry holds keys, not the port's
    generator states."""
    loss, jp, dim, batches, cases = _tiny_grid()
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    JFL.SweepEngine(loss, jspec, eval_every=3, plan=JFL.ExecutionPlan(
        chunk_rounds=2, checkpoint_dir=str(tmp_path))).run(jp, batches)
    assert CK.latest_step(str(tmp_path)) == 4
    engine = SweepEngine(tiny_torch_loss, SweepSpec.build(cases),
                         eval_every=3, device="cpu", plan=ExecutionPlan(
                             chunk_rounds=2, checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="incompatible"):
        engine.run(torch_params(jp), batches, resume=True)


def test_jax_engine_rejects_a_port_checkpoint(tmp_path):
    loss, jp, dim, batches, cases = _tiny_grid()
    SweepEngine(tiny_torch_loss, SweepSpec.build(cases), eval_every=3,
                device="cpu", plan=ExecutionPlan(
                    chunk_rounds=2, checkpoint_dir=str(tmp_path))).run(
        torch_params(jp), batches)
    assert CK.latest_step(str(tmp_path)) == 4
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    with pytest.raises(ValueError, match="incompatible"):
        JFL.SweepEngine(loss, jspec, eval_every=3, plan=JFL.ExecutionPlan(
            chunk_rounds=2, checkpoint_dir=str(tmp_path))).run(
            jp, batches, resume=True)


def test_sweep_result_save_load_roundtrip_across_packages(tmp_path):
    """The port's saved result loads bitwise in the port and in
    `repro.fl.SweepResult.load`; the JAX package's loads in the port."""
    params, batches, spec = RD.build_problem()
    res = RD.make_engine(spec).run(params, batches)
    path = str(tmp_path / "result")
    res.save(path)
    got = SweepResult.load(path)
    assert_bitwise(res, got)
    assert isinstance(got.names, tuple) and got.index("markov") == 1
    assert all(isinstance(v, torch.Tensor) for v in got.params.values())
    jgot = JFL.SweepResult.load(path)
    assert_bitwise(res, jgot)
    jres = JFL.SweepResult(names=res.names, params={
        k: v.numpy() for k, v in res.params.items()}, loss=res.loss,
        grad_norm=res.grad_norm, metrics=res.metrics)
    jres.save(str(tmp_path / "jax_result"))
    assert_bitwise(res, SweepResult.load(str(tmp_path / "jax_result")))


def test_sweep_result_load_rejects_foreign_files(tmp_path):
    CK.save_pytree(str(tmp_path), 3, {"a": np.zeros(2)})
    with pytest.raises(ValueError, match="not a saved SweepResult"):
        SweepResult.load(str(tmp_path / "ckpt_3"))


# --------------------------------------------------- SIGKILLed subprocess


def test_resume_after_sigkill(tmp_path):
    """A subprocess running the checkpointed sweep SIGKILLs itself right
    after its 2nd checkpoint commits; a fresh process resumes and
    reproduces the uninterrupted run bitwise (compared through
    SweepResult.save / load)."""
    driver = str(ROOT / "tests" / "torch_resume_driver.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    ckpt_dir = str(tmp_path / "ckpt")
    full_out, resumed_out = str(tmp_path / "full"), str(tmp_path / "res")

    def run(*args, expect_sigkill=False):
        proc = subprocess.run([sys.executable, driver, *args], env=env,
                              capture_output=True, text=True, timeout=120)
        if expect_sigkill:
            assert proc.returncode == -9, (proc.returncode, proc.stderr)
        else:
            assert proc.returncode == 0, proc.stderr

    run("full", full_out)
    run("ckpt", ckpt_dir, expect_sigkill=True)
    assert CK.latest_step(ckpt_dir) == RD.KILL_AFTER_SAVES * RD.CHUNK
    run("resume", ckpt_dir, resumed_out)
    assert_bitwise(SweepResult.load(full_out), SweepResult.load(resumed_out))


# ------------------------------------------------ the showdown's resume


def test_run_showdown_resume_bitwise(tmp_path):
    """figures.run_showdown with the example's plan (chunks of R // 4
    rounds, a checkpoint at each boundary), preempted after 2 rounds and
    resumed, equals the uninterrupted run without checkpoints."""
    mc = dataclasses.replace(PAPER_MLP.smoke(), d_hidden=16)
    rounds = 5
    plain = TF.run_showdown(rounds, mc=mc, device="cpu")
    ckpt = str(tmp_path / "showdown")
    full = TF.run_showdown(rounds, mc=mc, device="cpu", checkpoint_dir=ckpt)
    assert _steps(ckpt) == [1, 2, 3, 4]
    _prune_after(ckpt, 2)
    resumed = TF.run_showdown(rounds, mc=mc, device="cpu",
                              checkpoint_dir=ckpt, resume=True)
    assert_bitwise(plain, full)
    assert_bitwise(plain, resumed)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TF.run_showdown(rounds, mc=mc, device="cpu", resume=True)

"""The port's multi-process bootstrap (`repro_torch.launch.distributed`) and
sweep mesh (`repro_torch.launch.mesh`), against the JAX package's
(tests/test_distributed_bootstrap.py, the mesh rules of
repro/launch/mesh.py):

  - `initialize_distributed` is a no-op returning False for one process
    (no arguments and no WORLD_SIZE, world_size=1, WORLD_SIZE=1);
  - `make_sweep_mesh` follows the reference's shape rules and raises its
    exception types; the axis helpers match the reference's;
  - a 2-process smoke (tests/torch_dist_driver.py, a gloo group on the
    CPU): the process-spanning ("data",) mesh, a chunked, checkpointed
    sweep against the process-local engine, rank 0 the only writer, and a
    resume from rank 0's latest step, broadcast, bitwise the
    uninterrupted run; a run stopped on every rank after its first
    checkpoint and resumed, bitwise too;
  - a rank that cannot read the checkpoint raises the reference's message.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.launch import mesh as JMESH
    from sweep_testlib import grid_cases, tiny_problem

import repro_torch
from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.launch import distributed as DIST
from repro_torch.launch import mesh as MESH
from torch_parity import (as_result, assert_bitwise, assert_port_close,
                          assert_ranks_agree, axis_grids, jax_case,
                          numpy_problem, port_sweep, run_ranks, sweep_job)

ROUNDS = 4


def test_initialize_distributed_single_process_noop(monkeypatch):
    """No arguments and no WORLD_SIZE, world_size=1, or WORLD_SIZE=1: no
    process group is started and the call returns False."""
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert DIST.initialize_distributed() is False
    assert DIST.initialize_distributed(world_size=1) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert DIST.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert DIST.world() == (0, 1)
    assert DIST.broadcast_int(7, "cpu") == 7
    with pytest.raises(ValueError, match="rank"):
        DIST.initialize_distributed(world_size=2, rank=2, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="world size"):
        DIST.initialize_distributed("file:///nonexistent", rank=0)


def test_collectives_without_a_group_are_identities():
    x = torch.arange(6.0).reshape(2, 3)
    assert DIST.all_gather(x, None, dim=1) is x
    assert DIST.all_reduce_sum(x, None) is x
    np.testing.assert_array_equal(DIST.fetch(x), x.numpy())
    np.testing.assert_array_equal(DIST.fetch(x, dim=0), x.numpy())
    np.testing.assert_array_equal(DIST.fetch([1, 2]), np.array([1, 2]))


@pytest.mark.parametrize("args,want", [
    ((8, 1, 1), (("data",), (8,))),
    ((8, 4, 1), (("data", "workers"), (2, 4))),
    ((8, 8, 1), (("workers",), (8,))),
    ((8, 1, 8), (("model",), (8,))),
    ((8, 2, 2), (("data", "workers", "model"), (2, 2, 2))),
    ((8, 1, 2), (("data", "model"), (4, 2))),
    ((4, 2, 2), (("workers", "model"), (2, 2))),
    ((1, 1, 1), (("data",), (1,)))])
def test_sweep_mesh_axes_follow_the_reference(args, want):
    """repro/launch/mesh.py::make_sweep_mesh's shapes (its docstring's
    examples among them), every one a plan accepts; with one process only
    the one-device mesh can be built."""
    axes, shape = MESH.sweep_mesh_axes(*args)
    assert (axes, shape) == want
    stand_in = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    plan = repro_torch.ExecutionPlan(mesh=stand_in)
    assert (plan.data_shards, plan.worker_shards, plan.model_shards) == (
        stand_in.shape.get("data", 1), args[1], args[2])
    if args[0] > 1:
        with pytest.raises(AssertionError, match="need"):
            MESH.make_sweep_mesh(*args)
    else:
        mesh = MESH.make_sweep_mesh(*args)
        assert mesh.axis_names == ("data",) and dict(mesh.shape) == {
            "data": 1}
        assert mesh.axis_index("data") == 0 and mesh.group("data") is None


def test_mesh_rules_and_axis_helpers():
    """The reference's AssertionErrors, the axis helpers, and the plan's
    derived worker / model shard counts off a mesh's shape."""
    with pytest.raises(AssertionError, match="need 2 devices"):
        MESH.make_sweep_mesh(2)
    with pytest.raises(AssertionError):
        MESH.make_sweep_mesh(1, worker_shards=0)
    with pytest.raises(AssertionError, match="not divisible"):
        MESH.make_sweep_mesh(1, worker_shards=2)
    mesh = MESH.make_debug_mesh((1, 1), ("data", "model"))
    assert mesh.axis_names == ("data", "model") and mesh.size == 1
    for name, helper in [("batch_axes", MESH.batch_axes),
                         ("num_workers", MESH.num_workers),
                         ("model_parallel", MESH.model_parallel)]:
        stand_in = SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": 4, "model": 2})
        assert helper(stand_in) == getattr(JMESH, name)(stand_in), name
    with pytest.raises(ValueError, match="differ in length"):
        MESH.make_debug_mesh((1,), ("data", "model"))
    assert repro_torch.make_sweep_mesh is MESH.make_sweep_mesh
    assert repro_torch.initialize_distributed is DIST.initialize_distributed


def test_resume_checkpoint_unreadable_raises_the_shared_filesystem_message(
        tmp_path, monkeypatch):
    """A rank that cannot read the step it was told to resume from raises
    FileNotFoundError naming the shared-filesystem requirement."""
    job = sweep_job("grid", grid_cases(35, 2), numpy_problem(
        tiny_problem(rounds=ROUNDS)), (1, 1, 1),
        dict(chunk_rounds=2, checkpoint_dir=str(tmp_path)))
    port_sweep(job)
    assert CKPT.latest_step(str(tmp_path)) == 2

    def missing(*a, **k):
        raise FileNotFoundError("gone")

    monkeypatch.setattr(CKPT, "restore_pytree", missing)
    engine, _ = port_sweep(dict(job, plan=dict(job["plan"])))
    with pytest.raises(FileNotFoundError, match="shared by every process"):
        engine.run({k: torch.from_numpy(np.array(v))
                    for k, v in job["params"].items()}, job["batches"],
                   resume=True)


def test_two_process_distributed_smoke(tmp_path):
    """Two processes, one gloo group on the CPU: the ("data",) mesh of
    every rank (make_sweep_mesh()), a chunked sweep that checkpoints,
    against the process-local engine; a resume from rank 0's latest step,
    and a run stopped on both ranks after its first checkpoint and
    resumed, both bitwise the uninterrupted run (also under the default
    seeded draws, with Markov gains and K-of-U masks in the carry); a
    zero-round sweep over 2 model shards."""
    problem = numpy_problem(tiny_problem(rounds=ROUNDS))
    cases = grid_cases(problem[2], 5)
    jobs = [sweep_job(name, cases, problem, (None, 1, 1), dict(
        chunk_rounds=2, checkpoint_dir=str(tmp_path / name)), **opts)
        for name, opts in [("smoke", dict(resume=True)),
                           ("stopped", dict(resume=True, preempt_after=1)),
                           ("smoke_seeded", dict(seeded=True))]]
    jobs.append(sweep_job("zero_rounds", cases, numpy_problem(
        tiny_problem(rounds=0)), (None, 1, 2)))
    # the default seeded draws through a checkpoint: every lane's generator
    # states, the Markov gains and the K-of-U masks live on the lanes'
    # ranks (9 lanes over 2 ranks, grouped: ghosts per family)
    axes = [jax_case(c) for c in axis_grids(problem[2])["mixed"]]
    for name, opts in [("axes_full", {}),
                       ("axes_stopped", dict(resume=True, preempt_after=1))]:
        jobs.append(sweep_job(name, axes, problem, (None, 1, 1), dict(
            chunk_rounds=2, checkpoint_dir=str(tmp_path / name)),
            seeded=True, **opts))
    results = run_ranks(jobs, 2, tmp_path / "run")
    assert_ranks_agree(results, "smoke", 2)
    got = as_result(results["smoke.r0"])
    assert results["smoke.r0"]["layout"]["exec_lanes"] == 6
    assert results["smoke.r1"]["layout"]["rows"] == [3, 4, 4]
    assert_port_close(got, port_sweep(jobs[0], plan={})[1], 1e-6, 1e-7)
    # only rank 0 wrote: one checkpoint, at the interior boundary
    assert CKPT.latest_step(str(tmp_path / "smoke")) == 2
    assert sorted(p.name for p in (tmp_path / "smoke").iterdir()) == [
        "ckpt_2.meta.json", "ckpt_2.npz"]
    # its fingerprint holds the padded lane count (6): one process (5
    # lanes, no ghost) refuses it
    with pytest.raises(ValueError, match="exec_lanes"):
        port_sweep(jobs[0], resume=True)
    for name in ("smoke", "stopped"):
        assert_ranks_agree(results, f"{name}.resumed", 2)
        assert_bitwise(as_result(results[f"{name}.resumed.r0"]), got)
    assert_ranks_agree(results, "smoke_seeded", 2)
    assert_port_close(as_result(results["smoke_seeded.r0"]),
                      port_sweep(jobs[2], plan={})[1], 1e-6, 1e-7)
    assert_ranks_agree(results, "axes_stopped.resumed", 2)
    full = as_result(results["axes_full.r0"])
    assert_bitwise(as_result(results["axes_stopped.resumed.r0"]), full)
    assert_port_close(full, port_sweep(jobs[5], plan={})[1], 1e-6, 1e-7)
    # no round at all, over 2 model shards: params0 and [S, 0] rows
    assert_ranks_agree(results, "zero_rounds", 2)
    zero = as_result(results["zero_rounds.r0"])
    assert zero.loss.shape == (5, 0)
    assert_bitwise(zero, port_sweep(jobs[3])[1])

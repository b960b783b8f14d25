"""One rank of the port's multi-process sweep tests (tests/test_torch_
sharded.py, test_torch_workers.py, test_torch_model_sharded.py,
test_torch_distributed.py).  Imports no JAX and nothing of the JAX package.

    torch_dist_driver.py RANK WORLD STORE JOBS OUT

Starts a `WORLD`-rank gloo process group on the CPU through
`initialize_distributed` (init_method file://STORE, a 60 s timeout), loads
the pickled job list JOBS (written by the parent test: port ScenarioCases,
numpy params and batches, and the JAX engine's replayed draws as numpy
arrays, so the ranks consume the reference's draws), and runs each job on
every rank in order.  A job:

    name      the result files' stem
    kind      "sweep" (a SweepEngine) or "lm_lane" (figures.run_lm_lane)
    mesh      make_sweep_mesh's (num_devices, worker_shards, model_shards)
    plan      the other ExecutionPlan knobs
    loss      "mlp" (tiny regression MLP) or a port ModelConfig (the LM)
    cases, params, batches, draws (list by round, or None: seeded),
    eval      True: the {"pnorm": sum of squares} eval every round
    baseline  also run the job unsharded (mesh None) on rank 0
    resume    also run a second engine resuming from the job's
              checkpoint_dir
    preempt_after  stop the job's run (every rank) right after its Nth
              checkpoint commits, as a preemption would, before the
              resuming engine runs

Each rank writes OUT/<name>.r<rank>.pt (and <name>.base.pt,
<name>.resumed.r<rank>.pt): the result's names, loss, grad norm, metrics,
params and the engine's layout (execution lanes, this rank's rows, the
shard sizes, the DeviceMesh's dims, the run's gathers of the state's
columns).  Prints TORCH_DIST_OK rank=<rank> at the end.
"""
import os
import pickle
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import figures as TF  # noqa: E402
from repro_torch.fl import ExecutionPlan, SweepEngine, SweepSpec  # noqa: E402
from repro_torch.fl import sweep as SW  # noqa: E402
from repro_torch.launch.distributed import (fetch,  # noqa: E402
                                            initialize_distributed)
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def mlp_loss(params, b):
    """tests/sweep_testlib.py::tiny_problem's loss."""
    pred = torch.relu(b["x"] @ params["w1"]) @ params["w2"]
    return torch.mean((pred - b["y"]) ** 2)


def pnorm_eval(p):
    """tests/test_sweep_workers.py::_eval_fn."""
    return {"pnorm": sum((x ** 2).sum() for x in tree_leaves(p))}


def _draws(rounds):
    if rounds is None:
        return None
    return lambda t: {k: None if v is None else torch.as_tensor(v)
                      for k, v in rounds[t].items()}


class Preempted(Exception):
    """Raised on every rank after the job's preempt_after-th checkpoint."""


def preempting(engine, after):
    """Make `engine` raise Preempted right after its `after`-th checkpoint
    (every rank writes or skips its checkpoint at the same boundary)."""
    save, count = engine._save_checkpoint, [0]

    def save_then_stop(*a, **k):
        save(*a, **k)
        count[0] += 1
        if count[0] >= after:
            raise Preempted
    engine._save_checkpoint = save_then_stop


def counting_gathers():
    """Count `_ModelShards.gather_cols` calls (the state's column gathers)
    in COL_GATHERS[0]."""
    gather = SW._ModelShards.gather_cols

    def counted(self, x):
        COL_GATHERS[0] += 1
        return gather(self, x)
    SW._ModelShards.gather_cols = counted


COL_GATHERS = [0]


def run_job(job, sharded=True, resume=False):
    """(SweepResult, layout) of one job on this rank."""
    COL_GATHERS[0] = 0
    if job["kind"] == "lm_lane":
        kw = dict(job["lm"], model_shards=job["mesh"][2] if sharded else 1)
        return TF.run_lm_lane(job["rounds"], device="cpu", **kw), {}
    mesh = make_sweep_mesh(*job["mesh"]) if sharded else None
    plan = ExecutionPlan(mesh=mesh, **job["plan"])
    if job["loss"] == "mlp":
        loss = mlp_loss
        params = tree_map(torch.as_tensor, job["params"])
    else:
        cfg = job["loss"]
        loss = (lambda p, b: TT.lm_loss(p, b, cfg))   # noqa: E731
        params = TT.params_from_jax(job["params"], "cpu")
    engine = SweepEngine(loss, SweepSpec.build(job["cases"]),
                         eval_fn=pnorm_eval if job.get("eval") else None,
                         plan=plan, device="cpu")
    if job.get("preempt_after") and not resume:
        preempting(engine, job["preempt_after"])
        try:
            engine.run(params, job["batches"], draws=_draws(job["draws"]))
        except Preempted:
            return None, {}
        raise AssertionError("the run outlived its preemption")
    res = engine.run(params, job["batches"], draws=_draws(job["draws"]),
                     resume=resume)
    ws, ms = engine._ws, engine._ms
    dm = None if mesh is None else mesh.device_mesh
    return res, {"axes": None if mesh is None else mesh.axis_names,
                 "shape": None if mesh is None else dict(mesh.shape),
                 "device_mesh": None if dm is None else (
                     dm.mesh_dim_names, tuple(dm.shape)),
                 "exec_lanes": len(engine._exec_src),
                 "rows": list(engine._rows),
                 "u_loc": None if ws is None else ws.u_loc,
                 "u_pad": None if ws is None else ws.u_pad,
                 "d_pad": None if ms is None else ms.d_pad,
                 "d_loc": None if ms is None else ms.d_loc,
                 "col_gathers": COL_GATHERS[0]}


def _save(res, layout, path):
    torch.save({"names": res.names, "loss": res.loss,
                "grad_norm": res.grad_norm, "metrics": res.metrics,
                "params": tree_map(lambda v: v.detach().cpu(), res.params),
                "layout": layout}, path)


def main(argv) -> int:
    rank, world, store, jobs_path, out = (int(argv[0]), int(argv[1]),
                                          argv[2], argv[3], argv[4])
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{store}", world_size=world,
                                  rank=rank, device="cpu", timeout_s=60)
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    counting_gathers()
    for job in jobs:
        res, layout = run_job(job)
        if res is not None:
            _save(res, layout, os.path.join(out, f"{job['name']}.r{rank}.pt"))
        if job.get("resume"):
            res, layout = run_job(job, resume=True)
            _save(res, layout, os.path.join(
                out, f"{job['name']}.resumed.r{rank}.pt"))
        if job.get("baseline") and rank == 0:
            res, layout = run_job(job, sharded=False)
            _save(res, layout, os.path.join(out, f"{job['name']}.base.pt"))
    # the reference's process_allgather: every rank's rows, in rank order
    assert fetch(torch.tensor([rank]), dim=0).tolist() == list(range(world))
    bad = [m for m in sys.modules if m in ("jax", "repro")
           or m.startswith(("jax.", "repro."))]
    assert not bad, bad
    torch.distributed.destroy_process_group()
    print(f"TORCH_DIST_OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

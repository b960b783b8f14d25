"""One rank of the port's multi-process tests (tests/test_torch_sharded.py,
test_torch_workers.py, test_torch_model_sharded.py,
test_torch_distributed.py: sweeps; test_torch_lm_mesh.py: the LM steps over
the worker axes).  Imports no JAX and nothing of the JAX package.

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
columns).

The LM-step jobs (`run_lm_job`) build `make_debug_mesh(*job["mesh"])`
(shape, axis names) over every rank and write OUT/<name>.r<rank>.pt, a
dict of tensors:

    train_step  `make_train_step` on job["arch"]'s smoke config from the
                numpy params `params0`, one step a `tokens` entry (the
                global batch; with its `extra` entry's inputs, a VLM's
                embeds_prefix or an encoder-decoder's frames, when the
                job has them) with `draws` (h_abs and one z a leaf, a list
                by step; None: seeded) and the `policy`, `use_floa`,
                `alpha`, `batch`, `seq`: the final params, and per step
                gbar, eps2, loss and grad_scale; the mesh's worker layout.
                "constrain" goes to the step ("sequence", the default, or
                "batch_only"; meta["constrain"] is the route of its shape);
                "remat" replaces the config's remat; "replay" runs the
                steps twice from `params0`, remat off recording the
                experts in a `moe.RoutingTape` (its result "recorded"),
                then remat on replaying them, and returns the tape's
                counts ("tape")
    prefill     `make_prefill_step` on `tokens` [B, S] (and an
                encoder-decoder's `extra` frames), its "constrain": the
                logits and meta["constrain"] (a batch of tokens alone:
                the step is built for its shape, so the route it took)
    decode      `make_decode_step(cfg, mesh=...)` teacher-forced through
                `tokens` [B, n] from empty caches of `batch_rows` rows:
                logits [n, B, Vp], the caches' batch, decode launches; an
                encoder-decoder's against the cross K / V of `frames`
                (`make_cross_kv_step`)
    serve       `launch.serve.serve(cfg, batch, prompt_len, gen, seed,
                mesh=...)`: tokens and logits
    seq_partial `decode_local_partial` on this rank's share of the S
                positions of q, k, v (numpy) at `pos`, then
                `combine_partials` over the mesh's "model" group
    refusals    the messages of the mesh refusals: a tuple (data, model)
                shape, a mesh of half the ranks, a batch U does not divide

On a mesh with a "model" axis of M > 1 (test_torch_lm_tp.py) the train,
prefill and decode jobs shard `params0` (`launch.sharding.shard_params` of
the step's `params_specs`), the train job returns the params gathered back
(`gather_params`) and every job its `model` (M, index) and the local
shapes; `moe_impl` replaces the MoE config's impl, and a dict "config"
replaces fields of the smoke config (its heads, widths).  The steps run with
FSDP on (`launch.sharding.data_specs`: `params0` sharded over "data" too,
and gathered back over both axes) unless the job says "fsdp": False;
"fsdp_min_size" lowers `launch.sharding.FSDP_MIN_SIZE` for the job (so
smoke leaves shard), and each of these jobs returns its `stored_bytes`,
the bytes of the rank's shards.  Three more kinds:

    ce          the vocab-parallel CE: `transformer.chunked_ce` of numpy
                `h` [B, S, d] against `labels` under `tensor_parallel`,
                plus the embedding of `labels` weighted by `r`, from the
                shards of `params0` ({"embed"[, "lm_head"]}) of the config
                job["cfg"]: the CE and the gradients of h and of the
                gathered params
    layout      shard_params / gather_params of `params0` on `mesh`,
                `init_model(..., mesh=)` and the shards of the whole
                draw, the worker and model axes, default_floa's worker
                count, and the refusals of an unported MLA head layout
                and of --mesh single
    seq_ops     `gather_seq`, `scatter_seq` and `split_seq` over the
                "model" group on this rank's rows of the numpy `x`
                [B, S, d] (scatter_seq's input x times rank + 1), each
                output's gradient under the weights `w[rank]`: the
                outputs and the gradients of the inputs
    saved       the train step of the smoke config under remat (its
                "config" replaced) from `params0` on `tokens[0]`, for
                each constrain, with `saved_tensors_hooks` recording the
                shape of every [B, *, d] tensor the step saves for its
                backward
    count       `launch.dryrun.trace_step` of the smoke config's step at
                `shape` (`shape_name`) run for real on this rank's CPU
                zeros (route "cpu", fake=False): its operations,
                collectives and argument bytes, to hold a fake trace
                against

Prints TORCH_DIST_OK rank=<rank> at the end.
"""
import dataclasses
import os
import pickle
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import figures as TF  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.power_control import Policy  # noqa: E402
from repro_torch.fl import ExecutionPlan, SweepEngine, SweepSpec  # noqa: E402
from repro_torch.fl import sweep as SW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.distributed import (fetch,  # noqa: E402
                                            initialize_distributed)
from repro_torch.launch.mesh import (data_axis,  # noqa: E402
                                     make_debug_mesh, make_sweep_mesh,
                                     mesh_from_arg, model_axis, worker_axes)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.sharding import (gather_params,  # noqa: E402
                                         param_specs, shard_params)
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tensor_parallel  # noqa: E402
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


LM_KINDS = ("train_step", "prefill", "decode", "serve", "seq_partial",
            "seq_ops", "saved",
            "refusals", "ce", "layout", "count")
FSDP_MIN_SIZE = SH.FSDP_MIN_SIZE


def _raised(fn):
    """(exception type name, message) of fn()'s exception; None if none."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 -- the parent checks the type
        return type(e).__name__, str(e)
    return None


def smoke_config(job):
    """The smoke config of job["arch"], its fields replaced by the job's
    "config" dict."""
    return dataclasses.replace(get_smoke(job["arch"]),
                               **job.get("config", {}))


def run_lm_job(job):
    """One LM-step job on this rank (see the module docstring)."""
    kind = job["kind"]
    SH.FSDP_MIN_SIZE = job.get("fsdp_min_size", FSDP_MIN_SIZE)
    if kind == "refusals":
        step, _ = ST.make_train_step(get_smoke("qwen3-4b"), make_debug_mesh(
            (4, 1), ("data", "model")))
        six = {"tokens": torch.zeros(6, 9, dtype=torch.int32)}
        return {"model_axis": _raised(lambda: worker_axes((2, 2))),
                "half_mesh": _raised(lambda: make_debug_mesh(
                    (2, 1), ("data", "model"))),
                "batch": _raised(lambda: step(None, None, six, 0))}
    mesh = make_debug_mesh(*job["mesh"])
    axis = model_axis(mesh)
    if kind in ("ce", "layout"):
        return (ce_job if kind == "ce" else layout_job)(job, mesh, axis)
    if kind == "count":
        return DRY.trace_step(get_smoke(job["arch"]), job["shape_name"],
                              job["shape"], mesh, route="cpu", fake=False)
    if kind == "seq_ops":
        return seq_ops_job(job, axis)
    if kind == "seq_partial":
        q, k, v = (torch.as_tensor(job[n]) for n in "qkv")
        ranks, r = mesh.shape["model"], mesh.axis_index("model")
        s_loc = k.shape[1] // ranks
        local = slice(r * s_loc, (r + 1) * s_loc)
        valid = (torch.arange(r * s_loc, (r + 1) * s_loc)[None, :]
                 <= job["pos"]).expand(q.shape[0], s_loc)
        m, l, acc = ATT.decode_local_partial(q, k[:, local], v[:, local],
                                             valid)
        return {"out": ATT.combine_partials(m, l, acc, mesh.group("model"))}
    cfg = smoke_config(job)
    if job.get("moe_impl"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=job["moe_impl"]))
    if kind == "serve":
        res = serve(cfg, job["batch"], job["prompt_len"], job["gen"],
                    device="cpu", seed=job["seed"], mesh=mesh)
        return {"tokens": res.tokens, "logits": res.logits}
    params = TT.params_from_jax(job["params0"], "cpu")
    specs = param_specs(cfg, axis.size)
    fsdp = job.get("fsdp", True)
    dspecs = SH.data_specs(cfg, axis.size, data_axis(mesh).size) \
        if fsdp else None
    params = shard_params(params, specs, mesh, dspecs)
    model = {"model": (axis.size, axis.index)} if axis.size > 1 else {}
    model["stored_bytes"] = sum(x.numel() * x.element_size()
                                for x in tree_leaves(params))
    if kind == "prefill":
        batch = {k: torch.as_tensor(v) for k, v in job.get("extra",
                                                          {}).items()}
        batch["tokens"] = torch.as_tensor(job["tokens"])
        b, n = batch["tokens"].shape
        step, meta = ST.make_prefill_step(
            cfg, mesh, None if len(batch) > 1 else dict(
                global_batch=b, seq_len=n),
            fsdp=fsdp, constrain=job.get("constrain", "sequence"))
        return {"logits": step(params, batch),
                "constrain": meta["constrain"], **model}
    if kind == "saved":
        return saved_job(job, cfg, mesh, params)
    if kind == "decode":
        tokens = torch.as_tensor(job["tokens"])
        b, n = tokens.shape
        step, meta = ST.make_decode_step(cfg, mesh=mesh, fsdp=fsdp)
        rows = ST.batch_rows(mesh, b)
        if cfg.arch_type == "audio":
            cross = ST.make_cross_kv_step(cfg, mesh, fsdp=fsdp)[0](
                params, torch.as_tensor(job["frames"]))
            caches = ED.init_dec_caches(cfg, rows.stop - rows.start, n,
                                        model_parallel=axis.size)
            one = lambda i: step(params, caches, cross,  # noqa: E731
                                 tokens[:, i:i + 1], i)
        else:
            caches = TT.init_caches(cfg, rows.stop - rows.start, n,
                                    window=meta["window"],
                                    model_parallel=axis.size)
            one = lambda i: step(params, caches,  # noqa: E731
                                 tokens[:, i:i + 1], i)
        ops.reset_launches()
        logits = torch.stack([one(i)[0][:, 0] for i in range(n)])
        return {"logits": logits, "cache_batch": rows.stop - rows.start,
                "cache_shape": tuple(tree_leaves(caches)[0].shape),
                "decode_launches": ops.launch_counts()["decode_attention"],
                **model}
    if "remat" in job:
        cfg = dataclasses.replace(cfg, remat=job["remat"])
    if not job.get("replay"):
        return {**train_run(job, cfg, mesh, params, fsdp, specs, dspecs),
                **model}
    tape = MOE.RoutingTape()
    with MOE.routing(tape):
        recorded = train_run(job, dataclasses.replace(cfg, remat=False),
                             mesh, params, fsdp, specs, dspecs)
    with MOE.routing(tape.replay()):
        res = train_run(job, dataclasses.replace(cfg, remat=True), mesh,
                        params, fsdp, specs, dspecs)
    return {**res, **model,
            "recorded": {k: recorded[k] for k in ("params", "log")},
            "tape": {"recorded": len(tape.recorded), "cursor": tape.cursor,
                     "decisions": tape.decisions, "flips": int(tape.flips)}}


def train_run(job, cfg, mesh, params, fsdp, specs, dspecs):
    """The train_step job's steps of cfg from this rank's `params`: the
    final params (gathered back over a split axis), the log and meta."""
    step, meta = ST.make_train_step(
        cfg, mesh, dict(global_batch=job["batch"], seq_len=job["seq"],
                        kind="train"),
        policy=Policy(job["policy"]), alpha=job["alpha"],
        use_floa=job["use_floa"], fsdp=fsdp,
        constrain=job.get("constrain", "sequence"))
    wa = worker_axes(mesh)
    state, log, shapes = ST.init_floa_state(), [], {}
    for t, toks in enumerate(job["tokens"]):
        draws = job["draws"][t] if job["draws"] and job["use_floa"] else None
        if draws is not None:
            draws = {"h_abs": torch.as_tensor(draws["h_abs"]),
                     "z": [torch.as_tensor(z) for z in draws["z"]]}
        batch = {"tokens": torch.as_tensor(toks)}
        if job.get("extra"):
            batch.update({k: torch.as_tensor(v)
                          for k, v in job["extra"][t].items()})
        params, state, m = step(params, state, batch, t, draws=draws)
        log.append({**state, **m})
    if model_axis(mesh).size > 1 or any(d is not None
                                        for d in tree_leaves(dspecs)):
        shapes["shapes"] = [tuple(x.shape) for x in tree_leaves(params)]
        params = gather_params(params, specs, mesh, dspecs)
    return {"params": params, "log": log, "meta": meta,
            "worker": (wa.num_workers, wa.first, wa.count), **shapes}


def seq_ops_job(job, axis):
    """The sequence-parallel collectives on this rank (see the module
    docstring)."""
    from repro_torch.launch.distributed import (gather_seq, scatter_seq,
                                                split_seq)
    x, w = torch.as_tensor(job["x"]), torch.as_tensor(job["w"][axis.index])
    s = x.shape[1] // axis.size
    rows = slice(axis.index * s, (axis.index + 1) * s)
    out, grads = {}, {}
    for name, fn, arg, weight in (
            ("gather", gather_seq, x[:, rows], w),
            ("scatter", scatter_seq, x * (axis.index + 1), w[:, rows]),
            ("split", split_seq, x, w[:, rows])):
        arg = arg.clone().requires_grad_(True)
        y = fn(arg, axis.group)
        grads[name], = torch.autograd.grad((y * weight).sum(), [arg])
        out[name] = y.detach()
    return {"out": out, "grads": grads, "model": (axis.size, axis.index)}


def saved_job(job, cfg, mesh, params):
    """The shapes of the [B, *, d] tensors one remat train step saves for
    its backward, by constrain (see the module docstring)."""
    cfg = dataclasses.replace(cfg, remat=True)
    batch = {"tokens": torch.as_tensor(job["tokens"][0])}
    res = {}
    for constrain in ("sequence", "batch_only"):
        step, meta = ST.make_train_step(
            cfg, mesh, dict(global_batch=job["batch"], seq_len=job["seq"],
                            kind="train"), alpha=job["alpha"],
            constrain=constrain)
        shapes = []

        def pack(t):
            if t.dim() == 3 and t.shape[-1] == cfg.d_model and \
                    t.shape[0] == job["batch"]:
                shapes.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step(params, ST.init_floa_state(), batch, 0)
        res[constrain] = {"shapes": shapes, "route": meta["constrain"]}
    return res


def ce_job(job, mesh, axis):
    """The vocab-parallel CE and its gradients on this rank (see the module
    docstring)."""
    cfg = job["cfg"]
    specs = {k: v for k, v in param_specs(cfg, axis.size).items()
             if k in job["params0"]}
    full = tree_map(torch.as_tensor, job["params0"])
    local = shard_params(full, specs, mesh)
    local = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    h = torch.as_tensor(job["h"]).requires_grad_(True)
    labels = torch.as_tensor(job["labels"])
    with tensor_parallel(axis):
        ce = TT.chunked_ce(local, h, labels, cfg)
        x = TT.embed_tokens(local, labels, cfg)
    loss = ce.sum() + (x * torch.as_tensor(job["r"])).sum()
    gh, *gp = torch.autograd.grad(loss, [h] + [local[k] for k in
                                               sorted(local)])
    grads = dict(zip(sorted(local), gp))
    return {"ce": ce.detach(), "embedded": x.detach(), "grad_h": gh,
            "grads": gather_params(grads, specs, mesh),
            "model": (axis.size, axis.index)}


def layout_job(job, mesh, axis):
    """The shard / gather round trip and the mesh's axes on this rank."""
    cfg = smoke_config(job)
    full = TT.params_from_jax(job["params0"], "cpu")
    specs = param_specs(cfg, axis.size)
    local = shard_params(full, specs, mesh)
    wa = worker_axes(mesh)
    floa = ST.default_floa(mesh, ST.param_count(cfg))
    # MLA heads the "model" axis does not divide: still refused
    mla = dataclasses.replace(get_smoke("deepseek-v2-236b"), n_heads=3)
    return {"round_trip": gather_params(local, specs, mesh),
            "drawn": ST.init_model(cfg, torch.Generator().manual_seed(4),
                                   "cpu", mesh=mesh),
            "sliced": shard_params(ST.init_model(
                cfg, torch.Generator().manual_seed(4), "cpu"), specs, mesh),
            "local_shapes": [tuple(x.shape) for x in tree_leaves(local)],
            "worker": (wa.num_workers, wa.first, wa.count),
            "model": (axis.size, axis.index),
            "num_workers": ST.num_workers(mesh),
            "floa_workers": (floa["channel"].num_workers,
                             floa["power"].num_workers,
                             len(floa["attack"].byzantine_mask)),
            "heads_refused": _raised(lambda: ST.make_train_step(mla, mesh)),
            "single": _raised(lambda: mesh_from_arg("single"))}


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
        if job["kind"] in LM_KINDS:
            torch.save(run_lm_job(job),
                       os.path.join(out, f"{job['name']}.r{rank}.pt"))
            continue
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

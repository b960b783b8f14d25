"""Dry run of the production layouts: one rank's step of every (architecture
x input shape) traced on fake tensors, its operations, bytes, collectives
and device memory recorded for the roofline.

The counterpart of `repro/launch/dryrun.py`:

  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --meshes single,multi   # every combo,
                                     # one subprocess each, resumable
  python -m repro_torch.launch.dryrun --all --constrain batch_only  # the
                                     # residual replicated over "model"

The reference lowers and compiles each step for the 256- or 512-chip mesh
and reads XLA's memory and cost analyses.  Here `run_one` starts a fake
process group of the mesh's size in this process (rank 0 of 256 or 512:
`torch.testing._internal.distributed.fake_pg`, no card, no peer), builds
the production mesh over it (`launch.mesh.make_production_mesh`) and the
step (`launch.steps.make_step`, FSDP on), makes rank 0's arguments as fake
tensors of their shapes under `FakeTensorMode` (its shards over "model"
and "data", the FLOA state, the global batch, its rows' caches; nothing
is drawn or allocated), and runs the step once under `FlopCounterMode`
and `launch.cost_analysis.CostMode`.  The fake tensors are CPU tensors on
every build of torch (a build without CUDA cannot index or differentiate
fake "cuda" tensors), and the card's path is traced on them: the decode
attention and the train step's update go through the kernels' ops
(`kernels.decode_attention.card_route`, `kernels.noisy_update.
card_route`), which trace by their fake rules, and their costs
(`bytes_flops` of each) are added, as is the workspace the card's
kernels allocate inside an op (`cost_analysis.CARD_WORKSPACE`: the
softmax backward's) to the memory live while it runs.  The update draws
each leaf's noise in registers, so no noise tensor is traced.  The model
code has no other device branch.  An eager trace visits every layer, so its counts
are whole: the reference's probes at one and two layers, which undo
XLA's counting a while-body once, have no counterpart.  The trace runs the
real step's backward, so under the config's `remat` (the full configs')
it follows each recomputed block, CE chunk and expert chunk: their
operations are counted twice, as XLA counts the reference's under remat,
and the peak is what the recompute leaves live.

Each combo writes `<out>/<arch>__<shape>__<mesh>.json`: status "ok" with
the reference's fields where they have a meaning (n_params, n_active,
flops_per_device: FlopCounterMode's plus the custom ops' costs;
bytes_per_device: every op's inputs plus outputs, eager's traffic,
unfused; collectives: bytes by kind and link; roofline; dominant;
model_flops; model_flops_per_device; useful_ratio; remat (the config's);
constrain (the route of the residual stream the train or prefill step
took: "sequence", the reference's default `make_constrain`, each
"model" rank holding S / M positions; "batch_only" where asked for with
--constrain or where M does not divide the sequence; null for decode);
memory: argument_size
(shards, state, batch and caches), output_size, temp_size (the peak less
the arguments), peak, param_bytes, and fits against an H100's memory),
trace_s in place of lower_s / compile_s, and largest_drawn_part (the
largest part of a leaf `launch.sharding.init_shards` draws on the rank,
in place: no whole leaf is formed); status
"skip" for a shape the config does not run (`shape_applicable`),
"refused" with the message of a head layout the port does not split
(`models.attention.check_heads`), and under --all "fail" / "timeout" for a
combo whose subprocess failed.  The eager numbers are a prediction for an
NVIDIA H100 80GB HBM3 at 700 W, computed, not measured.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import noisy_update as NU
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch.mesh import (PRODUCTION, data_axis,
                                     make_production_mesh, model_axis)
from repro_torch.launch.steps import (CONSTRAINS, batch_rows, batch_shapes,
                                      init_floa_state, init_model, make_step,
                                      num_workers)
from repro_torch.models import attention as ATT
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map, tree_paths

Tensor = torch.Tensor
OUT_DIR = os.path.join("results", "dryrun_torch")


@contextlib.contextmanager
def _card_routes():
    """The decode attention and the train step's update of (fake) CPU
    tensors through the kernels' ops, so that their fake rules (and costs)
    stand in for the kernels in place of the plain versions."""
    plain_decode, plain_update = ops.decode_attention, ops.noisy_sgd

    def decode(q, k, v, pos, *, plain=False):
        return (plain_decode(q, k, v, pos, plain=True) if plain
                else DA.card_route(q, k, v, pos))

    ops.decode_attention, ops.noisy_sgd = decode, NU.card_route
    try:
        yield
    finally:
        ops.decode_attention, ops.noisy_sgd = plain_decode, plain_update


def _decode_cost(q, k, v, pos):
    """(bytes, flops) of a decode-attention call at the last position of
    its cache: every slot valid, as in a dry-run decode."""
    b, h, dh = q.shape
    return DA.bytes_flops(b, h, k.shape[2], dh, k.shape[1],
                          q.element_size())


def _update_cost(p, g, shift, scale, z, alpha, key, leaf, full, offset):
    """(bytes, operations) of one `noisy_sgd` launch
    (`kernels.noisy_update.bytes_flops`)."""
    part = (NU.Part(tuple(full), tuple(offset), tuple(p.shape)) if full
            else NU.Part.whole(tuple(p.shape)))
    mode = "drawn" if full else "given" if z is not None else "none"
    return NU.bytes_flops(part, p.element_size(), mode)


COSTS = {torch.ops.repro_torch.decode_attention.default: _decode_cost,
         torch.ops.repro_torch.noisy_sgd.default: _update_cost}


def step_args(cfg, shape_name: str, shape: Dict, mesh, meta: Dict, device,
              params: Optional[Dict] = None) -> tuple:
    """The arguments of one rank's step of `shape`'s kind but its draws
    (`trace_step`): this rank's params (`params`, or zeros of its shards'
    shapes), and the FLOA state and the global batch (train), the batch
    (prefill), or its rows' caches (and an encoder-decoder's cross K / V),
    the global [B, 1] tokens and the last position (decode), all zeros, on
    `device`."""
    if params is None:
        params = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                                device=device),
                          init_model(cfg, None, "meta", mesh))
    kind = shape["kind"]
    if kind != "decode":
        batch = {k: torch.zeros(s, dtype=dt, device=device)
                 for k, (s, dt) in batch_shapes(cfg, shape, kind).items()}
        if kind == "prefill":
            return params, batch
        return params, init_floa_state(device), batch
    b, s = shape["global_batch"], shape["seq_len"]
    rows = batch_rows(mesh, b)
    nb = rows.stop - rows.start
    m = model_axis(mesh)
    tokens1 = torch.zeros((b, 1), dtype=torch.int32, device=device)
    pos = torch.tensor(s - 1, dtype=torch.int32, device=device)
    if cfg.arch_type == "audio":
        _, kv = ATT.local_heads(cfg, m.size, m.index)
        cross = tuple(torch.zeros(
            (cfg.encdec.n_dec_layers, nb, min(s, cfg.encdec.enc_seq_cap),
             kv.stop - kv.start, cfg.hd), dtype=cfg.dtype, device=device)
            for _ in range(2))
        caches = ED.init_dec_caches(cfg, nb, s, device, m.size)
        return params, caches, cross, tokens1, pos
    caches = T.init_caches(cfg, nb, s, window=meta["window"], device=device,
                           model_parallel=m.size)
    return params, caches, tokens1, pos


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors in `trees`."""
    seen = {}
    for tree in trees:
        for t in CA._tensors(tree):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def largest_drawn_part(cfg, mesh=None) -> Dict:
    """The largest piece `launch.sharding.init_shards` holds while drawing
    on this rank of `mesh` (FSDP on, as the steps'): its largest part of a
    leaf (the kernel fills each part in place), its path and bytes in the
    leaf's dtype."""
    local = init_model(cfg, None, "meta", mesh)
    n, path = max((x.numel() * x.element_size(), p)
                  for p, x in zip(tree_paths(local), tree_leaves(local)))
    return {"path": path, "bytes": n}


def trace_step(cfg, shape_name: str, shape: Dict, mesh=None,
               route: str = "cuda", fake: bool = True,
               constrain: str = "sequence") -> Dict:
    """One rank's step of cfg at `shape` on `mesh` (None: one device), run
    once on CPU tensors: its counts and memory (the record's fields but
    status and names).  route "cuda" traces the card's path (the decode
    and update kernels by their ops' fake rules, `_card_routes`, and the
    card's kernels' workspace, `cost_analysis.CARD_WORKSPACE`), "cpu" the
    CPU's (the plain versions, no workspace).  fake=False runs the same
    step for real on CPU zeros (route "cpu" only), to hold a trace
    against.  The train step takes its gains from here (a generator cannot
    draw on fake tensors) and draws its noise itself: through the update
    kernel's op on route "cuda", by the plain stream on route "cpu".
    `constrain` goes to the train and prefill steps (`steps.CONSTRAINS`);
    meta["constrain"] is the route the step took."""
    t0 = time.perf_counter()
    step, meta = make_step(cfg, mesh, shape_name, shape, constrain)
    reroute = (_card_routes() if route == "cuda"
               else contextlib.nullcontext())
    with (FakeTensorMode() if fake else contextlib.nullcontext()), reroute:
        args = step_args(cfg, shape_name, shape, mesh, meta, "cpu")
        param_bytes = storage_bytes(args[0])
        cost = CA.CostMode(COSTS, CA.CARD_WORKSPACE if route == "cuda"
                           else None)
        arg_bytes = cost.track(args)
        flops = FlopCounterMode(display=False)
        extra = {}
        with flops, cost:
            if shape["kind"] == "train":
                extra["draws"] = {"h_abs": torch.ones(meta["num_workers"],
                                                      dtype=torch.float32)}
                out = step(*args, 0, **extra)
            else:
                out = step(*args)
        output_bytes = storage_bytes(out, args) - storage_bytes(args)
        peak = cost.peak
        del out, extra
    n_flops = float(flops.get_total_flops() + cost.extra_flops)
    n_bytes = float(cost.op_bytes + cost.extra_bytes)
    return dict(
        trace_s=time.perf_counter() - t0,
        flops_per_device=n_flops, bytes_per_device=n_bytes,
        bytes_note="every op's inputs plus outputs: eager's traffic, "
                   "unfused",
        collectives=cost.collective_summary(),
        memory=dict(argument_size=arg_bytes, output_size=output_bytes,
                    temp_size=peak - arg_bytes, peak=peak,
                    param_bytes=param_bytes,
                    fits=peak <= CA.H100_TOTAL_MEMORY,
                    card_memory=CA.H100_TOTAL_MEMORY),
        meta={k: v for k, v in meta.items()
              if k in ("dim", "num_workers", "policy", "window",
                       "constrain")})


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of `world_size` ranks in this process, this
    process its rank 0 (no peer, no card: every collective returns at
    once), ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
            constrain: str = "sequence") -> Dict:
    """One combo's record (see the module docstring), written to out_dir:
    the card's route on a fake process group of the mesh's size, started
    and ended here."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    head = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                asked=constrain)
    if not shape_applicable(cfg, shape_name):
        rec = dict(head, status="skip",
                   reason=f"{arch} skips {shape_name} (its skip_shapes)")
        _write(rec, out_dir)
        return rec
    chips = math.prod(PRODUCTION[mesh_kind][0])
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        try:
            got = trace_step(cfg, shape_name, shape, mesh,
                             constrain=constrain)
            drawn = largest_drawn_part(cfg, mesh)
        except NotImplementedError as e:
            rec = dict(head, status="refused", chips=chips, reason=str(e))
            _write(rec, out_dir)
            return rec
        wa_u, r = num_workers(mesh), data_axis(mesh).size
    n_params = got["meta"]["dim"]
    n_active = CA.active_params(cfg, n_params)
    mflops = CA.model_flops(cfg, shape, n_params, n_active)
    coll = got["collectives"]
    terms = CA.roofline_terms(got["flops_per_device"],
                              got["bytes_per_device"],
                              coll["by_link"]["network"],
                              coll["by_link"]["nvlink"])
    rec = dict(
        head, status="ok", chips=chips, workers=wa_u, data_ranks=r,
        n_params=n_params, n_active=n_active,
        **{k: got[k] for k in ("trace_s", "flops_per_device",
                               "bytes_per_device", "bytes_note",
                               "collectives")},
        roofline=terms, dominant=CA.dominant(terms),
        model_flops=mflops, model_flops_per_device=mflops / chips,
        useful_ratio=((mflops / chips) / got["flops_per_device"]
                      if got["flops_per_device"] else None),
        remat=cfg.remat, constrain=got["meta"].get("constrain"),
        memory=got["memory"], largest_drawn_part=drawn,
        meta=got["meta"])
    _write(rec, out_dir)
    return rec


def _path(out_dir: str, arch: str, shape: str, mesh: str,
          constrain: str = "sequence") -> str:
    """A combo's record; the non-default constrain's beside it."""
    tail = "" if constrain == "sequence" else f"__{constrain}"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{tail}.json")


def _write(rec: Dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                    rec["asked"]), "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec.get("memory", {})
    peak = f"{mem['peak'] / 1e9:.2f}GB" if mem else "-"
    print(f"[dryrun] {rec['arch']:28s} {rec['shape']:12s} {rec['mesh']:6s} "
          f"{rec['status']:7s} dominant={rec.get('dominant', '-')} "
          f"peak={peak} trace={rec.get('trace_s', 0):.1f}s", flush=True)


def orchestrate(out_dir: str, meshes, archs, shapes, timeout: int,
                constrain: str = "sequence") -> int:
    """Every combo not yet recorded in out_dir, one subprocess each (a
    failure or a timeout is recorded as such); returns the failures."""
    fails = 0
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = _path(out_dir, arch, shape, mesh_kind, constrain)
                if os.path.exists(path):
                    continue  # resumable
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                       "--out", out_dir, "--constrain", constrain]
                try:
                    r = subprocess.run(cmd, timeout=timeout, env=env,
                                       capture_output=True, text=True)
                    if r.returncode != 0:
                        fails += 1
                        err = (r.stdout + r.stderr)[-3000:]
                        with open(path, "w") as f:
                            json.dump(dict(arch=arch, shape=shape,
                                           mesh=mesh_kind, asked=constrain,
                                           status="fail", error=err), f,
                                      indent=1)
                        print(f"[dryrun] FAIL {arch} {shape} {mesh_kind}:\n"
                              f"{err}", flush=True)
                    else:
                        print(r.stdout.strip().splitlines()[-1]
                              if r.stdout.strip() else "", flush=True)
                except subprocess.TimeoutExpired:
                    fails += 1
                    with open(path, "w") as f:
                        json.dump(dict(arch=arch, shape=shape,
                                       mesh=mesh_kind, asked=constrain,
                                       status="timeout"), f, indent=1)
                    print(f"[dryrun] TIMEOUT {arch} {shape} {mesh_kind}",
                          flush=True)
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--constrain", default="sequence", choices=CONSTRAINS,
                    help="the train and prefill steps' residual stream: "
                         "split over \"model\" on the sequence (the "
                         "reference's default) or replicated")
    args = ap.parse_args(argv)

    if args.all:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        fails = orchestrate(args.out, args.meshes.split(","), archs, shapes,
                            args.timeout, args.constrain)
        sys.exit(1 if fails else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    try:
        run_one(args.arch, args.shape, args.mesh, args.out, args.constrain)
    except Exception:   # noqa: BLE001 -- the orchestrator records it
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()

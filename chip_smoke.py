#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # phases 1-3, then a torch.profiler
                                      # breakdown of a warm Fig. 3 sweep,
                                      # defense grid and U = 1000 grid

Needs one CUDA card, nvcc, and this checkout.  Phases, one JSON line each:

  1. device   card name and power limit (also printed raw), torch/CUDA
              versions; TF32 off, as the float32 reference needs.
  2. build    nvcc builds every kernel of csrc/ (seconds, ptxas -v lines).
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes and at awkward ones (D off any tile, U = 32,
              bf16, S = 1; for the sorts U = 7, 33, 100, 4097 and the
              bitonic cap, 8192), with times: kernel, plain, one library call, and the
              bound (bytes over 3.35 TB/s vs f32 operations over
              67 TFLOP/s, the larger).  The sorts must equal torch.sort
              exactly.
  4-6. main path through `repro_torch.figures.run_figure` / SweepEngine at
              the paper's full width (D = 50890, U = 10): Fig. 1's benign
              lanes, Fig. 3's Byzantine lanes, and a GAUSSIAN-jamming sweep
              (the combine-only route).  Launch counts are zeroed before and
              read after each, and must show every kernel of the path.
  7. parity   one Fig. 1 sweep through the kernels and again through the
              plain versions, from the same draws.
  8-9. the digital-defense path (grouped dispatch) at full width:
              `figures.run_defenses` (FLOA-BEV beside mean / median /
              trimmed mean / Krum / geometric median, U = 10: the odd-even
              sort) and `figures.worker_grid(1000, D)` through
              `figures.run_cases` (U = 1000, 32000 training samples = 32
              per worker: the bitonic sort and blocked Krum), counted as
              phases 4-6 are.
  10. parity  the defense grid through the kernels and again through the
              plain versions, from the same draws.
  11. the `kernels` line; 12. the last line, {"ok": true, "device": ...}.

Any failure raises, so the script exits non-zero before the last line.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # f32 outside the tensor cores
ROUNDS = 20
ROUNDS_LARGE_U = 5           # the U = 1000 grid: keeps the script short
RTOL_WHOLE_RUN = 1e-4        # kernel route vs plain route over 20 rounds


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, iters: int = 50) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed, timed with CUDA events (the host's launch overhead is not in
    it).  Inputs stay in the 50 MB L2 between calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def call_ms(torch, fn, iters: int = 200) -> float:
    """Time of one eager call, host launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errors(torch, got, want) -> tuple:
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), float((err / w.abs().clamp_min(1e-6)).max())


def sort_ops(u: int, bitonic: bool) -> int:
    """min/max operations per column of a sorting network: odd-even has
    U(U-1)/2 compare-exchanges, bitonic log2(P)(log2(P)+1)/2 stages of P/2
    over the padded P rows; two operations each."""
    if not bitonic:
        return u * (u - 1)
    p = 1 << max(u - 1, 0).bit_length()
    k = p.bit_length() - 1
    return k * (k + 1) // 2 * p


def kernel_cases(torch, ops):
    """(kernel, label, main?, run(plain) -> outputs, library fn or None,
    bytes, flops, (rtol, atol) or "exact") for every comparison of
    phase 3."""
    gen = torch.Generator("cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for s, u, d, dt, main in [(4, 10, 50890, torch.float32, True),
                              (3, 32, 5000, torch.bfloat16, False)]:
        eg = torch.finfo(dt).bits // 8
        # tests/test_kernels.py's tolerances: the combine 1e-5 (f32) and
        # 0.15 (bf16); grad_stats (rtol 1e-4, atol 1e-3) and 2e-2 (bf16).
        f32 = dt == torch.float32
        tol = (1e-5, 1e-5) if f32 else (0.15, 0.15)
        tol_stats = (1e-4, 1e-3) if f32 else (2e-2, 2e-2)
        w, c, g, z = rnd(s, d, dtype=dt), rnd(s, u), rnd(s, u, d, dtype=dt), \
            rnd(s, d, dtype=dt)
        bias, eps = rnd(s), rnd(s)
        alpha = torch.rand(s, generator=gen, device="cuda") * 0.2
        zb = (bias[:, None] + eps[:, None] * z.float()).to(dt)[:, None]
        label = f"S={s} U={u} D={d} {str(dt)[6:]}"
        cases.append((
            "floa_step_batched", label, main,
            lambda p, a=(w, c, g, z, bias, eps, alpha):
                ops.floa_step_batched(*a, plain=p),
            None,
            s * u * d * eg + 4 * s * d * eg + s * u * 4 + 3 * s * 4,
            2 * s * u * d + 4 * s * d, tol))
        cases.append((
            "floa_aggregate_batched", label, main,
            lambda p, a=(c, g, z, bias, eps):
                ops.floa_aggregate_batched(*a, plain=p),
            lambda a=(zb, c.to(dt)[:, None], g): torch.baddbmm(*a),
            s * u * d * eg + 2 * s * d * eg + s * u * 4 + 2 * s * 4,
            2 * s * u * d + 3 * s * d, tol))
        cases.append((
            "floa_aggregate", f"U={u} D={d} {str(dt)[6:]} (S=1)", main,
            lambda p, a=(c[0], g[0], z[0], bias[0], eps[0]):
                ops.floa_aggregate(*a, plain=p),
            lambda a=(zb[0, 0], g[0].t(), c[0].to(dt)): torch.addmv(*a),
            u * d * eg + 2 * d * eg + u * 4 + 8,
            2 * u * d + 3 * d, tol))
        rows = g.reshape(s * u, d)
        cases.append((
            "grad_stats", f"R={s * u} D={d} {str(dt)[6:]}", main,
            lambda p, a=rows: ops.grad_stats(a, plain=p),
            lambda a=rows: torch.var_mean(a, dim=1, correction=0),
            s * u * d * eg + s * u * 2 * 4, 3 * s * u * d, tol_stats))
    # the sorts: the defense grid's slab (U = 10) and the U = 1000 grid's
    for name, s, u, d, dt, main in [
            ("sort_columns", 1, 10, 50890, torch.float32, True),
            ("sort_columns", 3, 32, 5000, torch.bfloat16, False),
            ("sort_columns", 2, 7, 2049, torch.float32, False),
            ("sort_columns_bitonic", 1, 1000, 50890, torch.float32, True),
            ("sort_columns_bitonic", 2, 33, 515, torch.float32, False),
            ("sort_columns_bitonic", 1, 100, 130, torch.float32, False),
            ("sort_columns_bitonic", 1, 4097, 130, torch.float32, False),
            ("sort_columns_bitonic", 1, ops.BITONIC_MAX_U, 130,
             torch.float32, False)]:
        x = rnd(s, u, d, dtype=dt)
        cases.append((
            name, f"S={s} U={u} D={d} {str(dt)[6:]}", main,
            lambda p, f=ops.KERNELS[name], a=x: f(a, plain=p),
            lambda a=x: torch.sort(a, dim=1),
            2 * s * u * d * (torch.finfo(dt).bits // 8),
            s * d * sort_ops(u, name == "sort_columns_bitonic"), "exact"))
    return cases


def run_phase(torch, ops, name, fn, expect):
    """Drive one main-path phase with the launch counts zeroed just before
    and read just after; check them against `expect`."""
    ops.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, want in expect.items():
        if counts[k] != want:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times, "
                                 f"expected {want} ({counts})")
    return result, seconds, counts


def lanes_report(result):
    acc = result.metrics["accuracy"]
    return {n: {"loss_first": float(result.loss[i, 0]),
                "loss_final": float(result.loss[i, -1]),
                "accuracy_final": float(acc[i, -1])}
            for i, n in enumerate(result.names)}


def whole_run_check(name, rk, rp) -> None:
    """A sweep through the kernels (rk) against the same sweep through the
    plain versions (rp): loss, grad norm and final weights at
    RTOL_WHOLE_RUN (atol 1e-6 on the weights)."""
    import numpy as np
    import torch
    diffs = {"loss": max_errors(torch, torch.as_tensor(rk.loss),
                                torch.as_tensor(rp.loss))[1],
             "grad_norm": max_errors(torch, torch.as_tensor(rk.grad_norm),
                                     torch.as_tensor(rp.grad_norm))[1]}
    ok = np.allclose(rk.loss, rp.loss, rtol=RTOL_WHOLE_RUN) and np.allclose(
        rk.grad_norm, rp.grad_norm, rtol=RTOL_WHOLE_RUN)
    for k in rk.params:
        diffs[f"params.{k}"] = max_errors(torch, rk.params[k],
                                          rp.params[k])[0]
        ok = ok and torch.allclose(rk.params[k], rp.params[k],
                                   rtol=RTOL_WHOLE_RUN, atol=1e-6)
    emit(name, rtol=RTOL_WHOLE_RUN, max_rel_err=diffs,
         rounds=rk.loss.shape[1], ok=bool(ok))
    if not ok:
        raise AssertionError(f"{name}: kernel route and plain route "
                             f"disagree")


def profile_phase(torch, build) -> dict:
    """Where a warm sweep spends its time: torch.profiler over one full run
    of the engine that build() returns, device kernels grouped by name, and
    the device's busy share of the run's wall time (one stream, so kernel
    times add up)."""
    from torch.profiler import ProfilerActivity, profile
    engine, params, batches = build()
    engine.run(params, batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(params, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(evt.name, (0.0, 0))
            kernels[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 n + 1)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "kernel_launches": sum(n for _, n in kernels.values()),
            "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                            for k, (ms, n) in top]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import figures
    from repro_torch.core.attacks import AttackType
    from repro_torch.core.power_control import Policy
    from repro_torch.kernels import _build, ops

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    build = _build.build_all()
    emit("build", **build)

    # 3. kernels against their plain versions
    table = {}
    for name, label, main_shape, run, lib, nbytes, flops, tol in \
            kernel_cases(torch, ops):
        got, want = run(False), run(True)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        abs_err, rel_err = 0.0, 0.0
        for g, w in zip(got, want):
            if tol == "exact" and not torch.equal(g, w):
                raise AssertionError(f"{name} [{label}] is not equal to "
                                     f"torch.sort")
            if tol != "exact" and not torch.allclose(
                    g.float(), w.float(), rtol=tol[0], atol=tol[1]):
                raise AssertionError(f"{name} [{label}] disagrees with its "
                                     f"plain version at tol {tol}")
            a, r = max_errors(torch, g, w)
            abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        b_ms, b_by = bound(nbytes, flops)
        row = {"kernel": name, "shape": label, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "rtol_atol": tol,
               "ms": time_ms(torch, lambda: run(False)),
               "call_ms": call_ms(torch, lambda: run(False)),
               "plain_ms": time_ms(torch, lambda: run(True)),
               "library_ms": None if lib is None else time_ms(torch, lib),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        emit("kernel_check", **row)
        if main_shape:
            table[name] = row

    # 5's, 8's and 9's sweeps, profiled alone: `chip_smoke.py --profile`
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                               attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    from repro_torch.configs import PAPER_MLP
    mc_u = dataclasses.replace(PAPER_MLP.full(), num_workers=1000,
                               train_samples=32000)
    grid_u = figures.worker_grid(1000, mc_u.dim)
    if sys.argv[1:] == ["--profile"]:
        for sweep, rounds, build in [
                ("fig3", ROUNDS, lambda: figures.figure_engine(
                    fig3, device="cuda")),
                ("defenses", ROUNDS, lambda: figures.cases_engine(
                    figures.defense_cases(), ROUNDS, device="cuda")),
                ("worker_grid_u1000", ROUNDS_LARGE_U,
                 lambda: figures.cases_engine(grid_u, ROUNDS_LARGE_U,
                                              mc=mc_u, device="cuda"))]:
            emit("profile", sweep=sweep, rounds=rounds,
                 **profile_phase(torch, build))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 4. main path, benign: Fig. 1's lanes at full width
    fig1 = [figures.Experiment(n, p, alpha_hat=0.1, rounds=ROUNDS)
            for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                         ("BEV", Policy.BEV)]]
    main_launches = {k: 0 for k in ops.KERNELS}

    def drive(name, exps, expect, run=None, engine=None, rounds=ROUNDS):
        """One main-path phase through its entry point (counted; default
        run_figure), then the steady-state round rate of the same sweep
        (uncounted: one warm-up run, one timed run of the built engine).
        `expect` lists every kernel's launches (unlisted: 0)."""
        result, seconds, counts = run_phase(
            torch, ops, name,
            run or (lambda: figures.run_figure(exps, device="cuda")),
            {**{k: 0 for k in ops.KERNELS}, **expect})
        for k, v in counts.items():
            main_launches[k] += v
        if not np.isfinite(result.loss).all():
            raise AssertionError(f"{name}: non-finite loss")
        engine, params, batches = (engine or (lambda: figures.figure_engine(
            exps, device="cuda")))()
        engine.run(params, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(params, batches)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        emit(name, lanes=lanes_report(result), lanes_n=len(result.names),
             rounds=rounds, run_seconds=seconds,
             steady_run_seconds=steady, rounds_per_s=rounds / steady,
             launches=counts)
        return result

    fused = {"floa_step_batched": ROUNDS, "grad_stats": ROUNDS}
    r1 = drive("main_benign", fig1, fused)
    if not (r1.loss[:, -1] < r1.loss[:, 0]).all():
        raise AssertionError(
            f"benign loss did not fall: {r1.loss[:, [0, -1]]}")

    # 5. main path, Byzantine: Fig. 3's lanes (one strong attacker, sigma 3)
    drive("main_byzantine", fig3, fused)

    # 6. combine route: a GAUSSIAN-jamming lane beside a STRONGEST lane
    jam = [figures.Experiment("BEV-gauss", Policy.BEV, n_attackers=1,
                              attack=AttackType.GAUSSIAN, rounds=ROUNDS),
           figures.Experiment("BEV-strong", Policy.BEV, n_attackers=1,
                              rounds=ROUNDS)]
    drive("main_combine_route", jam, {"floa_aggregate_batched": ROUNDS,
                                      "grad_stats": ROUNDS})

    # 7. whole run: kernel route vs plain route from the same draws
    ops.reset_launches()
    rk = figures.run_figure(fig1, device="cuda")
    rp = figures.run_figure(fig1, device="cuda", force_plain=True)
    if ops.launch_counts() != {**{k: 0 for k in ops.KERNELS}, **fused}:
        raise AssertionError(f"expected one kernel-route run's launches and "
                             f"none from the plain route: "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_run", rk, rp)

    # 8. the digital-defense grid: one analog lane (the fused route) and
    # five digital lanes; median and trimmed mean sort once per round each
    defenses_expect = {**fused, "sort_columns": 2 * ROUNDS}
    rd = drive("main_defenses", None, defenses_expect,
               run=lambda: figures.run_defenses(ROUNDS, device="cuda"),
               engine=lambda: figures.cases_engine(
                   figures.defense_cases(), ROUNDS, device="cuda"))

    # 9. the large-U grid at U = 1000: the bitonic sort, blocked Krum
    drive("main_defenses_large_u", None,
          {"floa_step_batched": ROUNDS_LARGE_U,
           "grad_stats": ROUNDS_LARGE_U,
           "sort_columns_bitonic": 2 * ROUNDS_LARGE_U},
          run=lambda: figures.run_cases(grid_u, ROUNDS_LARGE_U, mc=mc_u,
                                        device="cuda"),
          engine=lambda: figures.cases_engine(grid_u, ROUNDS_LARGE_U,
                                              mc=mc_u, device="cuda"),
          rounds=ROUNDS_LARGE_U)

    # 10. the defense grid: kernel route vs plain route from the same draws
    ops.reset_launches()
    rdp = figures.run_defenses(ROUNDS, device="cuda", force_plain=True)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the plain route launched kernels: "
                             f"{ops.launch_counts()}")
    whole_run_check("kernel_vs_plain_defenses", rd, rdp)

    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    # 11. the kernel list
    sources = {"floa_step_batched": ("floa_aggregate.cu",
                                     "src/repro/kernels/floa_aggregate.py:126"),
               "floa_aggregate_batched": ("floa_aggregate.cu",
                                          "src/repro/kernels/floa_aggregate.py:82"),
               "floa_aggregate": ("floa_aggregate.cu",
                                  "src/repro/kernels/floa_aggregate.py:184"),
               "grad_stats": ("grad_stats.cu",
                              "src/repro/kernels/grad_stats.py:37"),
               "sort_columns": ("defense_sort.cu",
                                "src/repro/kernels/defense_sort.py:105"),
               "sort_columns_bitonic": ("defense_sort.cu",
                                        "src/repro/kernels/defense_sort.py:192")}
    kernels = []
    for name, (src, replaces) in sources.items():
        row = table[name]
        on_path = name != "floa_aggregate"
        if on_path and main_launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": main_launches[name],
            "on_main_path": on_path, "shape": row["shape"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

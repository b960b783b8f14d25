#!/usr/bin/env python3
"""Every graphed route of the port, captured on one card at a small size and
held bitwise against its eager route (`graphs.disable_graphs()`).

    PYTHONPATH=src python tools/graph_capture_check.py [--out FILE]

The quick check before a full `chip_smoke.py`, whose phases run every
entry point graphed at full width: a route whose capture fails (a host
copy or sync inside the step, an unregistered generator) fails here in
seconds.  Routes, each graphed and eager from the same inputs:

- `serve` of every decoder-only arch's smoke config (batch 2, 8 + 8,
  sampled with a temperature): tokens and logits;
- `launch.train.compile_step` on every arch's smoke config (3 FLOA
  steps, batch 4 x 16, the seed a device counter): params, the FLOA
  state and the losses;
- the sweep's round on the paper MLP's smoke width: Fig. 3's lanes, the
  defense grid, the showdown (Markov fading, K-of-U, colluding and
  omniscient lanes; its first Markov round eager), the U = 70 worker grid
  (the bitonic sort), and fig3 chunked with async staging, under
  strict_numerics and through the switch dispatch on the defense grid,
  and the showdown and strict fig3 through the plain versions
  (`force_plain`): losses, grad norms, final params and the lanes'
  generator states; qwen3-4b's serve through the plain attention.

One JSON line a route (captures, replays, whether every value is the same
bits, the error if one was raised), also appended to --out; the exit code
is 1 when any route failed.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import figures, graphs  # noqa: E402
from repro_torch.configs import PAPER_MLP, get_smoke  # noqa: E402
from repro_torch.fl.plan import ExecutionPlan  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("qwen3-4b", "granite-8b", "starcoder2-3b", "moonshot-v1-16b-a3b",
         "llama4-maverick-400b-a17b", "deepseek-v2-236b", "mamba2-1.3b",
         "recurrentgemma-9b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2")
ROUNDS = 6
MC = dataclasses.replace(PAPER_MLP.smoke(), d_hidden=16)


def routes(fn):
    """(graphed, eager, totals of the graphed run) of fn()."""
    graphs.reset_totals()
    got = fn()
    torch.cuda.synchronize()
    tot = graphs.totals()
    with graphs.disable_graphs():
        want = fn()
    torch.cuda.synchronize()
    return got, want, tot


def same(a, b) -> bool:
    la, lb = [], []
    graphs._flatten(a, la)
    graphs._flatten(b, lb)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def serve_case(arch, plain=False):
    cfg = get_smoke(arch)
    got, want, tot = routes(lambda: serve(cfg, 2, 8, 8, device="cuda",
                                          temperature=0.7, plain=plain))
    return tot, same((got.tokens, got.logits), (want.tokens, want.logits))


def train_case(arch):
    cfg = get_smoke(arch)
    # the shape is the meta's (a VLM's seq_len counts its prefix)
    step, _ = ST.make_train_step(cfg, None, dict(global_batch=4, seq_len=64),
                                 alpha=0.05)

    def run():
        params = ST.init_model(cfg, torch.Generator("cuda").manual_seed(0),
                               "cuda")
        state = ST.init_floa_state("cuda")
        run_step = (TR.compile_step(step) if graphs.graphs_enabled()
                    else step)
        seed = torch.zeros((), dtype=torch.int64, device="cuda")
        losses = []
        for t in range(3):
            batch = TR.make_batch(cfg, 4, 16, t, "cuda")
            params, state, m = run_step(params, state, batch, seed)
            seed += 1
            losses.append(m["loss"].clone())
        return tree_leaves(params) + tree_leaves(state) + losses

    got, want, tot = routes(run)
    return tot, same(got, want)


def sweep_case(build):
    def run():
        engine, params, batches = build()
        made = []
        seeded = engine.seeded_draws
        engine.seeded_draws = lambda d: made.append(seeded(d)) or made[0]
        res = engine.run(params, batches)
        return ([torch.from_numpy(res.loss), torch.from_numpy(res.grad_norm)]
                + [res.params[k] for k in sorted(res.params)]
                + list(made[0].state().values()))

    got, want, tot = routes(run)
    return tot, same(got, want)


def sweeps():
    fig3 = [figures.Experiment(f"{n}@ah{ah}", p, n_attackers=1,
                               alpha_hat=ah, attacker_sigma=3.0,
                               rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", figures.Policy.CI),
                                              ("BEV", figures.Policy.BEV)]]
    mc70 = dataclasses.replace(MC, num_workers=70, train_samples=70 * 32)
    return {
        "fig3": lambda: figures.figure_engine(fig3, mc=MC, device="cuda"),
        "defenses": lambda: figures.cases_engine(
            figures.defense_cases(MC), ROUNDS, mc=MC, device="cuda"),
        "showdown": lambda: figures.showdown_engine(ROUNDS, mc=MC,
                                                    device="cuda"),
        "worker_grid_u70": lambda: figures.cases_engine(
            figures.worker_grid(70, mc70.dim), ROUNDS, mc=mc70,
            device="cuda"),
        "fig3_chunked_async": lambda: figures.figure_engine(
            fig3, mc=MC, device="cuda", plan=ExecutionPlan(
                chunk_rounds=4, async_staging=True)),
        "fig3_strict": lambda: figures.figure_engine(
            fig3, mc=MC, device="cuda",
            plan=ExecutionPlan(strict_numerics=True)),
        "defenses_switch": lambda: figures.cases_engine(
            figures.defense_cases(MC), ROUNDS, mc=MC, device="cuda",
            plan=ExecutionPlan(grouped_dispatch=False)),
        "showdown_plain": lambda: figures.showdown_engine(
            ROUNDS, mc=MC, device="cuda", force_plain=True),
        "fig3_strict_plain": lambda: figures.figure_engine(
            fig3, mc=MC, device="cuda", force_plain=True,
            plan=ExecutionPlan(strict_numerics=True))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_capture_check: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(f"serve/{a}", lambda a=a: serve_case(a)) for a in ARCHS
             if get_smoke(a).arch_type != "audio"]
    cases.append(("serve_plain/qwen3-4b",
                  lambda: serve_case("qwen3-4b", plain=True)))
    cases += [(f"train/{a}", lambda a=a: train_case(a)) for a in ARCHS]
    cases += [(f"sweep/{n}", lambda b=b: sweep_case(b))
              for n, b in sweeps().items()]
    failed = 0
    for name, fn in cases:
        t0 = time.perf_counter()
        line = {"route": name}
        try:
            tot, equal = fn()
            line.update(bitwise=equal, **tot)
            failed += not equal or tot["captures"] < 1
        except Exception as e:   # every route is reported, then the exit
            line.update(error=f"{type(e).__name__}: {e}"[:2000],
                        where=traceback.format_exc()[-3000:])
            failed += 1
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        with contextlib.suppress(Exception):
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(json.dumps({"routes": len(cases), "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

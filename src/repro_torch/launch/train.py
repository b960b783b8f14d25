"""Training driver of the port (`repro/launch/train.py`): FLOA-federated LM
training on one device, or on U ranks, one FL worker each.

  python -m repro_torch.launch.train --arch qwen3-4b [--smoke] \
      [--device cuda|cpu] --steps 5 --batch 8 --seq 64 --policy bev \
      [--alpha 0.02] [--byzantine N] [--ckpt DIR [--ckpt-every K]] \
      [--mesh UxM [--backend gloo|nccl]]

Runs real steps of `launch.steps.make_train_step` on random weights drawn
from seed 0, with the synthetic Markov token stream (`data.text`) as the
batches (step t draws from seed t) and a device step counter as the
step's seed, as the reference passes `jnp.uint32(t)`.  On one device the
loop replays the step captured as a CUDA graph (`compile_step`, the
reference's `jax.jit`; `graphs.disable_graphs()` runs it eagerly), and
reads the loss each step as the reference's loop does; on a mesh the
steps run eagerly (their gloo collectives cannot be captured).  As in the
reference driver, a VLM's
batch adds a zero image prefix of its n_prefix positions and an
encoder-decoder's standard-normal frames of min(seq, enc_seq_cap)
positions (drawn from seed t on the device).  One device is U = 1 worker, so
--byzantine has no attacker to place (as on the JAX package's 1x1 mesh).
`--mesh UxM` trains on U x M ranks started by torchrun (WORLD_SIZE, RANK,
MASTER_ADDR / MASTER_PORT; `launch.distributed.initialize_distributed`, as
the reference's driver starts its processes): the ("data", "model") mesh
of U x M, each row of M ranks one FL worker on its B / U rows, every layer
split over its M ranks (tensor parallel; each rank holds its shard of the
weights, `launch.sharding`), the gradients summed over the U workers (the
over-the-air sum), the first min(N, U // 2 - 1) workers the attackers.
Several ranks on one card name `--backend gloo` and `--device cuda:0`
(NCCL refuses two ranks on one device); nothing picks another backend or
device on its own.  `--mesh single|multi` are the reference's
production layouts over 256 or 512 ranks
(`launch.mesh.make_production_mesh`: 16 or 32 FL workers of 16
tensor-parallel ranks); on another number of ranks they raise ValueError
naming the count.  On a mesh of several "data" ranks the large weights'
storage is split over them too (FSDP, `launch.sharding.data_specs`, as
the reference's train step does), each layer gathering its own.  Rank 0
prints and writes the checkpoint: --ckpt gathers the shards and writes the
whole params in the checkpoint format both packages read
(`checkpoint.save`).  The default
device is the card; --device cpu runs the same steps on the CPU (use
--smoke there).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import checkpoint as CK
from repro_torch import graphs
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.power_control import Policy
from repro_torch.data import sample_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.distributed import initialize_distributed, world
from repro_torch.launch.mesh import mesh_from_arg
from repro_torch.launch.sharding import gather_params
from repro_torch.launch.steps import (init_floa_state, init_model,
                                      make_train_step)
from repro_torch.tree import tree_leaves


def compile_step(step_fn) -> graphs.StepGraph:
    """The one-device train step as the reference's `jax.jit` compiles it:
    `step(params, state, batch, seed) -> (params, state, metrics)`
    captured as a CUDA graph (`graphs.StepGraph`) and replayed.  params
    and state are held by reference, the graph's static parameter
    buffers: each call writes the new params and state into them in place
    and returns them, so the caller passes back what it was given (as the
    loop below does); batch and seed (a one-element integer tensor on the
    device, read there: a replay draws the gains and the noise of the
    seed it holds) are copied in at each call.  metrics are the graph's
    static outputs, overwritten by the next call.  The first call runs
    eagerly (the warm-up), the second captures; inside
    `graphs.disable_graphs()` every call runs the same body eagerly."""
    def body(params, state, batch, seed):
        new_params, new_state, metrics = step_fn(params, state, batch, seed)
        for tree, new in ((params, new_params), (state, new_state)):
            for dst, src in zip(tree_leaves(tree), tree_leaves(new)):
                dst.copy_(src)
        return params, state, metrics

    return graphs.StepGraph(body, static=(0, 1))


def make_batch(cfg, batch: int, seq: int, step: int, device) -> dict:
    """Step `step`'s global batch: tokens [batch, seq + 1] from the Markov
    stream of seed `step`, and a VLM's zero `embeds_prefix` or an
    encoder-decoder's normal `frames` (bf16, `steps.batch_shapes`'
    dtype)."""
    out = {"tokens": torch.as_tensor(sample_tokens(
        batch, seq + 1, vocab=cfg.vocab_size, seed=step), device=device)}
    if cfg.arch_type == "vlm":
        out["embeds_prefix"] = torch.zeros(
            (batch, cfg.frontend.n_prefix, cfg.frontend.feature_dim),
            dtype=torch.bfloat16, device=device)
    if cfg.arch_type == "audio":
        gen = torch.Generator(device).manual_seed(step)
        out["frames"] = torch.randn(
            (batch, min(seq, cfg.encdec.enc_seq_cap),
             cfg.frontend.feature_dim), generator=gen,
            device=device).to(torch.bfloat16)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mesh", default="1x1",
                    help="UxM: U FL workers of M tensor-parallel ranks "
                         "each (torchrun); single | multi: the production "
                         "16 x 16 / 2 x 16 x 16 meshes")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (gloo for several "
                         "ranks on one card); default NCCL on a card")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.02)
    ap.add_argument("--policy", default="bev", choices=["bev", "ci", "ef"])
    ap.add_argument("--byzantine", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    started = initialize_distributed(
        backend=args.backend,
        device=None if args.device == "cuda" else args.device)
    lead = world()[0] == 0
    mesh = mesh_from_arg(args.mesh)
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)

    shape = dict(seq_len=args.seq, global_batch=args.batch, kind="train")
    step_fn, meta = make_train_step(cfg, mesh, shape, alpha=args.alpha,
                                    policy=Policy(args.policy),
                                    n_byzantine=args.byzantine)
    specs, dspecs = meta["params_specs"], meta["data_specs"]
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev,
                        mesh=mesh)
    state = init_floa_state(dev)
    seed = torch.zeros((), dtype=torch.int64, device=dev)
    step = compile_step(step_fn) if mesh is None else step_fn
    if lead:
        print(f"arch={cfg.name} params={meta['dim']:,} workers="
              f"{meta['num_workers']} policy={args.policy} "
              f"byzantine={args.byzantine} device={dev}")

    for t in range(args.steps):
        batch = make_batch(cfg, args.batch, args.seq, t, dev)
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch, seed)
        seed += 1
        loss = float(metrics["loss"])
        if lead:
            print(f"step {t:4d} loss {loss:8.4f} "
                  f"({time.perf_counter() - t0:5.2f}s)", flush=True)
        if not math.isfinite(loss):
            raise RuntimeError("training diverged")
        if (args.ckpt and args.ckpt_every
                and (t + 1) % args.ckpt_every == 0):
            full = gather_params(params, specs, mesh, dspecs)  # every rank
            if lead:
                CK.save(args.ckpt, t + 1, full)
            del full
    if args.ckpt:
        full = gather_params(params, specs, mesh, dspecs)
        if lead:
            CK.save(args.ckpt, args.steps, full)
            print(f"checkpoint -> {args.ckpt}")
    if started:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

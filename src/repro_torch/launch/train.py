"""Training driver of the port (`repro/launch/train.py`): FLOA-federated LM
training on one device, or on U ranks, one FL worker each.

  python -m repro_torch.launch.train --arch qwen3-4b [--smoke] \
      [--device cuda|cpu] --steps 5 --batch 8 --seq 64 --policy bev \
      [--alpha 0.02] [--byzantine N] [--ckpt DIR [--ckpt-every K]] \
      [--mesh UxM [--backend gloo|nccl]]

Runs real steps of `launch.steps.make_train_step` on random weights drawn
from seed 0, with the synthetic Markov token stream (`data.text`) as the
batches (step t draws from seed t); as in the reference driver, a VLM's
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
device on its own.  `--mesh single|multi`, the reference's TPU pod
layouts, raise (`--mesh UxM` is their counterpart over GPU ranks).  Rank 0
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
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.power_control import Policy
from repro_torch.data import sample_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.distributed import initialize_distributed, world
from repro_torch.launch.mesh import mesh_from_arg
from repro_torch.launch.sharding import gather_params
from repro_torch.launch.steps import (init_floa_state, init_model,
                                      make_train_step)


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
                         "each (torchrun)")
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
    specs = meta["params_specs"]
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev,
                        mesh=mesh)
    state = init_floa_state(dev)
    if lead:
        print(f"arch={cfg.name} params={meta['dim']:,} workers="
              f"{meta['num_workers']} policy={args.policy} "
              f"byzantine={args.byzantine} device={dev}")

    for t in range(args.steps):
        batch = make_batch(cfg, args.batch, args.seq, t, dev)
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch, t)
        loss = float(metrics["loss"])
        if lead:
            print(f"step {t:4d} loss {loss:8.4f} "
                  f"({time.perf_counter() - t0:5.2f}s)", flush=True)
        if not math.isfinite(loss):
            raise RuntimeError("training diverged")
        if (args.ckpt and args.ckpt_every
                and (t + 1) % args.ckpt_every == 0):
            full = gather_params(params, specs, mesh)   # every rank calls
            if lead:
                CK.save(args.ckpt, t + 1, full)
            del full
    if args.ckpt:
        full = gather_params(params, specs, mesh)
        if lead:
            CK.save(args.ckpt, args.steps, full)
            print(f"checkpoint -> {args.ckpt}")
    if started:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

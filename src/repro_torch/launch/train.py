"""Training driver of the port (`repro/launch/train.py`): FLOA-federated LM
training on one device.

  python -m repro_torch.launch.train --arch qwen3-4b [--smoke] \
      [--device cuda|cpu] --steps 5 --batch 8 --seq 64 --policy bev \
      [--alpha 0.02] [--byzantine N] [--ckpt DIR [--ckpt-every K]]

Runs real steps of `launch.steps.make_train_step` on random weights drawn
from seed 0, with the synthetic Markov token stream (`data.text`) as the
batches (step t draws from seed t).  One card is U = 1 worker, so
--byzantine has no attacker to place (as on the JAX package's 1x1 mesh);
--mesh other than 1x1 raises (meshes are ROADMAP.md Queue 1 item 8).
--ckpt writes the params in the checkpoint format both packages read
(`checkpoint.save`).  The default device is the card; --device cpu runs
the same steps on the CPU (use --smoke there).
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
from repro_torch.launch.steps import (init_floa_state, init_model,
                                      make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mesh", default="1x1")
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
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes are "
            f"not ported (ROADMAP.md Queue 1 item 8)")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)

    shape = dict(seq_len=args.seq, global_batch=args.batch, kind="train")
    step_fn, meta = make_train_step(cfg, None, shape, alpha=args.alpha,
                                    policy=Policy(args.policy),
                                    n_byzantine=args.byzantine)
    params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    state = init_floa_state(dev)
    print(f"arch={cfg.name} params={meta['dim']:,} workers="
          f"{meta['num_workers']} policy={args.policy} "
          f"byzantine={args.byzantine} device={dev}")

    for t in range(args.steps):
        batch = {"tokens": torch.as_tensor(
            sample_tokens(args.batch, args.seq + 1, vocab=cfg.vocab_size,
                          seed=t), device=dev)}
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch, t)
        loss = float(metrics["loss"])
        print(f"step {t:4d} loss {loss:8.4f} "
              f"({time.perf_counter() - t0:5.2f}s)", flush=True)
        if not math.isfinite(loss):
            raise RuntimeError("training diverged")
        if args.ckpt and args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            CK.save(args.ckpt, t + 1, params)
    if args.ckpt:
        CK.save(args.ckpt, args.steps, params)
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()

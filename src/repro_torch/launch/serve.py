"""Serving entry point of the port (`repro/launch/serve.py`): prefill-by-decode
of a prompt batch, then generation, with a KV cache on one device.

  python -m repro_torch.launch.serve --arch qwen3-4b [--smoke] --batch 8 \
      --prompt-len 32 --gen 16 [--temperature T] [--device cuda|cpu] \
      [--seed N]

As in the JAX serve script the weights are random (drawn from `--seed`) and the
prompts are synthetic Markov token streams (`data/text.py`).  Greedy
decoding by default; with a temperature every generated token after the
first (which, as in the JAX loop, is the argmax of the prompt's last
logits) is drawn with `torch.multinomial` from a seeded generator, whose
bits differ from `jax.random.categorical`'s.  Every attention of every step goes through
the decode-attention kernel on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import sample_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_model, make_decode_step
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class ServeResult:
    prompts: Tensor     # [B, prompt_len] int64
    tokens: Tensor      # [B, gen] int64, the generated tokens
    logits: Tensor      # [prompt_len + gen, B, Vp], one row per step
    prefill_s: float
    decode_s: float

    @property
    def tok_per_s(self) -> float:
        """Generated tokens per second of the decode phase."""
        return self.tokens.numel() / self.decode_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int, *,
          device="cuda", temperature: float = 0.0, seed: int = 0,
          params: Optional[Dict] = None, plain: bool = False) -> ServeResult:
    """Prefill `batch` prompts of `prompt_len` tokens by decoding them one
    position at a time, then generate `gen` tokens.  `params` (e.g. from
    `transformer.params_from_jax`) replaces the random weights; `plain=True`
    routes the attention through the kernel's plain version.  The caches,
    the step positions and the tokens stay on the device, so the loop syncs
    with the host only at the phase boundaries."""
    dev = resolve_device(device)
    if params is None:
        params = init_model(cfg, torch.Generator(dev).manual_seed(seed), dev)
    max_len = prompt_len + gen
    step, _ = make_decode_step(cfg, "decode_32k", plain=plain)
    prompts = torch.as_tensor(
        sample_tokens(batch, prompt_len, vocab=cfg.vocab_size, seed=seed),
        dtype=torch.long, device=dev)
    caches = T.init_caches(cfg, batch, max_len, window=cfg.window, device=dev)
    positions = torch.arange(max_len, dtype=torch.int32, device=dev)
    sampler = torch.Generator(dev).manual_seed(seed + 7)
    v = cfg.vocab_size
    logits_all = []

    def next_token(logits: Tensor, sample: bool = True) -> Tensor:
        lg = logits[:, 0, :v].float()
        if sample and temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return lg.argmax(dim=-1, keepdim=True)

    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt_len):
        logits, caches = step(params, caches, prompts[:, i:i + 1],
                              positions[i])
        logits_all.append(logits[:, 0])
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = []
    tok = next_token(logits, sample=False)
    t0 = time.perf_counter()
    for i in range(prompt_len, max_len):
        out.append(tok)
        logits, caches = step(params, caches, tok, positions[i])
        logits_all.append(logits[:, 0])
        tok = next_token(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(prompts=prompts, tokens=torch.cat(out, dim=1),
                       logits=torch.stack(logits_all), prefill_s=prefill_s,
                       decode_s=decode_s)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port serves on one device; meshes are "
            f"not ported (ROADMAP.md Queue 1 item 8)")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                device=args.device, temperature=args.temperature,
                seed=args.seed)
    print(f"arch={cfg.name} batch={args.batch} prefill={res.prefill_s:.2f}s "
          f"decode={res.decode_s:.2f}s ({res.tok_per_s:.1f} tok/s)")
    print("sample tokens:", res.tokens[0, :12].tolist())


if __name__ == "__main__":
    main()

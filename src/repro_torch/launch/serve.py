"""Serving entry point of the port (`repro/launch/serve.py`): prefill-by-decode
of a prompt batch, then generation, with a KV cache on one device or with
the batch split over the ranks of a mesh.

  python -m repro_torch.launch.serve --arch qwen3-4b [--smoke] --batch 8 \
      --prompt-len 32 --gen 16 [--temperature T] [--device cuda|cpu] \
      [--seed N] [--shape decode_32k|long_500k] [--mesh RxM [--backend B]]

`--mesh RxM` serves on R x M ranks started by torchrun (WORLD_SIZE, RANK,
MASTER_ADDR / MASTER_PORT; `launch.distributed.initialize_distributed`):
the ("data", "model") mesh of R x M.  Each of the R row groups decodes its
B / R rows against its own caches (all B rows when R does not divide B),
every layer split over its M ranks (tensor parallel: each rank holds its
shard of the weights, `launch.sharding`, and the KV heads of its query
heads); every rank takes the next tokens from the gathered logits, so all
ranks emit the same stream; rank 0 prints.  Several ranks on one card name
`--backend gloo` and `--device cuda:0` (NCCL refuses two ranks on one
device); nothing picks another backend or device on its own.  `--mesh
single|multi`, the reference's TPU pod layouts, raise (`--mesh RxM` is
their counterpart over GPU ranks).

Every decoder-only arch serves (qwen3-4b, granite-8b, starcoder2-3b,
moonshot-v1-16b-a3b, llama4-maverick-400b-a17b, deepseek-v2-236b with MLA,
mamba2-1.3b with the SSD block, recurrentgemma-9b with the RG-LRU and
2048-slot local-attention rings, llava-next-mistral-7b's text tokens with
no image prefix, as the reference serves it, on 4096-slot rings).  The
encoder-decoder seamless-m4t-large-v2 is refused, as the reference's
serve refuses it: its decode step takes the encoder's cross K / V
(`steps.make_cross_kv_step`, then `steps.make_decode_step`).  The
attention window is the reference serve's: the model's native one
(starcoder2-3b's 4096, a ring-buffer cache), else full attention;
`--shape long_500k` takes that shape's window instead
(`steps.decode_window`: the 8192-slot SWA variant of the full-attention
archs), so the caches are rings of min(prompt + gen, window) slots.

As in the JAX serve script the weights are random (drawn from `--seed`) and the
prompts are synthetic Markov token streams (`data/text.py`).  Greedy
decoding by default; with a temperature every generated token after the
first (which, as in the JAX loop, is the argmax of the prompt's last
logits) is drawn with `torch.multinomial` from a seeded generator, whose
bits differ from `jax.random.categorical`'s.  Every GQA attention of
every step goes through the decode-attention kernel on the card
(recurrentgemma-9b's local attention at head dim 256 included; MLA, the
SSD block and the RG-LRU are plain torch, as in the reference).
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
from repro_torch.launch.distributed import initialize_distributed, world
from repro_torch.launch.mesh import mesh_from_arg, model_axis
from repro_torch.launch.steps import batch_rows, init_model, make_decode_step
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
          params: Optional[Dict] = None, plain: bool = False,
          shape: str = "decode_32k", mesh=None) -> ServeResult:
    """Prefill `batch` prompts of `prompt_len` tokens by decoding them one
    position at a time, then generate `gen` tokens.  `params` (e.g. from
    `transformer.params_from_jax`) replaces the random weights; `plain=True`
    routes the attention through the kernel's plain version; `shape` names
    the decode shape whose attention window the step and the caches take
    (`steps.decode_window`: decode_32k keeps cfg.window, as the reference's
    serve does).  On a mesh (`launch.mesh.SweepMesh` over the ranks) every
    rank draws the same prompts, keeps the caches of its
    `steps.batch_rows` and returns the same result: the logits and tokens
    of all rows.  Over a "model" axis of M > 1 `params` are this rank's
    shards (`launch.sharding.shard_params`; the random weights are those
    of one rank from `seed`, each leaf sliced as it is drawn:
    `steps.init_model`) and the caches hold its KV heads.  The caches,
    the step positions and the tokens stay on the device, so the loop
    syncs with the host only at the phase boundaries."""
    if cfg.arch_type == "audio":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: serve runs the decoder-only "
            f"archs; decode it with launch.steps.make_decode_step, which "
            f"takes the cross K / V of launch.steps.make_cross_kv_step")
    dev = resolve_device(device)
    max_len = prompt_len + gen
    step, meta = make_decode_step(cfg, shape, plain=plain, mesh=mesh)
    m = model_axis(mesh).size
    if params is None:
        params = init_model(cfg, torch.Generator(dev).manual_seed(seed),
                            dev, mesh=mesh)
    prompts = torch.as_tensor(
        sample_tokens(batch, prompt_len, vocab=cfg.vocab_size, seed=seed),
        dtype=torch.long, device=dev)
    rows = batch_rows(mesh, batch)
    caches = T.init_caches(cfg, rows.stop - rows.start, max_len,
                           window=meta["window"], device=dev,
                           model_parallel=m)
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
    ap.add_argument("--mesh", default="1x1",
                    help="RxM: the batch split over R row groups of M "
                         "tensor-parallel ranks (torchrun)")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend (gloo for several "
                         "ranks on one card); default NCCL on a card")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", default="decode_32k",
                    choices=["decode_32k", "long_500k"])
    args = ap.parse_args()
    started = initialize_distributed(
        backend=args.backend,
        device=None if args.device == "cuda" else args.device)
    mesh = mesh_from_arg(args.mesh)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                device=args.device, temperature=args.temperature,
                seed=args.seed, shape=args.shape, mesh=mesh)
    if world()[0] == 0:
        print(f"arch={cfg.name} batch={args.batch} ranks={world()[1]} "
              f"prefill={res.prefill_s:.2f}s decode={res.decode_s:.2f}s "
              f"({res.tok_per_s:.1f} tok/s)")
        print("sample tokens:", res.tokens[0, :12].tolist())
    if started:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

"""One attention chunk's memory: the dry run's trace against the card.

    PYTHONPATH=src python tools/attention_memory.py [B Q H KV S]

On a CUDA card, `models.attention._gqa_core` over one query chunk (bf16,
default B = 4 rows, Q = 1024 queries, H = 32 heads, KV = 8, S = 4096 keys,
a causal chunk at the sequence's end: qwen3-4b's train_4k chunk at 4 rows)
runs forward and backward twice:

- traced on fake CPU tensors under `launch.cost_analysis.CostMode` with
  the card's workspace (`CARD_WORKSPACE`), as `launch.dryrun.trace_step`
  traces a step: the peak above the inputs;
- on the card, under the allocator's history
  (`torch.cuda.memory._record_memory_history`): the peak above the inputs
  (`max_memory_allocated`), and every allocation and free of 100 MB or
  more with the Python line and the C++ operators that made it.

A kernel's buffer that no traced op shows appears on the card's list under
an operator of the backward (a `*Backward0::apply`) and nowhere in the
trace.  Prints the card's name and power limit first.  Imports no JAX.
"""
import os
import subprocess
import sys

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import cost_analysis as CA  # noqa: E402
from repro_torch.models.attention import _gqa_core  # noqa: E402
from repro_torch.models.common import make_causal_mask  # noqa: E402

HD = 128


def inputs(device, b, q, h, kv, s):
    """q [b, q, h, HD], k / v [b, s, kv, HD] (bf16, requiring grad) and
    the causal mask of the sequence's last chunk of q queries."""
    gen = torch.Generator(device).manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).requires_grad_(True)
    return (draw(b, q, h, HD), draw(b, s, kv, HD), draw(b, s, kv, HD),
            make_causal_mask(q, s, s - q, None, device)[None, None, None])


def fwd_bwd(q, k, v, mask):
    out = _gqa_core(q, k, v, mask)
    return torch.autograd.grad(out.float().sum(), (q, k, v))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("attention_memory: needs a CUDA card", file=sys.stderr)
        return 2
    shape = [int(a) for a in argv] or [4, 1024, 32, 8, 4096]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with FakeTensorMode():
        args = inputs("cpu", *shape)
        cost = CA.CostMode(workspace=CA.CARD_WORKSPACE)
        base = cost.track(args)
        with cost:
            fwd_bwd(*args)
    args = inputs("cuda", *shape)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=100000,
                                             stacks="all")
    fwd_bwd(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    print(f"shape [B, Q, H, KV, S] = {shape}: peak above the inputs, "
          f"traced {cost.peak - base} B, card {peak} B", flush=True)
    for e in snap["device_traces"][0]:
        if e["action"] not in ("alloc", "free_requested") \
                or e["size"] < 100e6:
            continue
        frames = e.get("frames", [])
        py = [f"{f['filename'].split('/')[-1]}:{f['line']}" for f in frames
              if f["filename"].endswith(".py")][:1]
        ops = [f["name"].split("(")[0] for f in frames
               if "at::_ops" in f["name"] or "Backward0::apply" in f["name"]
               or "at::native" in f["name"]][:2]
        print(f"{e['action']:15s} {e['size'] / 1e9:.3f} GB "
              f"{hex(e['addr'])} {py} {ops}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

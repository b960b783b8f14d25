"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin hybrid: RG-LRU + local
attention (`repro/configs/recurrentgemma_9b.py`).

38 layers in a 2:1 (recurrent, recurrent, local-attention) pattern
(12 stacked repeats + 2 RG-LRU tail blocks), MQA kv=1 at head dim 256,
local window 2048.  long_500k runs natively (a constant recurrent state and
a 2048-slot ring for the local attention).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048,
        rglru_width=4096,
        rope_theta=1e4,
        dtype=torch.bfloat16,
        citation="arXiv:2402.19427 (Griffin/RecurrentGemma) — RG-LRU + "
                 "local attn 1:2, MQA kv=1",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, local_window=32, rglru_width=128,
        dtype=torch.float32, remat=False,
    )

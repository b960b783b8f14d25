"""StarCoder2-3B [arXiv:2402.19173]: a dense GQA code LM with a native 4096
sliding window and RoPE (`repro/configs/starcoder2_3b.py`).

The window makes every decode cache a ring buffer of min(max_len, 4096)
slots, long_500k's included.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "starcoder2-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        window=4096,                      # native SWA -> long_500k runs as-is
        rope_theta=1e5,
        dtype=torch.bfloat16,
        citation="arXiv:2402.19173 (StarCoder2), GQA kv=2, SWA 4096, RoPE",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, window=64,
        dtype=torch.float32)

"""Granite-8B-Code [arXiv:2405.04324]: a llama-architecture dense code LM
(`repro/configs/granite_8b.py`).

Full attention natively; long_500k uses the explicit 8192 SWA variant (a
ring-buffer cache of 8192 slots).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "granite-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        long_context_window=8192,
        rope_theta=1e4,
        dtype=torch.bfloat16,
        citation="arXiv:2405.04324 (Granite Code) — llama arch, GQA kv=8",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, dtype=torch.float32)

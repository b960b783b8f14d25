"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space
duality) (`repro/configs/mamba2_1_3b.py`).

48 layers, d_model 2048 (d_inner 4096, 64 heads of headdim 64, d_state 128).
Decode (incl. long_500k) carries a constant [B, H, N, P] recurrent state — no
KV cache, the arch's whole point for long context.
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig, SSMConfig

ARCH_ID = "mamba2-1.3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=64,                       # d_inner/headdim (bookkeeping only)
        n_kv_heads=64,
        d_ff=0,                           # Mamba blocks have no separate FFN
        vocab_size=50280,
        block_pattern=("ssm",),
        ssm=SSMConfig(d_state=128, expand=2, headdim=64, chunk=256, d_conv=4,
                      ngroups=1),
        dtype=torch.bfloat16,
        citation="arXiv:2405.21060 (Mamba-2 SSD), ssm_state=128",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, vocab_size=512,
        ssm=SSMConfig(d_state=16, expand=2, headdim=32, chunk=16, d_conv=4,
                      ngroups=1),
        dtype=torch.float32, remat=False,
    )

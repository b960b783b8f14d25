"""Moonlight-16B-A3B (Moonshot) [hf:moonshotai/Moonlight-16B-A3B]
(`repro/configs/moonshot_v1_16b_a3b.py`).

DeepSeek-V3-style MoE: 64 routed experts top-6 + 2 shared, per-expert FFN
width 1408, MHA-ish kv=16.  long_500k uses the explicit 8192 sliding-window
long-context variant (flagged; the published model is full-attention).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig, MoEConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",               # per assignment bracket ([dense] w/ MoE)
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        block_pattern=("attn_moe",),
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                      impl="scan_dense"),
        long_context_window=8192,
        rope_theta=5e4,
        dtype=torch.bfloat16,
        citation="hf:moonshotai/Moonlight-16B-A3B — 64e top-6 + 2 shared, kv=16",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=128, vocab_size=512, dtype=torch.float32,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, num_shared=1,
                      impl="scan_dense"))

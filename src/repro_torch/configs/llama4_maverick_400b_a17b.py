"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family]
(`repro/configs/llama4_maverick_400b_a17b.py`).

Interleaved dense/MoE layers (pattern attn, attn_moe), 128 routed experts
top-1 + 1 shared, GQA kv=8.  Early-fusion multimodality in the published
model is out of the assigned backbone scope (text tokens only here).
long_500k uses the 8192 SWA variant (the published model's iRoPE chunked
attention is likewise windowed).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig, MoEConfig

ARCH_ID = "llama4-maverick-400b-a17b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        block_pattern=("attn", "attn_moe"),
        moe=MoEConfig(num_experts=128, top_k=1, d_expert=8192, num_shared=1,
                      impl="scan_dense"),
        long_context_window=8192,
        rope_theta=5e5,
        dtype=torch.bfloat16,
        citation="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick cfg) — "
                 "MoE 128e top-1, interleaved dense/MoE",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, dtype=torch.float32,
        remat=False,
        moe=MoEConfig(num_experts=4, top_k=1, d_expert=256, num_shared=1,
                      impl="scan_dense"))

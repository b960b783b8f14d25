"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]
(`repro/configs/llava_next_mistral_7b.py`).

A VLM: the vision tower is stubbed, so a batch carries precomputed anyres
patch embeddings [B, 2880, 1024] (`embeds_prefix`); the two-layer GELU
projector that maps them into the residual stream and the Mistral-7B
backbone (GQA kv=8, native SWA 4096, so every decode cache is a ring of
min(max_len, 4096) slots) are real (`models/transformer.py`).
"""
import dataclasses

import torch

from repro_torch.models.common import FrontendConfig, ModelConfig

ARCH_ID = "llava-next-mistral-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        window=4096,                      # Mistral native SWA
        rope_theta=1e6,
        frontend=FrontendConfig(kind="vision", feature_dim=1024,
                                n_prefix=2880),
        dtype=torch.bfloat16,
        citation="hf:llava-hf/llava-v1.6-mistral-7b-hf — anyres tiling, "
                 "Mistral-7B GQA kv=8 SWA 4096",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, window=64, dtype=torch.float32,
        frontend=FrontendConfig(kind="vision", feature_dim=64, n_prefix=16),
    )

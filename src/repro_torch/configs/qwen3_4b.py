"""Qwen3-4B [hf:Qwen/Qwen3-8B family]: dense GQA with qk-norm, head_dim 128
(`repro/configs/qwen3_4b.py`).

Full attention natively; long_500k's 8192 SWA variant is a ring-buffer
cache of 8192 slots.  `lm_sweep()` is the sweep engine's
real-model LM lane (D = 2 950 528, `figures.run_lm_lane`).
"""
import dataclasses

import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen3-4b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        long_context_window=8192,
        rope_theta=1e6,
        dtype=torch.bfloat16,
        citation="hf:Qwen/Qwen3-8B — qk_norm, GQA kv=8",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, dtype=torch.float32)


def lm_sweep() -> ModelConfig:
    """The sweep engine's real-model LM lane: a shrunk qwen3-shaped
    transformer whose flat parameter count is D = 2 950 528, large enough
    to drive `floa_step_batched` / `grad_stats` / `sort_columns` at
    production D, small enough that the [S, U, D] gradient slab of a
    few-lane sweep fits one card.  f32, so the flat-state sweeps stay
    reproducible."""
    return dataclasses.replace(
        full(), n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        head_dim=32, d_ff=1024, vocab_size=2048, dtype=torch.float32)

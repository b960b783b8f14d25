"""SeamlessM4T-large-v2 [arXiv:2308.11596]: a multimodal encoder-decoder
(`repro/configs/seamless_m4t_large_v2.py`).

The 24 layers are split 12 encoder + 12 decoder, as the reference
interprets them.  The speech frontend is stubbed: the encoder consumes
precomputed frame embeddings [B, T, 1024] (`models/encdec.py`).
long_500k is skipped, as in the reference: full self- and
cross-attention with no sub-quadratic variant.
"""
import dataclasses

import torch

from repro_torch.models.common import EncDecConfig, FrontendConfig, ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        encdec=EncDecConfig(n_enc_layers=12, n_dec_layers=12,
                            enc_seq_cap=4096),
        frontend=FrontendConfig(kind="audio", feature_dim=1024),
        dtype=torch.bfloat16,
        skip_shapes=("long_500k",),
        citation="arXiv:2308.11596 (SeamlessM4T v2) — enc-dec, multimodal",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, dtype=torch.float32,
        encdec=EncDecConfig(n_enc_layers=2, n_dec_layers=2, enc_seq_cap=32),
        frontend=FrontendConfig(kind="audio", feature_dim=64),
    )

"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA + 160-expert MoE
(`repro/configs/deepseek_v2_236b.py`).

MLA (kv_lora=512 + 64 rope dims/token cache => 1152 B/token bf16) makes full
attention over a 524288-token cache feasible — long_500k runs without a
window variant, unlike the dense archs.  2 shared + 160 routed top-6
experts, per-expert width 1536.
"""
import dataclasses

import torch

from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-236b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        block_pattern=("attn_moe",),
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                      impl="scan_dense"),
        rope_theta=1e4,
        dtype=torch.bfloat16,
        citation="arXiv:2405.04434 (DeepSeek-V2) — MLA kv_lora=512, "
                 "2 shared + 160 routed top-6",
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        full(),
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=512, dtype=torch.float32, remat=False,
        mla=MLAConfig(q_lora=64, kv_lora=32, qk_nope_dim=32, qk_rope_dim=16,
                      v_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, num_shared=1,
                      impl="scan_dense"),
    )

"""Architecture registry of the port: --arch <id> -> config
(`repro/configs/registry.py`).  The dense archs (qwen3-4b, granite-8b,
starcoder2-3b), the MoE archs (moonshot-v1-16b-a3b,
llama4-maverick-400b-a17b), the MLA + MoE deepseek-v2-236b, the Mamba-2
SSD mamba2-1.3b and the RG-LRU hybrid recurrentgemma-9b are ported;
llava-next-mistral-7b and seamless-m4t-large-v2 raise NotImplementedError
(ROADMAP.md Queue 1 item 10)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, granite_8b,
                                 llama4_maverick_400b_a17b, mamba2_1_3b,
                                 moonshot_v1_16b_a3b, qwen3_4b,
                                 recurrentgemma_9b, starcoder2_3b)
from repro_torch.models.common import ModelConfig

ARCH_MODULES = {m.ARCH_ID: m for m in [
    starcoder2_3b, moonshot_v1_16b_a3b, qwen3_4b, granite_8b,
    llama4_maverick_400b_a17b, deepseek_v2_236b, mamba2_1_3b,
    recurrentgemma_9b]}
ARCH_IDS = list(ARCH_MODULES)

# The assigned input shapes (system spec).
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported (ROADMAP.md Queue 1 item 10); "
            f"ported: {sorted(ARCH_MODULES)}")
    return ARCH_MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).full()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_lm_sweep(arch: str = "qwen3-4b") -> ModelConfig:
    """The config an arch contributes to the sweep engine's real-model LM
    lane; only archs with an `lm_sweep()` variant have one
    (AttributeError otherwise)."""
    return _module(arch).lm_sweep()


def flat_param_dim(cfg: ModelConfig) -> int:
    """Flat parameter count D of a config, the sweep engine's state-row
    width: counted off an init on the "meta" device (nothing is
    allocated)."""
    from repro_torch.launch.steps import param_count
    return param_count(cfg)


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """Whether cfg runs an input shape (not in its `skip_shapes`)."""
    return shape_name not in cfg.skip_shapes

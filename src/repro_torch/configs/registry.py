"""Architecture registry of the port: --arch <id> -> config
(`repro/configs/registry.py`).  Only qwen3-4b is ported; every other
architecture of the JAX package raises NotImplementedError (ROADMAP.md
Queue 1 item 10)."""
from __future__ import annotations

from repro_torch.configs import qwen3_4b
from repro_torch.models.common import ModelConfig

ARCH_MODULES = {qwen3_4b.ARCH_ID: qwen3_4b}

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

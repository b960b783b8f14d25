"""Experiment and model configs of the port (dataclasses only)."""
from repro_torch.configs import (deepseek_v2_236b, granite_8b,
                                 llama4_maverick_400b_a17b, mamba2_1_3b,
                                 moonshot_v1_16b_a3b, paper_mlp, qwen3_4b,
                                 recurrentgemma_9b, starcoder2_3b)
from repro_torch.configs.registry import (ARCH_IDS, INPUT_SHAPES,
                                          flat_param_dim, get_config,
                                          get_lm_sweep, get_smoke,
                                          shape_applicable)

PAPER_MLP = paper_mlp

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "PAPER_MLP", "deepseek_v2_236b",
           "flat_param_dim", "get_config", "get_lm_sweep", "get_smoke",
           "granite_8b", "llama4_maverick_400b_a17b", "mamba2_1_3b",
           "moonshot_v1_16b_a3b", "paper_mlp", "qwen3_4b", "recurrentgemma_9b",
           "shape_applicable", "starcoder2_3b"]

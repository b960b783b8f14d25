"""Experiment and model configs of the port (dataclasses only)."""
from repro_torch.configs import paper_mlp, qwen3_4b
from repro_torch.configs.registry import (INPUT_SHAPES, flat_param_dim,
                                          get_config, get_lm_sweep, get_smoke)

PAPER_MLP = paper_mlp

__all__ = ["INPUT_SHAPES", "PAPER_MLP", "flat_param_dim", "get_config",
           "get_lm_sweep", "get_smoke", "paper_mlp", "qwen3_4b"]

"""Experiment and model configs of the port (dataclasses only)."""
from repro_torch.configs import paper_mlp, qwen3_4b
from repro_torch.configs.registry import (INPUT_SHAPES, get_config,
                                          get_smoke)

PAPER_MLP = paper_mlp

__all__ = ["INPUT_SHAPES", "PAPER_MLP", "get_config", "get_smoke",
           "paper_mlp", "qwen3_4b"]

"""Experiment configs of the port (numpy/dataclass only)."""
from repro_torch.configs import paper_mlp

PAPER_MLP = paper_mlp

__all__ = ["PAPER_MLP", "paper_mlp"]

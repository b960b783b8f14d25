"""Feed-forward layer of the port: SwiGLU (`repro/models/ffn.py`).

The three products are plain `torch.matmul`s: in the reference they are
XLA einsums outside any Pallas kernel."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import ModelConfig, ParamInit

Tensor = torch.Tensor


def init_swiglu(pi: ParamInit, cfg: ModelConfig, d_ff: int = 0) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"wi": pi.param((d, f), fan_in=d),      # gate
            "wg": pi.param((d, f), fan_in=d),      # up
            "wo": pi.param((f, d), fan_in=f)}      # down


def swiglu(p: Dict, x: Tensor) -> Tensor:
    """x [..., d] -> silu(x @ wi) * (x @ wg) @ wo."""
    h = torch.nn.functional.silu(x @ p["wi"]) * (x @ p["wg"])
    return h @ p["wo"]

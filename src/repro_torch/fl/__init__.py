"""Federated-learning drivers of the port: the flat-state sweep engine."""
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepResult,
                                  SweepSpec, run_sweep)

__all__ = ["ScenarioCase", "SweepEngine", "SweepResult", "SweepSpec",
           "run_sweep"]

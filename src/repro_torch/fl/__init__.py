"""Federated-learning drivers of the port: the flat-state sweep engine and
the looped trainer."""
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepResult,
                                  SweepSpec, run_sweep)
from repro_torch.fl.trainer import FLTrainer, RoundLog

__all__ = ["FLTrainer", "RoundLog", "ScenarioCase", "SweepEngine",
           "SweepResult", "SweepSpec", "run_sweep"]

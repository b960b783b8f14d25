"""Federated-learning drivers of the port: the sweep engine, its execution
plan and the looped trainer."""
from repro_torch.fl.plan import ExecutionPlan
from repro_torch.fl.sweep import (ScenarioCase, SweepEngine, SweepResult,
                                  SweepSpec, run_sweep)
from repro_torch.fl.trainer import FLTrainer, RoundLog

__all__ = ["ExecutionPlan", "FLTrainer", "RoundLog", "ScenarioCase",
           "SweepEngine", "SweepResult", "SweepSpec", "run_sweep"]

"""Optimizers and learning-rate schedules of the port (`repro/optim`):
public API with no caller inside the package, as in the reference."""
from repro_torch.optim.optimizers import adamw, apply_updates, sgd
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["sgd", "adamw", "apply_updates", "constant", "cosine",
           "warmup_cosine"]

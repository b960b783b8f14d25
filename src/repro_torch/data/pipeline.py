"""Per-worker federated batch sampling (numpy only).

A copy of the `FederatedSampler` part of `repro/data/pipeline.py`: each
worker holds an i.i.d. local shard and samples its own minibatch each round;
the global batch is the concatenation ordered by worker index, so
batch.reshape(U, -1, ...) recovers worker locality — the layout
`core.aggregation.per_worker_grads` expects.  Same seed, same bytes as the
JAX package's sampler.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class FederatedSampler:
    """Round-based sampler over per-worker data shards."""

    def __init__(self, shards: Dict[int, tuple], batch_per_worker: int, seed: int = 0):
        self.shards = shards
        self.bpw = batch_per_worker
        self.rng = np.random.default_rng(seed)

    @property
    def num_workers(self) -> int:
        return len(self.shards)

    def next_round(self) -> Dict[str, np.ndarray]:
        xs, ys = [], []
        for i in range(self.num_workers):
            x, y = self.shards[i]
            idx = self.rng.integers(0, len(x), size=self.bpw)
            xs.append(x[idx])
            ys.append(y[idx])
        return {"x": np.concatenate(xs), "y": np.concatenate(ys)}

    def stack_rounds(self, rounds: int) -> Dict[str, np.ndarray]:
        """Pre-draw `rounds` batches stacked on a leading [R] axis — the input
        layout the sweep engine consumes.  Draws from the same RNG stream as
        repeated next_round() calls, so a fresh same-seed sampler replays the
        identical sequence."""
        draws = [self.next_round() for _ in range(rounds)]
        return {k: np.stack([d[k] for d in draws]) for k in draws[0]}

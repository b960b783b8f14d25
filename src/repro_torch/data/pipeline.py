"""Per-worker federated batch sampling (numpy only).

A copy of the `FederatedSampler`, `dirichlet_worker_split` and
`TokenBatcher` parts of `repro/data/pipeline.py`: each worker holds a local shard and samples its
own minibatch each round; the global batch is the concatenation ordered by
worker index, so batch.reshape(U, -1, ...) recovers worker locality — the
layout `core.aggregation.per_worker_grads` expects.  Same seed, same bytes
as the JAX package's sampler and split.

Non-IID partitions (beyond the paper's i.i.d. assumption):
`dirichlet_worker_split` deals each class's samples across workers with
proportions drawn from Dirichlet(alpha * 1_U), the standard federated
label-skew benchmark; alpha = np.inf takes exact proportions 1/U, a
stratified IID split.

Chunked input (the chunked sweep's host side): `iter_chunk_blocks` cuts a
stacked [R, ...] batch dict into [C, ...] blocks, and
`FederatedSampler.iter_round_chunks` draws the same rounds block by block
without the whole stack; both concatenate to exactly `stack_rounds(R)`.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np


def dirichlet_worker_split(
    x: np.ndarray, y: np.ndarray, num_workers: int, alpha: float,
    seed: int = 0, min_per_worker: int = 1,
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Dirichlet(alpha) label-skew partition of (x, y) into U worker shards.

    Per class: shuffle its sample indices, draw proportions
    p ~ Dirichlet(alpha * 1_U) (p = 1/U exactly when alpha = np.inf), and
    deal contiguous slices at the cumulative-proportion boundaries.  A
    worker left under `min_per_worker` samples takes them from the largest
    shard (deterministic, largest first), so every worker can draw a
    batch."""
    if not (alpha > 0.0):  # also rejects NaN
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if len(x) < num_workers * min_per_worker:
        raise ValueError(
            f"{len(x)} samples cannot give {num_workers} workers "
            f">= {min_per_worker} each")
    rng = np.random.default_rng(seed)
    per_worker = [[] for _ in range(num_workers)]
    for c in np.unique(y):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        if np.isinf(alpha):
            p = np.full(num_workers, 1.0 / num_workers)
        else:
            p = rng.dirichlet(np.full(num_workers, float(alpha)))
        cuts = np.floor(np.cumsum(p)[:-1] * len(idx)).astype(np.int64)
        for i, part in enumerate(np.split(idx, cuts)):
            per_worker[i].append(part)
    shards = [np.concatenate(parts) if parts else np.empty(0, np.int64)
              for parts in per_worker]
    for i in range(num_workers):
        while len(shards[i]) < min_per_worker:
            j = int(np.argmax([len(s) for s in shards]))
            shards[i] = np.concatenate([shards[i], shards[j][-1:]])
            shards[j] = shards[j][:-1]
    return {i: (x[s], y[s]) for i, s in enumerate(shards)}


def iter_chunk_blocks(batches: Dict[str, np.ndarray],
                      chunk_rounds: int) -> Iterator[Dict[str, np.ndarray]]:
    """Slice a stacked [R, ...] batch dict into consecutive [C, ...] blocks:
    ceil(R / C) blocks in round order, the last one R % C rounds long when
    C does not divide R, so their concatenation is the input.  On numpy
    inputs each block's arrays are views."""
    if chunk_rounds < 1:
        raise ValueError(f"chunk_rounds must be >= 1, got {chunk_rounds}")
    rounds = next(iter(batches.values())).shape[0]
    for start in range(0, rounds, chunk_rounds):
        yield {k: v[start:start + chunk_rounds] for k, v in batches.items()}


class FederatedSampler:
    """Round-based sampler over per-worker data shards."""

    def __init__(self, shards: Dict[int, tuple], batch_per_worker: int, seed: int = 0):
        self.shards = shards
        self.bpw = batch_per_worker
        self.rng = np.random.default_rng(seed)

    @classmethod
    def dirichlet(cls, x: np.ndarray, y: np.ndarray, num_workers: int,
                  alpha: float, batch_per_worker: int,
                  seed: int = 0) -> "FederatedSampler":
        """Sampler over a Dirichlet(alpha) label-skew partition
        (`dirichlet_worker_split`)."""
        shards = dirichlet_worker_split(x, y, num_workers, alpha, seed=seed)
        return cls(shards, batch_per_worker, seed=seed)

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

    def iter_round_chunks(self, rounds: int, chunk_rounds: int
                          ) -> Iterator[Dict[str, np.ndarray]]:
        """`rounds` rounds of batches as stacked [C, ...] blocks of
        `chunk_rounds` rounds (the last shorter when C does not divide R),
        from the same RNG stream as `stack_rounds(rounds)`: the blocks
        concatenate to its stack, but only one block is held at a time."""
        done = 0
        while done < rounds:
            yield self.stack_rounds(min(chunk_rounds, rounds - done))
            done += chunk_rounds


class TokenBatcher:
    """Iterates [global_batch, seq_len + 1] token batches from a generator
    fn (`sample_fn(n_seqs, seq_len)`, e.g. `data.text.sample_tokens` with
    its vocab bound): the train step's {"tokens"} batches, one more
    position than the loss trains on."""

    def __init__(self, sample_fn: Callable[[int, int], np.ndarray],
                 global_batch: int, seq_len: int, seed: int = 0):
        self.sample_fn = sample_fn
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.sample_fn(self.global_batch, self.seq_len + 1)
        self.step += 1
        return {"tokens": batch}

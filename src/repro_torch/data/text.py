"""Synthetic token-stream corpus for LM training and serving prompts: a copy
of `repro/data/text.py` (pure numpy), byte-equal at the same seed.

A Zipf-distributed Markov stream with planted n-gram structure, so the LM loss
genuinely decreases with training (unlike uniform noise).  Deterministic in
the seed; vocab-size agnostic.
"""
from __future__ import annotations

import numpy as np


def make_markov_tables(vocab: int, seed: int, branch: int = 16):
    """Each token has `branch` likely successors drawn from a Zipf prior."""
    rng = np.random.default_rng(seed)
    zipf_p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    succ = rng.choice(vocab, size=(vocab, branch), p=zipf_p)
    return succ


def stack_token_rounds(rounds: int, n_seqs: int, seq_len: int, vocab: int,
                       seed: int = 0) -> np.ndarray:
    """[rounds, n_seqs, seq_len] int32: one independent Markov batch per FL
    round (round t draws from seed + t), pre-stacked into the [R, ...] batch
    layout the sweep engine consumes.  Stays a numpy array so the chunked
    engine can slice [C, ...] blocks host-side for free."""
    return np.stack([sample_tokens(n_seqs, seq_len, vocab, seed=seed + t)
                     for t in range(rounds)])


def sample_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """[n_seqs, seq_len] int32 Markov sequences."""
    rng = np.random.default_rng(seed + 1)
    succ = make_markov_tables(vocab, seed)
    out = np.empty((n_seqs, seq_len), np.int32)
    cur = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        out[:, t] = cur
        pick = rng.integers(0, succ.shape[1], size=n_seqs)
        nxt = succ[cur, pick]
        # 10% random restarts keep entropy > 0
        restart = rng.random(n_seqs) < 0.1
        cur = np.where(restart, rng.integers(0, vocab, size=n_seqs), nxt)
    return out

"""Procedural MNIST-like dataset: a numpy-only copy of the JAX package's
`repro/data/synthetic_digits.py`, byte-equal to it at the same seed.

Deterministic 28x28 grayscale "digits": each class is a fixed stroke template
(drawn with line segments / arcs on a grid), rendered with random affine
jitter (shift, scale, rotation), stroke thickness and pixel noise.  This gives
a genuinely learnable 10-class problem with MNIST's input dimensionality
(784), so the paper's MLP / convergence experiments transfer directly.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

_SIZE = 28

# Stroke templates in a [0,1]^2 coordinate box: list of polylines per digit.
_TEMPLATES = {
    0: [[(0.5, 0.1), (0.8, 0.3), (0.8, 0.7), (0.5, 0.9), (0.2, 0.7), (0.2, 0.3), (0.5, 0.1)]],
    1: [[(0.35, 0.25), (0.55, 0.1), (0.55, 0.9)], [(0.35, 0.9), (0.75, 0.9)]],
    2: [[(0.2, 0.25), (0.5, 0.1), (0.8, 0.3), (0.2, 0.9), (0.8, 0.9)]],
    3: [[(0.2, 0.15), (0.7, 0.15), (0.45, 0.45), (0.8, 0.7), (0.5, 0.92), (0.2, 0.8)]],
    4: [[(0.65, 0.9), (0.65, 0.1), (0.2, 0.6), (0.85, 0.6)]],
    5: [[(0.8, 0.1), (0.25, 0.1), (0.25, 0.5), (0.65, 0.45), (0.8, 0.7), (0.55, 0.92), (0.2, 0.82)]],
    6: [[(0.7, 0.1), (0.35, 0.4), (0.25, 0.75), (0.5, 0.92), (0.75, 0.72), (0.55, 0.5), (0.3, 0.62)]],
    7: [[(0.2, 0.1), (0.8, 0.1), (0.45, 0.9)], [(0.35, 0.5), (0.7, 0.5)]],
    8: [[(0.5, 0.1), (0.75, 0.28), (0.5, 0.48), (0.25, 0.28), (0.5, 0.1)],
        [(0.5, 0.48), (0.8, 0.7), (0.5, 0.92), (0.2, 0.7), (0.5, 0.48)]],
    9: [[(0.75, 0.35), (0.5, 0.5), (0.3, 0.3), (0.5, 0.1), (0.75, 0.25), (0.72, 0.6), (0.5, 0.9)]],
}


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((_SIZE, _SIZE), np.float32)
    # random affine jitter
    ang = rng.uniform(-0.25, 0.25)
    scale = rng.uniform(0.8, 1.1)
    dx, dy = rng.uniform(-0.08, 0.08, size=2)
    ca, sa = np.cos(ang), np.sin(ang)
    thick = rng.uniform(0.7, 1.4)

    def tx(p):
        x, y = p[0] - 0.5, p[1] - 0.5
        x, y = ca * x - sa * y, sa * x + ca * y
        return ((x * scale + 0.5 + dx) * (_SIZE - 1), (y * scale + 0.5 + dy) * (_SIZE - 1))

    yy, xx = np.mgrid[0:_SIZE, 0:_SIZE].astype(np.float32)
    for line in _TEMPLATES[digit]:
        pts = [tx(p) for p in line]
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            # distance from each pixel to the segment
            vx, vy = x1 - x0, y1 - y0
            ll = max(vx * vx + vy * vy, 1e-6)
            t = np.clip(((xx - x0) * vx + (yy - y0) * vy) / ll, 0.0, 1.0)
            d2 = (xx - (x0 + t * vx)) ** 2 + (yy - (y0 + t * vy)) ** 2
            img = np.maximum(img, np.exp(-d2 / (2.0 * thick**2)))
    img += rng.normal(0.0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_dataset(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n,784] float32 in [0,1], y [n] int32), label-balanced.

    Rendering takes ~0.35 ms an image on one CPU core (11 s for the
    U = 1000 grid's 32 000), and every figure, grid and trainer built in a
    process draws the same few datasets: the process keeps the last 8 it
    rendered (`_rendered`) and returns copies of them."""
    x, y = _rendered(int(n), int(seed))
    return x.copy(), y.copy()


@functools.lru_cache(maxsize=8)
def _rendered(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """`make_dataset`'s arrays, read-only."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = np.stack([_render(int(d), rng).reshape(-1) for d in y])
    x.flags.writeable = y.flags.writeable = False
    return x, y


def worker_split(x: np.ndarray, y: np.ndarray, num_workers: int,
                 seed: int = 0) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """I.i.d. split across workers (the paper's §II-A assumption)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    shards = np.array_split(perm, num_workers)
    return {i: (x[s], y[s]) for i, s in enumerate(shards)}

"""Minimal functional optimizers over nested-dict parameter trees
(`repro/optim/optimizers.py`).

Each optimizer is (init_fn, update_fn):
  state = init_fn(params)
  updates, state = update_fn(grads, state, params, lr)
  params = apply_updates(params, updates)
State and updates are f32 whatever the params' dtype.  The paper's FLOA
update (eq. 8) is plain SGD on the noisy aggregate.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def apply_updates(params, updates):
    """params + updates, added in f32 and cast back to each leaf's dtype."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(_zeros_f32, params)

    def update(grads, state, params, lr):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g.float(), grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return dict(mu=tree_map(_zeros_f32, params),
                    nu=tree_map(_zeros_f32, params),
                    t=torch.zeros((), dtype=torch.int32))

    def update(grads, state, params, lr):
        t = state["t"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state["nu"], grads)
        tf = t.float()
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf

        def u(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step

        return tree_map(u, mu, nu, params), dict(mu=mu, nu=nu, t=t)

    return Optimizer(init, update)

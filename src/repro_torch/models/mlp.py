"""The paper's experiment model (§IV): MLP 784-64-10, ReLU, cross-entropy.

D = 784*64 + 64 + 64*10 + 10 = 50890 parameters, matching the paper exactly.
Parameters are a dict of tensors in the JAX package's layout — w1 [784, 64],
w2 [64, 10], logits = x @ w + b — not `nn.Linear`'s [out, in], so weights
carry across unchanged (`params_from_jax`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def init_mlp(generator: torch.Generator, d_in: int = 784, d_hidden: int = 64,
             n_classes: int = 10, device=None) -> Dict[str, Tensor]:
    """He-normal weights drawn from `generator`, zero biases, on the
    generator's device unless `device` is given."""
    device = generator.device if device is None else device

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * (2.0 / fan_in) ** 0.5)

    return {
        "w1": normal((d_in, d_hidden), d_in),
        "b1": torch.zeros((d_hidden,), device=device),
        "w2": normal((d_hidden, n_classes), d_hidden),
        "b2": torch.zeros((n_classes,), device=device),
    }


def params_from_jax(params: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """JAX-package params (as numpy arrays) -> the port's dict, same layout."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in params.items()}


def mlp_logits(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params: Dict[str, Tensor], batch: Dict[str, Tensor]) -> Tensor:
    """Cross-entropy; batch = {"x": [B, 784], "y": [B] int}."""
    logp = torch.log_softmax(mlp_logits(params, batch["x"]), dim=-1)
    ll = torch.gather(logp, -1, batch["y"].long()[:, None])[:, 0]
    return -ll.mean()


def mlp_accuracy(params: Dict[str, Tensor], x: Tensor, y: Tensor) -> Tensor:
    pred = mlp_logits(params, x).argmax(dim=-1)
    return (pred == y.long()).float().mean()


def num_params(params: Dict[str, Tensor]) -> int:
    return sum(int(p.numel()) for p in params.values())

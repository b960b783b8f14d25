"""Step functions of the port (`repro/launch/steps.py`): the model init and
the serve (decode) step, on one device.

The JAX versions also derive shardings for a mesh and compile with pjit;
the port runs eagerly on one card, so `make_decode_step` returns the step
function itself.  The train and prefill steps are not ported (ROADMAP.md
Queue 1 item 9); the encoder-decoder (audio) branch raises (item 10).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, count_params


def _refuse_audio(cfg: ModelConfig) -> None:
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            "the encoder-decoder (audio) models are not ported (ROADMAP.md "
            "Queue 1 item 10)")


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator],
               device=None) -> Dict:
    """Random weights of cfg (see `transformer.init_lm`)."""
    _refuse_audio(cfg)
    return T.init_lm(generator, cfg, device)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of cfg, from an init on the "meta" device (nothing
    is allocated)."""
    return count_params(init_model(cfg, None, "meta"))


def decode_window(cfg: ModelConfig, shape_name: str) -> Optional[int]:
    """Effective attention window for a decode shape: the native window if the
    model has one; for long_500k on full-attention dense archs, the explicit
    long-context SWA variant; otherwise full attention."""
    if cfg.window:
        return cfg.window
    if shape_name == "long_500k" and cfg.long_context_window and cfg.mla is None:
        return cfg.long_context_window
    return None


def make_decode_step(cfg: ModelConfig, shape_name: str = "decode_32k", *,
                     plain: bool = False) -> Tuple[Callable, Dict]:
    """The serve step of one new token against a KV cache:
    `step(params, caches, tokens1, pos) -> (logits [B, 1, Vp], caches)`,
    and `meta` with the parameter count `dim` and the attention `window`.
    `plain=True` routes the attention through the kernel's plain version
    (for kernel-vs-plain comparisons)."""
    _refuse_audio(cfg)
    window = decode_window(cfg, shape_name)

    def step(params, caches, tokens1, pos):
        return T.decode_step(params, caches, tokens1, pos, cfg,
                             window=window, plain=plain)

    return step, dict(dim=param_count(cfg), window=window)

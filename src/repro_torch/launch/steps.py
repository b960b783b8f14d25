"""Step functions of the port (`repro/launch/steps.py`): the model init, the
FLOA train step, the prefill step and the serve (decode) step, on one
device.

The FLOA train step realizes the paper's eq. (6)-(8) in ONE backward pass
via the weighted-loss identity

    sum_i s_i * grad L_i  ==  grad ( sum_i s_i L_i ),

where worker i is the i-th slice of the global batch and s_i its signed
received coefficient (power x channel gain, sign-flipped for Byzantine
workers, Thm 1).  The de-standardization bias (eq. 7, third term) and the
receiver AWGN (eps_t * z) are added to the aggregate leaf by leaf, then SGD
applies it (eq. 8).  The scalar stats (gbar_t, eps_t) the coefficients and
the noise use are a one-round-stale EMA estimated from the aggregate, as in
the reference.  The step runs no kernel of the port: its combine is the
backward itself (autograd and cuBLAS), as the reference's is XLA's.

The JAX versions also derive shardings for a mesh and compile with pjit;
the port runs eagerly on one card, so each builder returns the step
function itself and a `meta` dict.  On one card U = 1 (the JAX package's
1x1 mesh has one worker), so `default_floa` sets no attacker; a mesh of
more than one device raises (ROADMAP.md Queue 1 item 8), and so do the
encoder-decoder (audio) and VLM inputs (item 10).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import attacks as ATK
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import (ChannelConfig, noise_std_for_snr,
                                      sample_channel_gains)
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, count_params
from repro_torch.tree import tree_flatten, tree_unflatten

Tensor = torch.Tensor

_Q_MESH = "meshes are not ported (ROADMAP.md Queue 1 item 8)"


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


def num_workers(mesh) -> int:
    """U of a mesh: None (one card) or a (data, model) shape of one device
    gives 1, as the JAX package's 1x1 mesh does; a mesh of more than one
    device raises."""
    if mesh is None:
        return 1
    if math.prod(tuple(mesh)) != 1:
        raise NotImplementedError(f"mesh {tuple(mesh)}: {_Q_MESH}")
    return 1


def batch_shapes(cfg: ModelConfig, shape: Dict, kind: str
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of a given input shape: tokens
    [B, S + 1] for training (the loss trains on S positions), [B, S] for
    prefill.  The VLM and audio layouts raise (not ported)."""
    if cfg.arch_type in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.arch_type} inputs are not ported (ROADMAP.md Queue 1 "
            f"item 10)")
    b, s = shape["global_batch"], shape["seq_len"]
    return {"tokens": ((b, s if kind == "prefill" else s + 1),
                       torch.int32)}


# ---------------------------------------------------------------------------
# FLOA config for LLM-scale training
# ---------------------------------------------------------------------------


def default_floa(mesh, dim: int, policy: Policy = Policy.BEV,
                 n_byzantine: int = 2, snr_db: float = 10.0,
                 attack: AttackType = AttackType.STRONGEST) -> Dict:
    """The production FLOA setup: U = the mesh's worker count, BEV power
    control, at most n_byzantine strongest attackers (fewer than half the
    workers, so none at U = 1)."""
    u = num_workers(mesh)
    n = min(n_byzantine, max(u // 2 - 1, 0))
    return dict(
        channel=ChannelConfig(num_workers=u, sigma=1.0,
                              noise_std=noise_std_for_snr(1.0, dim, snr_db)),
        power=PowerConfig(num_workers=u, dim=dim, p_max=1.0, policy=policy),
        attack=AttackConfig(attack=attack if n else AttackType.NONE,
                            byzantine_mask=first_n_mask(u, n)))


def init_floa_state(device=None) -> Dict[str, Tensor]:
    """The stale-stat carry: gbar = 0, eps2 = 1."""
    return dict(gbar=torch.zeros((), dtype=torch.float32, device=device),
                eps2=torch.ones((), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[Dict] = None, *,
                    policy: Policy = Policy.BEV, n_byzantine: int = 2,
                    alpha: float = 1e-3, use_floa: bool = True
                    ) -> Tuple[Callable, Dict]:
    """The FLOA train step and its meta (dim, num_workers, policy, the
    batch's shapes):

        step(params, state, batch, seed, draws=None)
            -> (new_params, new_state, metrics)

    params a nested dict, state {"gbar", "eps2"} (`init_floa_state`),
    batch {"tokens": [B, S + 1]} on the params' device.  The round's random
    draws are an input: draws = {"h_abs": [U] Rayleigh gains, "z": one
    standard-normal f32 tensor per leaf, in the JAX package's leaf order
    (`repro_torch.tree`)}; without them the step draws both from a Philox
    generator on the params' device seeded from `seed` (gains, then the
    leaves in order).  use_floa=False is the plain mean: s = 1/U, no bias,
    no noise, nothing drawn.  metrics: {"loss": the mean per-worker loss,
    "grad_scale": sum(s) + bias_w}."""
    shape = shape or dict(global_batch=256, seq_len=4096)
    u = num_workers(mesh)
    dim = param_count(cfg)
    floa = default_floa(mesh, dim, policy=policy, n_byzantine=n_byzantine)
    channel, power, attack = floa["channel"], floa["power"], floa["attack"]
    noisy = use_floa and channel.noise_std > 0.0

    def weighted_loss(params, batch, coeffs):
        per_ex, _ = T.lm_per_example_loss(params, batch, cfg)    # [B]
        per_worker = per_ex.reshape(u, -1).mean(dim=1)   # [U] local losses
        return coeffs @ per_worker.float(), per_worker.mean()

    def train_step(params, state, batch, seed, draws=None):
        leaves_p, treedef = tree_flatten(params)
        dev = leaves_p[0].device
        gbar, eps2 = state["gbar"], state["eps2"]
        gen = None
        if use_floa:
            if draws is None:   # gains, then each leaf's noise in order
                gen = torch.Generator(dev).manual_seed(int(seed))
                draws = {"h_abs": sample_channel_gains(gen, channel, dev)}
            s, bias_w = ATK.signed_coefficients(
                draws["h_abs"], power, channel, attack, gbar, eps2)
        else:
            s = torch.full((u,), 1.0 / u, device=dev)
            bias_w = torch.zeros((), device=dev)
        # one backward of the coefficient-weighted per-worker losses: its
        # gradient IS the over-the-air superposition sum_i s_i grad L_i
        xs = [x.detach().requires_grad_(True) for x in leaves_p]
        with torch.enable_grad():
            wl, mean_loss = weighted_loss(tree_unflatten(treedef, xs), batch,
                                          s)
            grads = torch.autograd.grad(wl, xs)
        # de-standardization bias (eq. 7 third term) + receiver AWGN, leaf
        # by leaf; then SGD on the noisy aggregate (eq. 8), in f32
        eps = torch.sqrt(eps2)
        new_leaves = []
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves_p, grads)):
                x = g + (bias_w * gbar).to(g.dtype)
                if noisy:
                    z = (torch.randn(g.shape, generator=gen, device=dev)
                         if gen is not None else draws["z"][i])
                    x = x + (eps * channel.noise_std * z).to(g.dtype)
                new_leaves.append(
                    (p.float() - alpha * x.float()).to(p.dtype))
                del x
            # stale-stat estimators for the next round, off the noiseless
            # aggregate; every sum in f32
            ssum = torch.sum(s) + bias_w
            s1 = sum(torch.sum(g, dtype=torch.float32) for g in grads)
            s2 = sum(torch.sum(torch.square(g.float())) for g in grads)
            fdim = float(dim)
            mean_g = s1 / fdim / torch.where(torch.abs(ssum) > 1e-9, ssum,
                                             torch.ones_like(ssum))
            var_g = torch.clamp_min(s2 / fdim - (s1 / fdim) ** 2, 1e-20)
            denom = torch.clamp_min(torch.sum(torch.square(s)), 1e-9)
            new_state = dict(
                gbar=0.9 * gbar + 0.1 * mean_g,
                eps2=torch.clamp(0.9 * eps2 + 0.1 * var_g / denom,
                                 1e-12, 1e12))
        metrics = dict(loss=mean_loss.detach(), grad_scale=ssum)
        return tree_unflatten(treedef, new_leaves), new_state, metrics

    return train_step, dict(dim=dim, num_workers=u, policy=str(policy),
                            batch=batch_shapes(cfg, shape, "train"))


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[Dict] = None) -> Tuple[Callable, Dict]:
    """The prefill (scoring) step: `step(params, batch) -> logits [B, Vp]`
    of the LAST position only (the full [B, S, vocab] logits are never
    formed), batch {"tokens": [B, S]}; no gradients."""
    num_workers(mesh)
    _refuse_audio(cfg)

    @torch.no_grad()
    def prefill(params, batch):
        h, _ = T.hidden_for_batch(params, batch["tokens"], cfg,
                                  embeds_prefix=batch.get("embeds_prefix"))
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h[:, -1, :] @ head

    meta = dict(dim=param_count(cfg))
    if shape is not None:
        meta["batch"] = batch_shapes(cfg, shape, "prefill")
    return prefill, meta


# ---------------------------------------------------------------------------
# decode (serve_step: ONE new token against a seq_len KV cache)
# ---------------------------------------------------------------------------


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


def make_step(cfg: ModelConfig, mesh, shape_name: str,
              shape: Dict) -> Tuple[Callable, Dict]:
    """The step of an input shape's kind (train, prefill or decode)."""
    if shape["kind"] == "train":
        return make_train_step(cfg, mesh, shape)
    if shape["kind"] == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    num_workers(mesh)
    return make_decode_step(cfg, shape_name)

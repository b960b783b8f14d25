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
the port runs eagerly, so each builder returns the step function itself
and a `meta` dict.  A mesh (`launch.mesh.SweepMesh`, over the ranks of a
process group) spans FL workers: U is the size of its worker axes
("pod", "data"), and each rank is one worker holding its B / U rows of the
global batch (`launch.mesh.worker_axes`; the reference's `batch_specs`).
In the train step rank w backpropagates s_w L_w (and its tokens' share of
the MoE term), and one all_reduce of the gradients over the worker group
(`_sum_over_workers`, a few flat buckets) forms the superposition
sum_u s_u grad L_u: the reference's psum over the worker axes, which is
the over-the-air sum.  Every rank draws the same gains and noise and
applies the same update, so the replicas stay bitwise equal.  Prefill and
decode split the batch over the worker axes when U divides it (the
reference's `tok_spec` rule) and gather the logits, so every rank returns
the global tensor; each rank keeps its own rows' KV caches
(`batch_rows`).  None and a one-device mesh are U = 1 (no attacker).

A "model" axis of M > 1 (`launch.mesh.model_axis`) splits every layer of
each worker over M ranks, tensor parallel (`common.tensor_parallel`): the
params a step takes and returns are this rank's shards
(`launch.sharding.shard_params` of `param_specs(cfg, M)`), the worker
group is the ranks of this rank's model index, and the gradients' sum runs
over it alone.  Each rank draws each leaf's noise at the leaf's full shape
from the same stream and keeps its slice, so the draws are the one-process
run's; the stale stats sum each split leaf's shards over the model group
and count a replicated leaf once.  Prefill and decode gather the vocab
shards of the logits over the model group, then the rows over the worker
group.

The VLM (arch_type "vlm") batches carry `embeds_prefix` [B, P, feat]
beside the tokens, and the encoder-decoder's (arch_type "audio") `frames`
[B, T, feat] (`batch_shapes`); the train step and the prefill split them
over the workers as they split the tokens.  The encoder-decoder's loss is
`encdec.encdec_per_example_loss` (no aux term), its prefill encodes the
frames, runs the decoder over the tokens and projects the last position,
and its decode step takes the precomputed cross K / V as an argument, as
the reference's does (`make_cross_kv_step` builds them on a mesh).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import attacks as ATK
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import (ChannelConfig, noise_std_for_snr,
                                      sample_channel_gains)
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.launch.distributed import all_gather, all_reduce_sum
from repro_torch.launch.mesh import model_axis, worker_axes
from repro_torch.launch.sharding import init_shards, param_specs
from repro_torch.models import attention as ATT
from repro_torch.models import encdec as ED
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, count_params,
                                       tensor_parallel)
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

Tensor = torch.Tensor

# The gradients' all_reduce packs the leaves into flat buffers of at most
# this many bytes: a few calls a step (gloo pays per call), and one
# buffer's worth of memory beside the gradients.
BUCKET_BYTES = 256 * 2 ** 20
# Elements of a leaf the update computes at once (`_noisy_sgd`).
UPDATE_CHUNK = 2 ** 26


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator],
               device=None, mesh=None) -> Dict:
    """Random weights of cfg (`transformer.init_lm`, or
    `encdec.init_encdec` for the encoder-decoder, arch_type "audio"); on a
    mesh with a "model" axis, this rank's shards of them
    (`launch.sharding.init_shards`: the whole weights are never
    formed)."""
    return init_shards(cfg, generator, device, mesh)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of cfg, from an init on the "meta" device (nothing
    is allocated)."""
    return count_params(init_model(cfg, None, "meta"))


def num_workers(mesh) -> int:
    """U of a mesh (`launch.mesh.worker_axes`): None and a one-device mesh
    give 1, as the JAX package's 1x1 mesh does; a SweepMesh the product of
    its "pod" and "data" sizes."""
    return worker_axes(mesh).num_workers


def batch_rows(mesh, batch: int) -> slice:
    """The rows of a global batch of `batch` this rank computes in prefill
    and decode on `mesh`: its worker's B / U rows when U divides the batch
    (the reference's `tok_spec` rule), else all of them.  A decode step on
    a mesh takes caches of this many rows."""
    wa = worker_axes(mesh)
    if wa.group is None or batch % wa.num_workers:
        return slice(0, batch)
    return wa.rows(batch)


def _noisy_sgd(p: Tensor, g: Tensor, shift: Tensor, z: Optional[Tensor],
               scale: Tensor, alpha: float) -> Tensor:
    """One leaf's update, p - alpha (g + shift + scale z): the bias `shift`
    and the noise added in g's dtype, the SGD step in f32 and cast to p's
    dtype (z None: no noise).  Computed UPDATE_CHUNK elements at a time:
    every op is elementwise, so the bits are those of one pass, and the f32
    transients of a stacked leaf stay a chunk's size."""
    out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    pf, gf, of = p.reshape(-1), g.reshape(-1), out.view(-1)
    zf = None if z is None else z.reshape(-1)
    for a in range(0, pf.numel(), UPDATE_CHUNK):
        c = slice(a, a + UPDATE_CHUNK)
        x = gf[c] + shift
        if zf is not None:
            x = x + (scale * zf[c]).to(g.dtype)
        of[c] = (pf[c].float() - alpha * x.float()).to(p.dtype)
    return out


def _sum_over_workers(grads, group, bucket_bytes: int = BUCKET_BYTES):
    """The gradient leaves (a list, replaced in place) summed over `group`:
    consecutive leaves of one dtype packed into a flat buffer of at most
    bucket_bytes (a larger leaf alone), one all_reduce in place a buffer;
    each leaf becomes a view of its summed buffer, so the unsummed leaves
    are freed as their buffer is filled (the caller holds no other
    reference to them)."""
    i = 0
    while i < len(grads):
        j, size = i, 0
        while j < len(grads) and grads[j].dtype == grads[i].dtype and (
                j == i or size + grads[j].nbytes <= bucket_bytes):
            size += grads[j].nbytes
            j += 1
        shapes = [g.shape for g in grads[i:j]]
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        grads[i:j] = [part.view(sh) for part, sh in zip(
            flat.split([math.prod(sh) for sh in shapes]), shapes)]
        i = j


def batch_shapes(cfg: ModelConfig, shape: Dict, kind: str
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of a given input shape, as the
    reference lays them out:

      lm:    tokens [B, S + 1] (the loss trains on S positions)
      vlm:   embeds_prefix [B, P, feat] + tokens [B, S - P + 1] (P + the
             text positions = S)
      audio: frames [B, min(S, enc_seq_cap), feat] + tokens [B, S + 1]

    the prefix and the frames bf16 whatever cfg.dtype; a prefill's tokens
    one shorter (no next-token shift)."""
    b, s = shape["global_batch"], shape["seq_len"]
    out = {}
    toks = s
    if cfg.arch_type == "vlm":
        pfx = cfg.frontend.n_prefix
        toks = s - pfx
        if toks <= 0:
            raise ValueError(f"{cfg.name}: seq_len {s} leaves no text "
                             f"positions after the {pfx}-position prefix")
        out["embeds_prefix"] = ((b, pfx, cfg.frontend.feature_dim),
                                torch.bfloat16)
    elif cfg.arch_type == "audio":
        out["frames"] = ((b, min(s, cfg.encdec.enc_seq_cap),
                          cfg.frontend.feature_dim), torch.bfloat16)
    out["tokens"] = ((b, toks if kind == "prefill" else toks + 1),
                     torch.int32)
    return out


def per_example_loss(params: Dict, batch: Dict, cfg: ModelConfig
                     ) -> Tuple[Tensor, Tensor]:
    """(per-sequence loss [B], aux) of cfg's model on batch: the
    encoder-decoder's with a zero aux (as the reference's train step
    has it), else `transformer.lm_per_example_loss`."""
    if cfg.arch_type == "audio":
        per_ex = ED.encdec_per_example_loss(params, batch, cfg)
        return per_ex, torch.zeros((), dtype=torch.float32,
                                   device=per_ex.device)
    return T.lm_per_example_loss(params, batch, cfg)


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
    batch {"tokens": [B, S + 1]} (and a VLM's "embeds_prefix", an
    encoder-decoder's "frames": `batch_shapes`), the global batch, on the
    params' device
    (on a mesh every rank passes it; rank w computes rows
    [w B / U, (w + 1) B / U), and U must divide B).  mesh: None, a
    `launch.mesh.SweepMesh` whose worker axes span the ranks, or a
    `launch.mesh.WorkerAxes` (`WorkerAxes.every(U)`: all U workers in one
    process, the mesh's one-process twin).  The round's random
    draws are an input: draws = {"h_abs": [U] Rayleigh gains, "z": one
    standard-normal f32 tensor per leaf, in the JAX package's leaf order
    (`repro_torch.tree`)}; without them the step draws both from a Philox
    generator on the params' device seeded from `seed` (gains, then the
    leaves in order); every rank of a mesh takes the same draws.
    use_floa=False is the plain mean: s = 1/U, no bias, no noise, nothing
    drawn.  metrics: {"loss": the mean per-worker loss over all U,
    "grad_scale": sum(s) + bias_w}.  On a mesh with a "model" axis of
    M > 1 params are this rank's shards (`launch.sharding.shard_params`
    of meta["params_specs"]) and so are the new params; draws["z"] stays
    one full-shape tensor a leaf, of which each rank takes its slice."""
    shape = shape or dict(global_batch=256, seq_len=4096)
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    u, group = wa.num_workers, wa.group
    specs = param_specs(cfg, axis.size)
    split = tree_leaves(specs)   # each leaf's split dim, or None
    dim = param_count(cfg)
    floa = default_floa(mesh, dim, policy=policy, n_byzantine=n_byzantine)
    channel, power, attack = floa["channel"], floa["power"], floa["attack"]
    noisy = use_floa and channel.noise_std > 0.0
    moe_coef = cfg.moe.router_aux_coef if cfg.moe else 0.0

    def weighted_loss(params, rows, coeffs):
        # this process's rows; on a mesh the MoE aux is the global batch's
        with MOE.worker_batch(group), tensor_parallel(axis):
            per_ex, aux = per_example_loss(params, rows, cfg)
        # the local losses L_i of this process's workers
        per_worker = per_ex.reshape(wa.count, -1).mean(dim=1)
        wl = coeffs[wa.first:wa.first + wa.count] @ per_worker.float()
        if moe_coef:   # the MoE load-balance term, weighted as the losses
            wl = wl + moe_coef * aux * torch.sum(coeffs) / u
        return wl, per_worker

    def train_step(params, state, batch, seed, draws=None):
        b = batch["tokens"].shape[0]
        if b % u:
            raise ValueError(f"global batch {b} is not a multiple of "
                             f"U = {u} workers")
        rows = {k: v[wa.rows(b)] for k, v in batch.items()}
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
        # (on a mesh, of this rank's worker, then summed over the ranks)
        xs = [x.detach().requires_grad_(True) for x in leaves_p]
        with torch.enable_grad():
            wl, per_worker = weighted_loss(tree_unflatten(treedef, xs), rows,
                                           s)
            grads = list(torch.autograd.grad(wl, xs))
        if group is None:
            mean_loss = per_worker.mean()
        else:
            _sum_over_workers(grads, group)
            mean_loss = all_reduce_sum(per_worker.detach().sum(), group) / u
        with torch.no_grad():
            # stale-stat estimators for the next round, off the noiseless
            # aggregate; every sum in f32
            ssum = torch.sum(s) + bias_w
            if axis.size == 1:
                s1 = sum(torch.sum(g, dtype=torch.float32) for g in grads)
                s2 = sum(torch.sum(torch.square(g.float())) for g in grads)
            else:   # the split leaves' shards summed over the model group
                s1, s2 = _split_stats(grads, split, axis.group)
            fdim = float(dim)
            mean_g = s1 / fdim / torch.where(torch.abs(ssum) > 1e-9, ssum,
                                             torch.ones_like(ssum))
            var_g = torch.clamp_min(s2 / fdim - (s1 / fdim) ** 2, 1e-20)
            denom = torch.clamp_min(torch.sum(torch.square(s)), 1e-9)
            new_state = dict(
                gbar=0.9 * gbar + 0.1 * mean_g,
                eps2=torch.clamp(0.9 * eps2 + 0.1 * var_g / denom,
                                 1e-12, 1e12))
            # de-standardization bias (eq. 7 third term) + receiver AWGN,
            # leaf by leaf; then SGD on the noisy aggregate (eq. 8), in
            # f32; each gradient is dropped once applied
            eps = torch.sqrt(eps2)
            new_leaves = []
            for i, p in enumerate(leaves_p):
                g, grads[i] = grads[i], None
                z = None
                if noisy:   # the leaf's full shape, then this rank's slice
                    z = (torch.randn(_full_shape(g, split[i], axis),
                                     generator=gen, device=dev)
                         if gen is not None else draws["z"][i])
                    if split[i] is not None:
                        z = z.narrow(split[i], axis.index * g.shape[split[i]],
                                     g.shape[split[i]])
                new_leaves.append(_noisy_sgd(
                    p, g, (bias_w * gbar).to(g.dtype), z,
                    eps * channel.noise_std, alpha))
                del g, z
        metrics = dict(loss=mean_loss.detach(), grad_scale=ssum)
        return tree_unflatten(treedef, new_leaves), new_state, metrics

    return train_step, dict(dim=dim, num_workers=u, policy=str(policy),
                            batch=batch_shapes(cfg, shape, "train"),
                            params_specs=specs)


def _full_shape(x: Tensor, dim: Optional[int], axis) -> Tuple[int, ...]:
    """The full shape of a leaf whose shard is x (split on dim, or not)."""
    if dim is None:
        return tuple(x.shape)
    return tuple(n * axis.size if i == dim else n
                 for i, n in enumerate(x.shape))


def _split_stats(grads, split, group) -> Tuple[Tensor, Tensor]:
    """(sum g, sum g^2) over the whole model, f32, from this rank's
    gradient shards: the split leaves' local sums all_reduced over the
    model group, plus the replicated leaves' sums, counted once."""
    def sums(gs):
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        return torch.stack([
            sum((torch.sum(g, dtype=torch.float32) for g in gs), zero),
            sum((torch.sum(torch.square(g.float())) for g in gs), zero)])
    local = all_reduce_sum(sums([g for g, d in zip(grads, split)
                                 if d is not None]), group)
    s = local + sums([g for g, d in zip(grads, split) if d is None])
    return s[0], s[1]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[Dict] = None) -> Tuple[Callable, Dict]:
    """The prefill (scoring) step: `step(params, batch) -> logits [B, Vp]`
    of the LAST position only (the full [B, S, vocab] logits are never
    formed), batch {"tokens": [B, S]} (and a VLM's "embeds_prefix", an
    encoder-decoder's "frames"), the global batch; no gradients.  The
    encoder-decoder encodes the frames and runs the decoder over the
    tokens.  On a mesh each rank scores its `batch_rows` and the logits
    are gathered, so every rank returns all B rows.  Over a "model" axis
    params are this rank's shards and the vocab shards of the logits are
    gathered."""
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)

    @torch.no_grad()
    def prefill(params, batch):
        rows = batch_rows(wa, batch["tokens"].shape[0])
        split = rows.stop - rows.start < batch["tokens"].shape[0]
        mine = {k: v[rows] for k, v in batch.items()}
        with MOE.worker_batch(wa.group if split else None, aux=False), \
                tensor_parallel(axis):
            if cfg.arch_type == "audio":
                h = ED.decode_hidden(params, mine["tokens"], ED.encode(
                    params, mine["frames"], cfg), cfg)
            else:
                h, _ = T.hidden_for_batch(
                    params, mine["tokens"], cfg,
                    embeds_prefix=mine.get("embeds_prefix"))
            logits = T.logits_from_hidden(params, h[:, -1, :], cfg)
        return all_gather(logits, wa.group) if split else logits

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
    long-context SWA variant; otherwise full attention.  It applies to the
    attn / attn_moe blocks only: recurrentgemma-9b's local_attn blocks
    always keep their cfg.local_window ring (None here at every shape)."""
    if cfg.window:
        return cfg.window
    if shape_name == "long_500k" and cfg.long_context_window and cfg.mla is None:
        return cfg.long_context_window
    return None


def make_decode_step(cfg: ModelConfig, shape_name: str = "decode_32k", *,
                     plain: bool = False, mesh=None
                     ) -> Tuple[Callable, Dict]:
    """The serve step of one new token against a KV cache:
    `step(params, caches, tokens1, pos) -> (logits [B, 1, Vp], caches)`,
    or for the encoder-decoder (arch_type "audio"), as the reference's,
    `step(params, caches, cross_kv, tokens1, pos)` with the decoder's
    self-attention caches (`encdec.init_dec_caches`) and the cross K / V
    (`encdec.precompute_cross_kv`, or `make_cross_kv_step` on a mesh: this
    rank's rows and KV heads),
    and `meta` with the parameter count `dim` and the attention `window`
    (`decode_window`).  A windowed step writes ring caches of
    min(max_len, window) slots: build them with
    `transformer.init_caches(cfg, B, max_len, window=meta["window"])`
    (long_500k on qwen3-4b: 8192 slots for 524 288 positions).
    `plain=True` routes the attention through the kernel's plain version
    (for kernel-vs-plain comparisons).  On a mesh tokens1 is the global
    [B, 1], each rank decodes its `batch_rows(mesh, B)` against caches of
    that many rows, and the logits are gathered: every rank returns all B
    rows.  Over a "model" axis of M > 1 params are this rank's shards
    (`launch.sharding.shard_params` of `param_specs(cfg, M)`) and the
    caches its KV heads (`transformer.init_caches(..., model_parallel=M)`)."""
    window = decode_window(cfg, shape_name)
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    meta = dict(dim=param_count(cfg), window=window)
    if cfg.arch_type == "audio":
        def encdec_step(params, caches, cross_kv, tokens1, pos):
            rows = batch_rows(wa, tokens1.shape[0])
            with tensor_parallel(axis):
                logits, caches = ED.decode_step(params, caches, cross_kv,
                                                tokens1[rows], pos, cfg,
                                                plain=plain)
            if rows.stop - rows.start == tokens1.shape[0]:
                return logits, caches
            return all_gather(logits, wa.group), caches

        return encdec_step, meta

    def step(params, caches, tokens1, pos):
        rows = batch_rows(wa, tokens1.shape[0])
        with tensor_parallel(axis):
            if rows.stop - rows.start == tokens1.shape[0]:
                return T.decode_step(params, caches, tokens1, pos, cfg,
                                     window=window, plain=plain)
            with MOE.worker_batch(wa.group, aux=False):
                logits, caches = T.decode_step(params, caches, tokens1[rows],
                                               pos, cfg, window=window,
                                               plain=plain)
        return all_gather(logits, wa.group), caches

    return step, meta


def make_cross_kv_step(cfg: ModelConfig, mesh=None) -> Tuple[Callable, Dict]:
    """The encoder-decoder's encoder for decoding: `step(params, frames) ->
    cross_kv`, frames [B, T, feat] the global batch; `encdec.encode`, then
    `encdec.precompute_cross_kv` ([L, B, T, KV, hd] x 2), no gradients.
    On a mesh each rank encodes its `batch_rows(mesh, B)` rows, and over a
    "model" axis the cross K / V are this rank's KV heads: what its
    decode step (`make_decode_step`) takes."""
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)

    @torch.no_grad()
    def step(params, frames):
        mine = frames[batch_rows(wa, frames.shape[0])]
        with tensor_parallel(axis):
            return ED.precompute_cross_kv(params, ED.encode(
                params, mine, cfg), cfg)

    return step, dict(dim=param_count(cfg))


def make_step(cfg: ModelConfig, mesh, shape_name: str,
              shape: Dict) -> Tuple[Callable, Dict]:
    """The step of an input shape's kind (train, prefill or decode)."""
    if shape["kind"] == "train":
        return make_train_step(cfg, mesh, shape)
    if shape["kind"] == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    return make_decode_step(cfg, shape_name, mesh=mesh)

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
the reference.  Its combine is the backward itself (autograd and cuBLAS),
as the reference's is XLA's; the update of each leaf is the port's
`noisy_sgd` kernel, which draws the leaf's noise in registers from the
counter-based stream (`kernels/philox.py`) at the global indices of the
rank's part, as the reference's partitionable threefry draws it
shard-locally, and never stores it.  What
the backward recomputes rather than keeps is the config's, as in the
reference: under `cfg.remat` (the full configs) each super-block, tail
block and encoder-decoder block is recomputed from its input
(`models.common.recompute`, re-entering the step's "model" axis, storage
split and worker group, since the backward runs after their blocks have
closed), and whatever remat says each CE chunk (`transformer.chunked_ce`)
and each chunk of experts (`moe.moe_scan_dense`) is.  Under FSDP a
recomputed block gathers its layer again rather than keep the gathered
copy.  The step takes no argument for it.

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
the over-the-air sum.  Every rank draws the same gains and the same noise
values (each a function of the seed, the leaf and its global index) and
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
over it alone.  Where M does not divide a GQA layer's query heads
(starcoder2-3b's 24 and llama4's 40 at M = 16) the layer's wq / wk / wv
are split on d (or hd) and wo on hd (or d), as the reference's `_wspec`
falls back, and every rank computes every head (`models/attention.py`);
a leaf no dim of which M divides is replicated, and its gradient, whole
and the same on every rank, is summed over the workers only.  Each rank
draws only its part of each leaf's noise, at the part's indices in the
leaf's whole shape, so the draws are the one-process run's bit for bit;
the stale stats sum each split leaf's shards over the model group and
count a replicated leaf once.  Prefill and decode gather the vocab
shards of the logits over the model group, then the rows over the worker
group.

The residual stream between the layers of the train step and the
prefill is split over "model" on the sequence by default
(`constrain="sequence"`, the reference's `make_constrain`: [B, S, d] as
P(batch axes, "model", None)): each rank holds its S / M positions, so a
recomputed block keeps [B / U, S / M, d], and each layer gathers the
sequence where it enters its split and reduce-scatters it where it
leaves (`common.tensor_parallel(axis, sequence=True)`).
`constrain="batch_only"` keeps it replicated over "model", as the
reference's REPRO_PREFILL_CONSTRAIN=batch_only does (an argument here,
not a variable of the environment).  Where M does not divide the step's
sequence (a VLM's prefix plus its tokens, an encoder-decoder's frames or
tokens) a call runs "batch_only" (`residual_route` of its batch), and
meta["constrain"] is the route of a batch of the step's `shape`.  Under
the split a norm's scale meets only the rank's rows, so its gradient is
the rows' share: the train step sums those leaves over "model" once a
step (`launch.sharding.row_leaves`).  Decode splits nothing.

FSDP (`fsdp=True`, the default, as the reference's): on a mesh whose
"data" axis has R > 1 ranks the large leaves' storage is split over them
too (`launch.sharding.data_specs`, `meta["data_specs"]`: each leaf's
"data" dim or None), the params a step takes and returns are this rank's
parts of both dims, and each layer gathers its leaves over "data" where
it is used (`common.storage_sharded`).  The gather's backward sums a
data-sharded leaf's gradient over the "data" ranks (a reduce_scatter), so
the train step sums such a leaf only over "pod" after it, and every other
leaf over all the worker ranks, as before: each gradient is summed over
the workers once.  The stale stats sum each leaf's parts over the groups
that split it, the noise is drawn at the part's global indices on both
dims, and the update is the rank's part.  Prefill and decode gather exact
copies, so their logits equal the unsharded run's bit for bit.

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

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import attacks as ATK
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig, noise_std_for_snr
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.kernels import ops, philox
from repro_torch.launch.distributed import all_gather, all_reduce_sum
from repro_torch.launch.mesh import (data_axis, model_axis, pod_group,
                                     worker_axes)
from repro_torch.launch.sharding import (data_specs, init_params,
                                         init_shards, param_specs,
                                         row_leaves)
from repro_torch.models import attention as ATT
from repro_torch.models import encdec as ED
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, count_params,
                                       storage_sharded, tensor_parallel)
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

Tensor = torch.Tensor

# The gradients' all_reduce packs the leaves into flat buffers of at most
# this many bytes: a few calls a step (gloo pays per call), and one
# buffer's worth of memory beside the gradients.
BUCKET_BYTES = 256 * 2 ** 20
# Elements of a leaf the update computes at once (`_noisy_sgd`).
UPDATE_CHUNK = 2 ** 26


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator],
               device=None, mesh=None, fsdp: bool = True) -> Dict:
    """Random weights of cfg (`transformer.init_lm`, or
    `encdec.init_encdec` for the encoder-decoder, arch_type "audio"),
    drawn from the counter-based stream keyed by one int64 of `generator`;
    on a mesh with a "model" axis, or (fsdp) a "data" axis, this rank's
    shards of them (`launch.sharding.init_shards`: only the rank's part of
    each leaf is drawn, no whole leaf is formed): what the steps built with
    the same `fsdp` take."""
    return init_shards(cfg, generator, device, mesh, fsdp)


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


def _noisy_sgd(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
               alpha: float, z: Optional[Tensor] = None,
               draw: Optional[philox.Draw] = None) -> Tensor:
    """One leaf's update, p - alpha (g + shift + scale z): the bias `shift`
    and the noise added in g's dtype, the SGD step in f32 and cast to p's
    dtype; z drawn from the stream at the part's global indices (`draw`),
    given (`z`, the part's replayed draws) or none.  `ops.noisy_sgd`: on
    the card the CUDA kernel (z drawn in registers, never stored), on the
    CPU its plain version UPDATE_CHUNK elements at a time (the bits of one
    pass; the f32 transients of a stacked leaf stay a chunk's size)."""
    return ops.noisy_sgd(p.contiguous(), g.contiguous(), shift, scale,
                         alpha, z=z, draw=draw, chunk=UPDATE_CHUNK)


class _Storage:
    """A step's layout of the weights' storage over "data": the axis, each
    leaf's "data" dim (`launch.sharding.data_specs`, all None without
    FSDP) and each leaf's local shape, which `check` holds the params a
    step is given against."""

    def __init__(self, cfg: ModelConfig, mesh, specs: Dict, fsdp: bool):
        self.axis = data_axis(mesh)
        self.on = fsdp and self.axis.size > 1
        m = model_axis(mesh).size
        self.specs = (data_specs(cfg, m, self.axis.size) if self.on
                      else tree_map(lambda _: None, specs))
        self.split = tree_leaves(self.specs)
        full = tree_leaves(init_params(cfg, None, "meta")) if self.on else []
        self.shapes = {
            i: tuple(n // self.axis.size if j == d else n // m if j == dm
                     else n for j, n in enumerate(x.shape))
            for i, (x, dm, d) in enumerate(zip(full, tree_leaves(specs),
                                               self.split))
            if d is not None}

    def check(self, leaves) -> None:
        """Raise ValueError unless each data-sharded leaf has this rank's
        part's shape (whole weights given to an FSDP step)."""
        for i, want in self.shapes.items():
            if tuple(leaves[i].shape) != want:
                raise ValueError(
                    f"leaf {i} has shape {tuple(leaves[i].shape)}, not this "
                    f"rank's part {want} of its storage over the "
                    f"{self.axis.size} \"data\" ranks: pass the params of "
                    f"init_model(..., mesh=mesh) or shard_params(..., "
                    f"meta[\"data_specs\"]), or build the step with "
                    f"fsdp=False")

    def scope(self, params):
        """The `storage_sharded` block of a step's params (a tree, or its
        leaves); a no-op without FSDP."""
        if not self.on:
            return contextlib.nullcontext()
        leaves = tree_leaves(params) if isinstance(params, dict) else params
        self.check(leaves)
        return storage_sharded(self.axis, leaves, self.split)


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


def sum_leaves(grads: list, index: List[int], group) -> None:
    """The gradients grads[i], i in `index` (a list in the params' leaf
    order, replaced in place), summed over `group` (`_sum_over_workers`:
    in buckets, each unsummed gradient freed as its bucket fills)."""
    if not index:
        return
    part = [grads[i] for i in index]
    for i in index:
        grads[i] = None
    _sum_over_workers(part, group)
    for i, g in zip(index, part):
        grads[i] = g


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


CONSTRAINS = ("sequence", "batch_only")


def _sequences(cfg: ModelConfig, shapes: Dict, kind: str) -> Tuple[int, ...]:
    """The lengths of the residual streams a batch of these input shapes
    ({name: shape}) runs: the tokens (one fewer in training), after a
    VLM's prefix; an encoder-decoder's frames and tokens."""
    toks = shapes["tokens"][1] - (kind == "train")
    if cfg.arch_type == "vlm":
        return (shapes["embeds_prefix"][1] + toks,)
    if cfg.arch_type == "audio":
        return (shapes["frames"][1], toks)
    return (toks,)


def residual_route(constrain: str, cfg: ModelConfig, m: int,
                   shapes: Optional[Dict], kind: str) -> str:
    """The route of the residual stream over m "model" ranks for a batch
    of these input shapes ({name: shape}; None: no batch yet, the route
    asked for): "sequence" where it was asked for and m divides every
    stream's length (`_sequences`), else "batch_only"; ValueError for a
    constrain not in CONSTRAINS."""
    if constrain not in CONSTRAINS:
        raise ValueError(f"constrain={constrain!r}: not one of {CONSTRAINS}")
    if shapes is None or constrain == "batch_only":
        return constrain
    return ("sequence" if all(n % m == 0 for n in
                              _sequences(cfg, shapes, kind))
            else "batch_only")


def _splits(constrain, cfg, m, batch, kind) -> bool:
    """Whether a call of a step on this batch ({name: tensor}) splits the
    sequence (`residual_route` of its shapes)."""
    return residual_route(constrain, cfg, m, {
        k: tuple(v.shape) for k, v in batch.items()}, kind) == "sequence"


def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[Dict] = None, *,
                    policy: Policy = Policy.BEV, n_byzantine: int = 2,
                    alpha: float = 1e-3, use_floa: bool = True,
                    fsdp: bool = True, constrain: str = "sequence"
                    ) -> Tuple[Callable, Dict]:
    """The FLOA train step and its meta (dim, num_workers, policy, the
    batch's shapes, params_specs, data_specs, constrain):

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
    process, the mesh's one-process twin).  `seed` is a one-element
    integer tensor, as the reference passes `jnp.uint32(t)` (read on the
    device: the step never reads it on the host), or an int, which the
    step places on the params' device first.  The round's random draws
    may be an input: draws = {"h_abs": [U] Rayleigh gains, "z": one
    standard-normal f32 tensor per leaf, in the JAX package's leaf order
    (`repro_torch.tree`)}.  Without draws the gains come from the
    counter-based stream keyed by `seed` (`kernels/philox.py`,
    `philox.rayleigh_gains`: purpose GAINS, leaf 0, worker u at index u);
    without "z" leaf i's noise comes from the same stream (purpose NOISE,
    leaf i), drawn at this rank's part's global indices by the update
    itself, under the key the kernel reads from the seed tensor; every
    rank of a mesh takes the same draws.  The seeded route on one device
    reads no host value and, once the seed is a device tensor, copies
    nothing from the host (the coefficients' constants are placed on the
    device at the first call), so `launch/train.py` captures it as a CUDA
    graph and replays it (`graphs.StepGraph`); the route with replayed
    draws, and every mesh route (its collectives are gloo's, which a
    graph cannot capture), run eagerly.
    use_floa=False is the plain mean: s = 1/U, no bias, no noise, nothing
    drawn.  metrics: {"loss": the mean per-worker loss over all U,
    "grad_scale": sum(s) + bias_w}.  On a mesh with a "model" axis of
    M > 1 params are this rank's shards (`launch.sharding.shard_params`
    of meta["params_specs"]) and so are the new params; draws["z"] stays
    one full-shape tensor a leaf, of which each rank takes its part.
    With fsdp on a mesh of R > 1 "data" ranks the params are also split
    over "data" by meta["data_specs"] (`init_model(..., mesh=)`), and
    params of another layout raise ValueError.  constrain: "sequence"
    (the default) splits the residual stream over "model" on the
    sequence, "batch_only" keeps it replicated (the module docstring);
    meta["constrain"] is the route of a batch of `shape`'s shapes, and
    each call takes the route of its own batch.  Under "sequence" the
    gradients of the leaves applied to the residual's rows
    (`launch.sharding.row_leaves`: the norms' scales) are summed over
    "model" once, in buckets, after the backward."""
    shape = shape or dict(global_batch=256, seq_len=4096)
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    u, group = wa.num_workers, wa.group
    specs = param_specs(cfg, axis.size)
    split = tree_leaves(specs)   # each leaf's split dim, or None
    rowed = row_leaves(cfg, axis.size)
    store = _Storage(cfg, mesh, specs, fsdp)
    dsplit, pod = store.split, pod_group(mesh)
    dim = param_count(cfg)
    floa = default_floa(mesh, dim, policy=policy, n_byzantine=n_byzantine)
    channel, power, attack = floa["channel"], floa["power"], floa["attack"]
    noisy = use_floa and channel.noise_std > 0.0
    moe_coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    placed: Dict = {}   # the coefficients' constants, by device

    def constants(dev) -> Dict[str, Tensor]:
        if dev not in placed:
            placed[dev] = {**ATK.placed_constants(power, channel, attack,
                                                  dev),
                           "sigmas": channel.sigmas().to(dev)}
        return placed[dev]

    meta = dict(dim=dim, num_workers=u, policy=str(policy),
                batch=batch_shapes(cfg, shape, "train"),
                params_specs=specs, data_specs=store.specs)
    meta["constrain"] = residual_route(
        constrain, cfg, axis.size, {k: s for k, (s, _) in
                                    meta["batch"].items()}, "train")

    def weighted_loss(params, rows, coeffs, seq):
        # this process's rows; on a mesh the MoE aux is the global batch's
        with MOE.worker_batch(group), tensor_parallel(axis, seq):
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
        seq = _splits(constrain, cfg, axis.size, rows, "train")
        leaves_p, treedef = tree_flatten(params)
        dev = leaves_p[0].device
        gbar, eps2 = state["gbar"], state["eps2"]
        seed = philox.seed_tensor(seed, dev)
        if use_floa:
            const = constants(dev)
            if draws is None:   # the gains; the noise comes from the stream
                draws = {"h_abs": philox.rayleigh_gains(seed,
                                                        const["sigmas"])}
            s, bias_w = ATK.signed_coefficients(
                draws["h_abs"], power, channel, attack, gbar, eps2, const)
        else:
            s = torch.full((u,), 1.0 / u, device=dev)
            bias_w = torch.zeros((), device=dev)
        # one backward of the coefficient-weighted per-worker losses: its
        # gradient IS the over-the-air superposition sum_i s_i grad L_i
        # (on a mesh, of this rank's worker, then summed over the ranks)
        xs = [x.detach().requires_grad_(True) for x in leaves_p]
        with torch.enable_grad():
            with store.scope(xs):
                wl, per_worker = weighted_loss(tree_unflatten(treedef, xs),
                                               rows, s, seq)
            grads = list(torch.autograd.grad(wl, xs))
        if seq:   # each rank's rows' share of the norms' scales
            sum_leaves(grads, rowed, axis.group)
        if group is None:
            mean_loss = per_worker.mean()
        else:
            # a data-sharded leaf's gradient left the gather's backward
            # summed over "data": only "pod" is left to sum it over
            for sub, grp in ((_take(dsplit, False), group),
                             (_take(dsplit, True), pod)):
                if grp is not None:
                    sum_leaves(grads, sub, grp)
            mean_loss = all_reduce_sum(per_worker.detach().sum(), group) / u
        with torch.no_grad():
            # stale-stat estimators for the next round, off the noiseless
            # aggregate; every sum in f32
            ssum = torch.sum(s) + bias_w
            if axis.size == 1 and not store.on:
                s1 = sum(torch.sum(g, dtype=torch.float32) for g in grads)
                s2 = sum(torch.sum(torch.square(g.float())) for g in grads)
            else:   # each leaf's parts summed over the groups that split it
                s1, s2 = _split_stats(grads, split, axis.group, dsplit,
                                      store.axis.group)
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
            # f32; each gradient is dropped once applied.  The noise of
            # leaf i is the stream's (seed, leaf i) at this rank's part's
            # global indices, or the replayed draws' part
            scale = torch.sqrt(eps2) * channel.noise_std
            new_leaves = []
            for i, p in enumerate(leaves_p):
                g, grads[i] = grads[i], None
                z = draw = None
                if noisy:
                    part = philox.local_part(g.shape, (
                        (split[i], axis), (dsplit[i], store.axis)))
                    if "z" in draws:
                        z = draws["z"][i][part.slices].to(
                            device=dev, dtype=torch.float32).contiguous()
                    else:
                        draw = philox.Draw(seed, i, part)
                new_leaves.append(_noisy_sgd(
                    p, g, (bias_w * gbar).to(g.dtype), scale, alpha, z=z,
                    draw=draw))
                del g, z
        metrics = dict(loss=mean_loss.detach(), grad_scale=ssum)
        return tree_unflatten(treedef, new_leaves), new_state, metrics

    return train_step, meta


def _take(dsplit, sharded: bool) -> list:
    """The indices of the leaves that are (or are not) data-sharded."""
    return [i for i, d in enumerate(dsplit) if (d is not None) == sharded]


def _split_stats(grads, split, group, dsplit,
                 dgroup) -> Tuple[Tensor, Tensor]:
    """(sum g, sum g^2) over the whole model, f32, from this rank's
    gradient shards: the local sums of the leaves split over "model"
    (`split`) all_reduced over the model `group`, of those split over
    "data" (`dsplit`) over `dgroup` (of those split on both, over both),
    plus the replicated leaves' sums, counted once."""
    def sums(keep_m, keep_d):
        gs = [g for g, m, d in zip(grads, split, dsplit)
              if (m is not None) == keep_m and (d is not None) == keep_d]
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        return torch.stack([
            sum((torch.sum(g, dtype=torch.float32) for g in gs), zero),
            sum((torch.sum(torch.square(g.float())) for g in gs), zero)])
    if dgroup is None:
        s = all_reduce_sum(sums(True, False), group) + sums(False, False)
        return s[0], s[1]
    both, model_only = all_reduce_sum(torch.stack(
        [sums(True, True), sums(True, False)]), group)
    both, data_only = all_reduce_sum(torch.stack(
        [both, sums(False, True)]), dgroup)
    s = both + model_only + data_only + sums(False, False)
    return s[0], s[1]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[Dict] = None, *,
                      fsdp: bool = True, constrain: str = "sequence"
                      ) -> Tuple[Callable, Dict]:
    """The prefill (scoring) step: `step(params, batch) -> logits [B, Vp]`
    of the LAST position only (the full [B, S, vocab] logits are never
    formed), batch {"tokens": [B, S]} (and a VLM's "embeds_prefix", an
    encoder-decoder's "frames"), the global batch; no gradients.  The
    encoder-decoder encodes the frames and runs the decoder over the
    tokens.  On a mesh each rank scores its `batch_rows` and the logits
    are gathered, so every rank returns all B rows.  Over a "model" axis
    params are this rank's shards and the vocab shards of the logits are
    gathered; with fsdp over a "data" axis the params are also split by
    meta["data_specs"] (as `make_train_step`'s).  constrain as
    `make_train_step`'s (meta["constrain"] the route of a batch of
    `shape`'s shapes, or the one asked for without `shape`; each call
    takes its own batch's): under "sequence" the last position's hidden
    state comes from the last "model" rank (`transformer.last_hidden`)."""
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    store = _Storage(cfg, mesh, param_specs(cfg, axis.size), fsdp)
    meta = dict(dim=param_count(cfg), data_specs=store.specs)
    if shape is not None:
        meta["batch"] = batch_shapes(cfg, shape, "prefill")
    meta["constrain"] = residual_route(
        constrain, cfg, axis.size, None if shape is None else {
            k: s for k, (s, _) in meta["batch"].items()}, "prefill")

    @torch.no_grad()
    def prefill(params, batch):
        rows = batch_rows(wa, batch["tokens"].shape[0])
        split = rows.stop - rows.start < batch["tokens"].shape[0]
        mine = {k: v[rows] for k, v in batch.items()}
        seq = _splits(constrain, cfg, axis.size, mine, "prefill")
        with MOE.worker_batch(wa.group if split else None, aux=False), \
                tensor_parallel(axis, seq), store.scope(params):
            if cfg.arch_type == "audio":
                h = ED.decode_hidden(params, mine["tokens"], ED.encode(
                    params, mine["frames"], cfg), cfg)
            else:
                h, _ = T.hidden_for_batch(
                    params, mine["tokens"], cfg,
                    embeds_prefix=mine.get("embeds_prefix"))
            logits = T.logits_from_hidden(params, T.last_hidden(h), cfg)
        return all_gather(logits, wa.group) if split else logits

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
                     plain: bool = False, mesh=None, fsdp: bool = True
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
    caches its KV heads (`transformer.init_caches(..., model_parallel=M)`);
    with fsdp over a "data" axis the params are also split by
    meta["data_specs"] (as `make_train_step`'s)."""
    window = decode_window(cfg, shape_name)
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    store = _Storage(cfg, mesh, param_specs(cfg, axis.size), fsdp)
    meta = dict(dim=param_count(cfg), window=window, data_specs=store.specs)
    if cfg.arch_type == "audio":
        def encdec_step(params, caches, cross_kv, tokens1, pos):
            rows = batch_rows(wa, tokens1.shape[0])
            with tensor_parallel(axis), store.scope(params):
                logits, caches = ED.decode_step(params, caches, cross_kv,
                                                tokens1[rows], pos, cfg,
                                                plain=plain)
            if rows.stop - rows.start == tokens1.shape[0]:
                return logits, caches
            return all_gather(logits, wa.group), caches

        return encdec_step, meta

    def step(params, caches, tokens1, pos):
        rows = batch_rows(wa, tokens1.shape[0])
        with tensor_parallel(axis), store.scope(params):
            if rows.stop - rows.start == tokens1.shape[0]:
                return T.decode_step(params, caches, tokens1, pos, cfg,
                                     window=window, plain=plain)
            with MOE.worker_batch(wa.group, aux=False):
                logits, caches = T.decode_step(params, caches, tokens1[rows],
                                               pos, cfg, window=window,
                                               plain=plain)
        return all_gather(logits, wa.group), caches

    return step, meta


def make_cross_kv_step(cfg: ModelConfig, mesh=None, *,
                       fsdp: bool = True) -> Tuple[Callable, Dict]:
    """The encoder-decoder's encoder for decoding: `step(params, frames) ->
    cross_kv`, frames [B, T, feat] the global batch; `encdec.encode`, then
    `encdec.precompute_cross_kv` ([L, B, T, KV, hd] x 2), no gradients.
    On a mesh each rank encodes its `batch_rows(mesh, B)` rows, and over a
    "model" axis the cross K / V are this rank's KV heads: what its
    decode step (`make_decode_step`) takes; with fsdp the params are
    split over "data" as the other steps' are."""
    wa = worker_axes(mesh)
    axis = model_axis(mesh)
    ATT.check_heads(cfg, axis.size)
    store = _Storage(cfg, mesh, param_specs(cfg, axis.size), fsdp)

    @torch.no_grad()
    def step(params, frames):
        mine = frames[batch_rows(wa, frames.shape[0])]
        with tensor_parallel(axis), store.scope(params):
            return ED.precompute_cross_kv(params, ED.encode(
                params, mine, cfg), cfg)

    return step, dict(dim=param_count(cfg), data_specs=store.specs)


def make_step(cfg: ModelConfig, mesh, shape_name: str, shape: Dict,
              constrain: str = "sequence") -> Tuple[Callable, Dict]:
    """The step of an input shape's kind (train, prefill or decode); the
    train and prefill steps take `constrain`, decode splits nothing."""
    if shape["kind"] == "train":
        return make_train_step(cfg, mesh, shape, constrain=constrain)
    if shape["kind"] == "prefill":
        return make_prefill_step(cfg, mesh, shape, constrain=constrain)
    return make_decode_step(cfg, shape_name, mesh=mesh)

"""Multi-scenario sweep engine: S scenarios x R rounds.

The paper's experimental section (Figs. 1-4) is a grid of scenarios — power
policy x attack x attacker count x learning rate — and the JAX package runs
each figure as one `SweepEngine` call (`repro/fl/sweep.py`).  This is its
port, under every `ExecutionPlan` (fl/plan.py), on one device or sharded
over the ranks of a process group (below).  One round of an all-analog
sweep on flat [S, D] state (every figure, the default plan):

  1. per-worker gradients as one [S, U, D] slab (nested torch.func.vmap of
     torch.func.grad over lanes and workers);
  2. the eq. 3 stats off the slab (one `grad_stats` kernel launch);
  3. Rayleigh gains, 4. power/attack coefficients (core.scenario);
  5. a receiver-noise row;
  6. the fused OTA combine + PS update of eq. 7 + eq. 8 (one
     `floa_step_batched` kernel launch).  Sweeps with a GAUSSIAN-jamming
     or a COLLUDING / OMNISCIENT lane take the combine-only kernel
     (`floa_aggregate_batched`), add the jamming row and the cohort's
     direction, then update — as the JAX engine does.

Digital lanes (a `DefenseSpec` other than "floa") take the grouped
dispatch by default: the lanes are partitioned by defense code
(`scenario.build_lane_groups`), and each round computes one [S, U, D]
gradient slab in that group order, then runs each group on its own
sub-slab, in ascending code order:

  - the analog group: steps 2-6 above on its own rows only (so
    `grad_stats` sees the [S_a*U, D] analog rows, and an all-digital sweep
    launches no FLOA kernel and no `grad_stats`);
  - each digital group: its Byzantine rows sign-flipped (`_digital_flip`),
    the family's kernel (core/defenses.py; median and trimmed mean sort
    through the CUDA sort kernels, one launch per group), then
    w - alpha * gagg.

The groups' rows concatenate, and `run` hands the results back in lane
order (`LaneGroups.inverse`).  grouped_dispatch=False is the reference's
per-lane switch: the analog step runs over all S lanes (the combine-only
route), every family present runs once over all S lanes
(`defenses.make_flat_defense_selector`), and a per-lane select keeps each
lane's own aggregate.  flat_state=False keeps params as a dict of [S, ...]
leaves (the tree-state reference).  The other knobs — strict_numerics,
chunk_rounds, async_staging, checkpoint_dir — and their contracts are in
the `SweepEngine` docstring.

The adaptive-adversary axes, each gated by the spec so that sweeps without
it run exactly as before:

  - Gauss-Markov fading (`markov_rho > 0`, `any_markov`): a [S, U, 2]
    complex-gain state carried across rounds; rho > 0 lanes take |h| off
    it, rho = 0 lanes keep the i.i.d. draw.
  - K-of-U participation (`participants`, `any_partial`): a [S, U] mask
    per round; the analog stats average the participants only
    (`masked_global_stats`), non-participants drop out of the
    coefficients, and every digital defense runs its masked twin (median
    and trimmed mean sort +inf-padded columns through the same kernels).
  - COLLUDING / OMNISCIENT cohorts (`any_directional`): after the combine
    the lane adds its cohort's received weight times a shared direction,
    a unit-RMS random row (COLLUDING) or the mean of the honest
    participating rows (OMNISCIENT).

The reported loss is the loss of the UPDATED weights on the round's batch,
and the grad norm is that of the aggregate, as in the JAX engine.  Eval
runs on rounds with t % eval_every == 0 and on the last round, NaN
elsewhere.

Compiled execution.  The JAX engine runs a chunk of rounds as one
`lax.scan`; on one device the port captures one round of the flat-state
plan as a CUDA graph (`graphs.StepGraph`) and replays it over each
staged block's rows: the draws (from the lanes' generators, registered
with the graph, or a caller's copied in), the per-worker gradients, the
stats, the coefficients, the fused step or the combine, the loss and the
grad norm, with the state and the Markov gains written in place in the
graph's buffers.  Between replays, in Python: the eval on due rounds,
Markov's first round (it draws the initial gains), the checkpoints (the
generators' states after the replays are an eager run's) and the staging
between blocks.  One graph a round rather than a chunk keeps those
between rounds and the last short chunk on the same graph.  Sharded runs
(gloo collectives) and the tree-state plan run the rounds eagerly, and so
does every run inside `graphs.disable_graphs()`; graphed equals eager
bitwise.

Random draws.  JAX's threefry and PyTorch's Philox cannot give the same
numbers, so a round takes its draws as inputs: `run(..., draws=fn)` with
fn(t) -> a dict keyed by lane ([S, ...] in spec order):

  "h_abs"  [S, U]     Rayleigh gains (every round)
  "z"      [S, D]     standard normal noise rows, or None (`analog_noise`)
  "jam"    [S, D]     standard normal jamming rows, or None
                      (`analog_jamming`)
  "part"   [S, U]     bool participation masks (`any_partial`)
  "h_init" [S, U, 2]  standard normals of the initial complex gains (round
                      0 only, `any_markov`)
  "markov" [S, U, 2]  standard normals of the fading innovations
                      (`any_markov`)
  "dir"    [S, D]     standard normal colluding directions
                      (`any_directional`)

The engine scales them (noise std, sigma, unit RMS).  By default each lane
draws from its own torch.Generators on the engine's device, one per stream,
seeded from ScenarioCase.seed and the stream's slot (0 gains, 1 noise, 2
jamming, 3 direction, 4 fading, 5 participation, 7 initial gains: the JAX
engine's split slots and fold_in constants), so a lane's stream depends
only on its own seed, and a new axis leaves the older streams unchanged.
Digital lanes do not consume their channel draws.

Sharding (`plan.mesh`, a `launch.mesh.SweepMesh` over the ranks of a
`torch.distributed` process group, one rank a device).  Every rank runs the
same `run` and returns the same full SweepResult.  The mesh's axes:

  - "data" shards the lanes: S is ghost-padded to a multiple of the data
    shards (`scenario.pad_lanes`, or per family under the grouped dispatch,
    `build_lane_groups(codes, shards)`), each rank runs its block of lanes,
    and the results are gathered, ghosts dropped.  A ghost replicates a
    real lane, seed included, and runs a real, discarded scenario.
  - "workers" shards the [S, U, D] slab's worker axis (`_WorkerShards`).
  - "model" shards the flat state's D axis (`_ModelShards`).

The draws are the unsharded engine's: every lane draws from its own seed on
whichever rank runs it, at the full U and the full real D; a caller's
`draws(t)` gives full-S rows, of which each rank takes its own.  The
collectives are the reference's: all_reduce (its psum), all_gather, and a
broadcast of the resume step.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap

from repro_torch import graphs
from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.core import channel as CH
from repro_torch.core import defenses as DEF
from repro_torch.core import scenario as SC
from repro_torch.core import standardize as S
from repro_torch.core.aggregation import (
    FLOAConfig,
    batched_floa_combine,
    batched_floa_step,
    flatten_worker_grads,
    per_worker_grads,
)
from repro_torch.core.attacks import DIRECTIONAL_ATTACKS, AttackType
from repro_torch.core.power_control import Policy
from repro_torch.data.pipeline import iter_chunk_blocks
from repro_torch.device import resolve_device
from repro_torch.fl.plan import ExecutionPlan
from repro_torch.launch import distributed as DIST
from repro_torch.launch.mesh import SweepMesh
from repro_torch.launch.staging import BlockStager
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Tensor = torch.Tensor

# The resume manifest's layout version and the port's draw scheme: a
# checkpoint carries the state of every lane's and stream's generator, not
# the JAX engine's keys, so the two engines refuse each other's checkpoints.
_RESUME_VERSION = 1
_SEEDED_DRAWS = "repro_torch seeded_draws: a torch.Generator a lane and stream"
_CALLER_DRAWS = "caller draws(t)"

# Marks a legacy per-knob kwarg the caller did not pass.
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class ScenarioCase:
    """One lane of the sweep: a frozen FLOAConfig plus its lr and seed.

    defense selects the lane's aggregation rule: the analog FLOA combine
    (the default), or a digital screening defense applied to the gathered
    [U, D] gradient slab, with digital attackers reporting sign-flipped
    gradients.  participants is K of K-of-U client sampling: each round
    the lane draws K participants (non-participants transmit nothing, and
    digital defenses screen the K rows only); None is full participation
    with no masking at all, while participants=U runs the masked path."""

    name: str
    floa: FLOAConfig
    alpha: float
    seed: int = 0
    defense: SC.DefenseSpec = dataclasses.field(
        default_factory=SC.DefenseSpec)
    participants: Optional[int] = None


def _check_participants(c: ScenarioCase, u: int) -> None:
    """K-of-U bounds of one lane: 1 <= K <= U, and its digital defense's
    bounds must hold for the K rows it screens each round."""
    k, d = c.participants, c.defense
    if not 1 <= k <= u:
        raise ValueError(f"lane {c.name!r}: participants={k} invalid for "
                         f"U={u}: need 1 <= K <= U")
    if d.name == "trimmed_mean" and not 2 * d.trim < k:
        raise ValueError(f"lane {c.name!r}: trimmed_mean trim={d.trim} "
                         f"invalid for K={k} participants: need 2*trim < K")
    if d.name in ("krum", "multi_krum"):
        if d.num_byzantine > k - 3:
            raise ValueError(
                f"lane {c.name!r}: krum num_byzantine={d.num_byzantine} "
                f"invalid for K={k} participants: need f <= K - 3")
        if d.multi > k:
            raise ValueError(
                f"lane {c.name!r}: krum multi={d.multi} invalid for K={k} "
                f"participants: need multi <= K")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """An ordered set of scenarios destined for one sweep."""

    cases: Tuple[ScenarioCase, ...]

    @classmethod
    def build(cls, cases: Sequence) -> "SweepSpec":
        """Accepts ScenarioCase instances or (name, floa, alpha[, seed]) tuples."""
        return cls(cases=tuple(c if isinstance(c, ScenarioCase)
                               else ScenarioCase(*c) for c in cases))

    def __post_init__(self):
        if not self.cases:
            raise ValueError("empty sweep")
        u = self.cases[0].floa.num_workers
        for c in self.cases:
            c.floa.validate()
            if c.floa.num_workers != u:
                raise ValueError("sweep scenarios must share U")
            if not isinstance(c.defense, SC.DefenseSpec):
                raise TypeError(f"lane {c.name!r}: defense must be a "
                                f"DefenseSpec, got {c.defense!r}")
            c.defense.validate(u)
            if c.participants is not None:
                _check_participants(c, u)
        gm_iters = {c.defense.gm_iters for c in self.cases
                    if c.defense.name == "geometric_median"}
        if len(gm_iters) > 1:
            raise ValueError(
                "geometric_median lanes must share gm_iters (one Weiszfeld "
                f"depth per lane group); got {sorted(gm_iters)}")

    def __len__(self) -> int:
        return len(self.cases)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.cases)

    @property
    def num_workers(self) -> int:
        return self.cases[0].floa.num_workers

    def stacked_params(self, device=None) -> SC.ScenarioParams:
        """Frozen dataclass configs -> stacked tensors, [S, ...]."""
        return SC.stack([SC.from_floa(c.floa, c.alpha, c.defense,
                                      participants=c.participants)
                         for c in self.cases], device=device)

    # Defense-code lane axis: a sweep with no digital lane takes the
    # all-analog round; any digital lane takes the grouped dispatch.
    @property
    def any_digital(self) -> bool:
        return any(c.defense.is_digital for c in self.cases)

    @property
    def all_digital(self) -> bool:
        return all(c.defense.is_digital for c in self.cases)

    @property
    def digital_codes(self) -> Tuple[int, ...]:
        return tuple(sorted({c.defense.code for c in self.cases
                             if c.defense.is_digital}))

    @property
    def lane_codes(self) -> Tuple[int, ...]:
        """Per-lane defense codes in lane order: the grouped partition's
        input."""
        return tuple(c.defense.code for c in self.cases)

    # The draws the lanes consume (the grouped engine's trace gates): only
    # analog lanes take noise and jamming rows (a digital lane's channel
    # config is never used).
    @property
    def analog_noise(self) -> bool:
        return any(c.floa.channel.noise_std > 0.0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def analog_jamming(self) -> bool:
        return any(c.floa.attack.attack == AttackType.GAUSSIAN
                   and c.floa.attack.num_attackers > 0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def gm_iters(self) -> int:
        its = {c.defense.gm_iters for c in self.cases
               if c.defense.name == "geometric_median"}
        return its.pop() if its else 8

    # The adaptive-adversary gates: each is False for every lane without
    # the axis, so such sweeps draw and run exactly what they did before.
    @property
    def any_markov(self) -> bool:
        """Gauss-Markov fading consumers: rho > 0 on an analog, non-EF lane
        (digital lanes ignore the channel; EF ignores |h|)."""
        return any(c.floa.channel.markov_rho > 0.0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)

    @property
    def any_partial(self) -> bool:
        """K-of-U participation on any lane (participants=U counts: it runs
        the masked path)."""
        return any(c.participants is not None for c in self.cases)

    @property
    def any_directional(self) -> bool:
        """COLLUDING / OMNISCIENT cohorts with a member, on an analog non-EF
        lane: gates the direction added after the combine."""
        return any(c.floa.attack.attack in DIRECTIONAL_ATTACKS
                   and c.floa.attack.num_attackers > 0
                   and c.floa.power.policy != Policy.EF
                   and not c.defense.is_digital for c in self.cases)


@dataclasses.dataclass
class SweepResult:
    """Per-scenario, per-round trajectories ([S, R] numpy arrays)."""

    names: Tuple[str, ...]
    params: Dict[str, object]       # final params (nested), leaves [S, ...]
    loss: np.ndarray                # [S, R]
    grad_norm: np.ndarray           # [S, R]
    metrics: Dict[str, np.ndarray]  # each [S, R]

    def index(self, name: str) -> int:
        return self.names.index(name)

    def save(self, path: str) -> str:
        """Write to <path>.npz + <path>.meta.json in the checkpoint tree
        format (`repro_torch.checkpoint.write_tree`, atomic): every params
        leaf, the [S, R] trajectories and each metric as exact arrays, the
        lane names in the manifest's `extra`, as the JAX package's
        `SweepResult.save` writes them (each package loads the other's).
        Returns the payload path."""
        tree = {"params": self.params, "loss": self.loss,
                "grad_norm": self.grad_norm, "metrics": dict(self.metrics)}
        return CKPT.write_tree(path, tree, extra={
            "kind": "SweepResult", "version": 1, "names": list(self.names)})

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        """Inverse of `save`: byte-exact arrays (params as CPU tensors in
        their nested dicts, trajectories and metrics as numpy arrays),
        names, metrics.  A file that is not a saved SweepResult raises
        ValueError."""
        tree, meta = CKPT.read_tree(path)
        kind = meta.get("extra", {}).get("kind")
        if kind != "SweepResult":
            raise ValueError(f"{path!r} is not a saved SweepResult "
                             f"(manifest extra.kind={kind!r})")
        return cls(names=tuple(meta["extra"]["names"]),
                   params=dict(tree["params"]), loss=tree["loss"].numpy(),
                   grad_norm=tree["grad_norm"].numpy(),
                   metrics={k: v.numpy()
                            for k, v in tree.get("metrics", {}).items()})

    def logs(self, name_or_idx, eval_every: int = 1) -> list:
        """RoundLog list of one lane, on the `FLTrainer.run(eval_every=...)`
        schedule (t % eval_every == 0 and the last round), for the figure
        CSV writers.  Pass the engine's own eval_every: rounds it did not
        evaluate carry NaN accuracy."""
        from repro_torch.fl.trainer import RoundLog
        i = (name_or_idx if isinstance(name_or_idx, int)
             else self.index(name_or_idx))
        rounds = self.loss.shape[1]
        acc = self.metrics.get("accuracy")
        return [RoundLog(step=t, loss=float(self.loss[i, t]),
                         accuracy=(float(acc[i, t]) if acc is not None
                                   else float("nan")),
                         grad_norm=float(self.grad_norm[i, t]))
                for t in range(rounds)
                if eval_every and (t % eval_every == 0 or t == rounds - 1)]


def stack_params(params, num: int):
    """Broadcast one init tree to a stacked [S, ...] scenario axis."""
    return tree_map(lambda v: v[None].expand(num, *v.shape), params)


def make_row_unflatten(template):
    """[..., D] flat rows -> params tree (nested dicts), as VIEWS of the row
    (so gradients taken with respect to the row reach every leaf).

    Leaves are laid out in the JAX package's flat order
    (`jax.tree_util.tree_flatten` sorts dict keys at every level,
    `repro_torch.tree`): b1 | b2 | w1 | w2 for the paper MLP.  Returns
    (unflatten_row, sizes), sizes in that order."""
    leaves, treedef = tree_flatten(template)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = tuple(math.prod(s) for s in shapes)

    def unflatten_row(w: Tensor):
        out, off = [], 0
        for shape, n in zip(shapes, sizes):
            out.append(w[..., off:off + n].reshape(*w.shape[:-1], *shape))
            off += n
        return tree_unflatten(treedef, out)

    return unflatten_row, sizes


def _digital_flip(flat: Tensor, sp: SC.ScenarioParams) -> Tensor:
    """Digital attackers report -g (there is no channel to cheat on):
    sign-flip the Byzantine rows of a lane group's [S_g, U, D] slab."""
    flip = (sp.attack != 0)[:, None] & sp.byz_mask
    sign = torch.where(flip, -1.0, 1.0)
    return flat * sign[:, :, None]


def lane_generator(seed: int, slot: int, device) -> torch.Generator:
    """The generator of stream `slot` (`SweepEngine._SLOTS`) of a lane
    seeded `seed`: the engine's default draws and the trainer's."""
    state = np.random.SeedSequence([seed, slot]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


# The "model" axis pads D to a multiple of model_shards * COL_ALIGN columns:
# the widest load of the FLOA kernels on the f32 flat state, one 16-byte
# vector of 4 columns (kernels/floa_aggregate.py::vector_width), so each
# rank's column block keeps the kernels' widest loads.
COL_ALIGN = 16 // 4


class _WorkerShards:
    """The "workers" axis: each rank computes the gradients of its own
    u_loc = ceil(U / W) workers.  U is ghost-padded to u_pad = W * u_loc:
    a ghost worker replicates worker U-1's batch rows (finite gradients)
    and gets a zero combine coefficient, so it adds exactly nothing, and
    its stats are sliced away after the gather.  Gains, coefficients and
    noise are drawn at the full U on every rank, as unsharded."""

    def __init__(self, u: int, shards: int, index: int, group):
        self.u, self.shards, self.index, self.group = u, shards, index, group
        self.u_loc = -(-u // shards)
        self.u_pad = self.u_loc * shards

    def local_batch(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """[U*b, ...] rows of the round's batch -> this rank's workers'
        [u_loc*b, ...] (global worker indices clipped to U-1)."""
        x0 = next(iter(batch.values()))
        b, dev = x0.shape[0] // self.u, x0.device
        gi = torch.clamp(self.index * self.u_loc
                         + torch.arange(self.u_loc, device=dev),
                         max=self.u - 1)
        rows = (gi[:, None] * b + torch.arange(b, device=dev)).reshape(-1)
        return {k: v[rows] for k, v in batch.items()}

    def gather_slab(self, x: Tensor) -> Tensor:
        """[S, u_loc, D] -> the full [S, U, D] slab (the digital screens
        are order statistics over every worker)."""
        return DIST.all_gather(x, self.group, dim=1)[:, :self.u].contiguous()

    def gather_stats(self, gbar_i: Tensor, eps2_i: Tensor):
        """Per-worker stats [S, u_loc] -> [S, U]: the global mean then
        reduces the unsharded engine's [S, U] vector."""
        return tuple(DIST.all_gather(x, self.group, dim=1)[:, :self.u]
                     for x in (gbar_i, eps2_i))

    def local_coeff(self, coeff: Tensor) -> Tensor:
        """[S, U] coefficients -> this rank's [S, u_loc], ghosts zero."""
        coeff = F.pad(coeff, (0, self.u_pad - self.u))
        lo = self.index * self.u_loc
        return coeff[:, lo:lo + self.u_loc]

    def psum(self, x: Tensor) -> Tensor:
        return DIST.all_reduce_sum(x, self.group)

    def psum_combine(self, coeff, flat_loc, noise_row, bias_row, eps):
        """The OTA superposition as a sum over worker shards: each rank's
        weighted sum of its own workers' rows (an einsum outside any
        kernel, as the reference's), the all_reduce, then the bias and the
        receiver noise once."""
        part = torch.einsum("su,sud->sd", self.local_coeff(coeff), flat_loc)
        return (self.psum(part) + bias_row[:, None]
                + eps[:, None] * noise_row)


class _ModelShards:
    """The "model" axis: each rank holds a block of d_loc columns of the
    flat state.  D is zero-padded to d_pad = M * d_loc, d_loc a multiple of
    COL_ALIGN; the ghost columns stay exact zeros (the loss reads the D
    real columns only, and every aggregate is masked there), and are
    sliced away at the end.  [D]-shaped draws happen at the full real D on
    every rank, then are sliced."""

    def __init__(self, d: int, shards: int, index: int, group):
        self.d, self.shards, self.index, self.group = d, shards, index, group
        chunk = shards * COL_ALIGN
        self.d_pad = -(-d // chunk) * chunk
        self.d_loc = self.d_pad // shards
        self.lo = index * self.d_loc

    def local_cols(self, x: Tensor) -> Tensor:
        """[..., D or d_pad] -> this rank's [..., d_loc] block, contiguous
        (the real-D tail zero-padded first)."""
        if x.shape[-1] != self.d_pad:
            x = F.pad(x, (0, self.d_pad - x.shape[-1]))
        return x[..., self.lo:self.lo + self.d_loc].contiguous()

    def gather_cols(self, x: Tensor) -> Tensor:
        """[..., d_loc] blocks of every rank -> [..., D] real columns."""
        full = DIST.all_gather(x, self.group, dim=x.dim() - 1)
        return full[..., :self.d].contiguous()

    def col_mask(self, device) -> Tensor:
        """[d_loc] bool, True on this rank's real columns."""
        return self.lo + torch.arange(self.d_loc, device=device) < self.d

    def mask(self, x: Tensor) -> Tensor:
        """x with its ghost columns zeroed (a bitwise identity on the real
        ones)."""
        return torch.where(self.col_mask(x.device), x, 0.0)

    def psum(self, x: Tensor) -> Tensor:
        return DIST.all_reduce_sum(x, self.group)


def _plan_from(plan: Optional[ExecutionPlan], legacy: dict,
               caller: str) -> ExecutionPlan:
    """The plan of a call: `plan`, or the deprecated per-knob kwargs the
    caller passed (a DeprecationWarning), or the default; both raise."""
    knobs = ", ".join(legacy)
    legacy = {k: v for k, v in legacy.items() if v is not _UNSET}
    if plan is not None and not isinstance(plan, ExecutionPlan):
        raise TypeError(f"plan must be a repro_torch.fl.ExecutionPlan, got "
                        f"{type(plan).__name__}")
    if not legacy:
        return plan or ExecutionPlan()
    if plan is not None:
        raise ValueError(
            f"pass the execution strategy as plan=ExecutionPlan(...) OR as "
            f"the legacy per-knob kwargs, not both (got plan and "
            f"{sorted(legacy)})")
    warnings.warn(
        f"{caller}'s per-knob execution kwargs ({knobs}) are deprecated; "
        f"pass plan=ExecutionPlan(...) instead",
        DeprecationWarning, stacklevel=3)
    return ExecutionPlan(**legacy)


class _SeededDraws:
    """The default draw provider (`SweepEngine.seeded_draws`): per lane and
    per stream one generator on the engine's device, seeded from the lane's
    seed and the stream's slot (`SweepEngine._SLOTS`) alone, for the rows
    this rank executes (`SweepEngine._rows`: its lanes in execution order,
    ghosts included), which it returns.  Call it once per round, in round
    order.  `state()` / `load_state()` carry every generator's state
    (uint8, [rows, n] a stream) through a checkpoint."""

    def __init__(self, engine: "SweepEngine", d: int):
        self.engine, self.d = engine, d
        dev, cases = engine.device, engine.spec.cases
        keys = ["h_abs"] + [k for k, on in (
            ("z", engine._noise), ("jam", engine._jam),
            ("part", engine._partial), ("h_init", engine._markov),
            ("markov", engine._markov), ("dir", engine._dir)) if on]
        self.gens = {k: [lane_generator(cases[i].seed, engine._SLOTS[k], dev)
                         for i in engine._rows] for k in keys}

    def __call__(self, t: int) -> Dict[str, Optional[Tensor]]:
        eng, dev = self.engine, self.engine.device
        sp = eng._sp_exec
        want = eng._wanted_draws(len(eng._rows), self.d, t)
        out = {"h_abs": SC.sample_gains(self.gens["h_abs"], sp),
               "z": None, "jam": None}
        for key, (shape, _) in want.items():
            if key == "part":
                scores = torch.stack([torch.rand(eng._u, generator=g,
                                                 device=dev)
                                      for g in self.gens[key]])
                out[key] = SC.participation_mask(scores, sp.part_k)
            elif key != "h_abs":
                out[key] = torch.stack([
                    torch.randn(shape[1:], generator=g, device=dev)
                    for g in self.gens[key]])
        return out

    def state(self) -> Dict[str, Tensor]:
        return {k: torch.stack([g.get_state() for g in gens])
                for k, gens in self.gens.items()}

    def load_state(self, states: Dict[str, Tensor]) -> None:
        if set(states) != set(self.gens):
            raise ValueError(f"checkpoint generator streams {sorted(states)}"
                             f" differ from this run's {sorted(self.gens)}")
        for k, gens in self.gens.items():
            for g, st in zip(gens, states[k]):
                g.set_state(st.clone())   # its own storage, offset 0


class _Trajectory:
    """Per-round loss, grad norm and evals in execution order: the rows
    restored from a checkpoint (host arrays) and the rows of this run
    (device tensors, fetched only at a checkpoint or at the end)."""

    def __init__(self, num: int, prior: Optional[dict] = None):
        self.num = num
        self.prior = prior or {
            "loss": np.zeros((0, num), np.float32),
            "grad_norm": np.zeros((0, num), np.float32), "metrics": {}}
        self.loss: List[Tensor] = []
        self.gn: List[Tensor] = []
        self.evals: List[Optional[Dict[str, Tensor]]] = []

    def add(self, loss: Tensor, gn: Tensor, ev) -> None:
        self.loss.append(loss)
        self.gn.append(gn)
        self.evals.append(ev)

    def host(self, keys=None) -> dict:
        """{"loss", "grad_norm": [T, S], "metrics": {k: [T, S]}} over every
        round so far; rounds without an eval carry NaN.  `keys` names the
        metrics when no eval has run (the zero-round run)."""
        def rows(prior, new):
            if not new:
                return prior
            return np.concatenate([prior, torch.stack(new).cpu().numpy()])

        keys = next((e.keys() for e in self.evals if e is not None),
                    keys if keys is not None else self.prior["metrics"])
        t_prior = len(self.prior["loss"])
        metrics = {}
        for k in keys:
            prior = self.prior["metrics"].get(k)
            if prior is None:
                prior = np.full((t_prior, self.num), np.nan, np.float32)
            nan = np.full((self.num,), np.nan, np.float32)
            new = [nan if e is None else e[k].cpu().numpy()
                   for e in self.evals]
            metrics[k] = (np.concatenate([prior, np.stack(new)]) if new
                          else prior)
        return {"loss": rows(self.prior["loss"], self.loss),
                "grad_norm": rows(self.prior["grad_norm"], self.gn),
                "metrics": metrics}


class SweepEngine:
    """The sweep of one (loss_fn, spec, eval_fn) triple under one
    `ExecutionPlan`.

    loss_fn(params_dict, batch) -> scalar; eval_fn(params_dict) -> dict of
    scalars.  device defaults to 'cuda' and raises without a card.
    force_plain=True sends every kernel wrapper to its plain PyTorch version
    even on the card; it exists so a test can hold the kernel route against
    the plain one from the same draws, and the figures never set it.

    Every plan knob changes HOW the sweep executes, never WHAT it computes.
    On the card, the flat state on one device replays its round as a
    CUDA graph (module docstring: what stays between replays; the mesh
    routes and the tree state run eagerly, as every route does inside
    `graphs.disable_graphs()`).

    The contracts, as the reference's (`repro/fl/sweep.py`), within the port
    and from the same draws:

    flat_state=True (default) keeps params as one [S, D] f32 matrix, with
    the combine and the PS update fused (`batched_floa_step`).
    flat_state=False is the tree-state reference: params a dict of [S, ...]
    leaves, each round pays the flatten/concat of the gradients and a
    per-leaf update, the stats are per leaf by default
    (`per_worker_scalar_stats`), and the combine takes the two-step route
    (`batched_floa_combine`, then the update); non-f32 leaves round-trip
    through f32, as the gradients' flatten makes them.  The two agree to fp
    rounding (rtol ~1e-5), bitwise when BOTH engines run strict_numerics.

    strict_numerics=True takes the stats per leaf segment of the slab (the
    fixed-order route of the `grad_stats` kernel, one launch a segment,
    summed in leaf order), so the stats' reduction no longer depends on
    where a lane's rows sit or how many rows a launch takes, and gives each
    worker its own matmuls in the gradients (`per_worker_grads(...,
    fixed_shapes=True)`), so a worker's gradient does not depend on how many
    workers one call takes: every strategy — tree vs flat state, grouped vs
    switch dispatch, chunked vs monolithic, sharded vs not — replays the
    same trajectory bitwise.

    grouped_dispatch=True (default) runs each defense family once over its
    own lanes (module docstring); False is the per-lane switch reference:
    the analog step over all S lanes, every family present over all S
    lanes, and a per-lane select.  Pure-FLOA sweeps ignore the flag.  The
    two agree at rtol 1e-6 (the per-lane math is shared; reductions over
    differently sized batches may round differently on the card).

    chunk_rounds=C runs the rounds in ceil(R/C) blocks (the last one short
    when C does not divide R), carrying (w, h, the generators' states, t)
    across the boundaries; the batch stack stays on the host and only
    [C, ...] blocks reach the device; the eval schedule stays anchored to
    the absolute round.  Chunked == monolithic bitwise: every round runs
    the same operations on the same bytes.  The rounds of a chunk replay
    one captured round (module docstring); a chunk boundary stages the
    next block between replays.

    async_staging=True (requires chunk_rounds) stages block k+1 through
    pinned host buffers on a side stream while chunk k's rounds are
    enqueued (`launch.staging.BlockStager`).  A pure scheduling change:
    bitwise equal to async_staging=False.

    checkpoint_dir (requires chunk_rounds) writes the resume carry with
    `checkpoint.save_pytree` after every checkpoint_every_chunks-th chunk
    boundary (never the final one): the execution-order state (w or the
    params leaves, and h under Markov fading), the trajectory rows so far,
    and, under the default seeded draws, the state of every lane's and
    stream's torch.Generator (the port's streams are sequential; the
    reference carries its keys instead).  `run(..., resume=True)` restores
    the latest committed checkpoint, checks its manifest against this run
    (rounds, chunking, lanes, eval schedule, state representation, draw
    scheme) and runs the remaining chunks: resumed == uninterrupted
    bitwise.  A caller's `draws(t)` is addressed by the absolute round, so
    it carries no state.  A failed write raises out of `run`.

    mesh (a `launch.mesh.SweepMesh`; requires flat_state) shards the sweep
    over the ranks of the process group, one rank a device (module
    docstring); the mesh spans every rank, or is the one-device mesh.  The
    contracts, as the reference's, against the unsharded engine from the
    same draws:

      "data": every real lane's trajectory at rtol 1e-6 (a lane's math
        does not depend on its rank; bitwise under strict_numerics).
      "workers" (worker_shards=W): the stats gather the per-worker scalars
        (the same [S, U] vector is reduced), the combine is each rank's
        weighted sum of its workers, then an all_reduce over the ranks
        (`_WorkerShards.psum_combine`), and the digital lanes gather the
        full slab; rtol 5e-6 over a run (the all_reduce adds the ranks'
        partial sums in another order).  Under strict_numerics every rank
        gathers the full slab and runs the unsharded math on it: bitwise
        (its gradients give each worker its own matmuls, so ceil(U / W)
        workers a call round as U workers do).
      "model" (model_shards=M): gradients come off the gathered full rows,
        the stats add each rank's partial sums (`flat_partial_stats`, two
        all_reduces), the combine, the fused step and the column-wise
        screens (mean, median, trimmed mean) run on each rank's columns,
        the row-geometry screens (Krum, geometric median) on gathered full
        rows, and the grad norm adds the ranks' squared sums; rtol 5e-6
        (5e-5 for the LM lane).  Under strict_numerics the round runs at
        full width and only the carry is sliced: bitwise.

    With chunking, every rank gathers the full carry at a checkpoint (the
    state at the real D, the Markov gains, every lane's generator states
    in lane order, the trajectory rows) and rank 0 alone writes it, in the
    unsharded run's layout; on resume rank 0's latest step is broadcast,
    and every rank reads it from checkpoint_dir (a filesystem every rank
    shares).
    """

    # Generator slots of the default draws (the JAX engine's split slots
    # 0-2 and fold_in constants 3, 4, 5, 7).
    _SLOTS = {"h_abs": 0, "z": 1, "jam": 2, "dir": 3, "markov": 4,
              "part": 5, "h_init": 7}

    def __init__(self, loss_fn: Callable, spec: SweepSpec,
                 eval_fn: Optional[Callable] = None, eval_every: int = 1,
                 plan: Optional[ExecutionPlan] = None, *, device="cuda",
                 force_plain: bool = False, flat_state=_UNSET, mesh=_UNSET,
                 strict_numerics=_UNSET, grouped_dispatch=_UNSET,
                 chunk_rounds=_UNSET, async_staging=_UNSET):
        plan = _plan_from(plan, dict(
            flat_state=flat_state, mesh=mesh,
            strict_numerics=strict_numerics,
            grouped_dispatch=grouped_dispatch, chunk_rounds=chunk_rounds,
            async_staging=async_staging), "SweepEngine")
        self.plan = plan
        # The reference's legacy surface: the knobs as plain attributes.
        self.flat_state = plan.flat_state
        self.mesh = plan.mesh
        self.strict_numerics = plan.strict_numerics
        self.grouped_dispatch = plan.grouped_dispatch
        self.chunk_rounds = plan.chunk_rounds
        self.async_staging = plan.async_staging
        self.checkpoint_dir = plan.checkpoint_dir
        self.checkpoint_every_chunks = plan.checkpoint_every_chunks
        self.loss_fn = loss_fn
        self.spec = spec
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.device = resolve_device(device)
        self.force_plain = force_plain
        self._u = spec.num_workers
        self._sp = spec.stacked_params(self.device)
        # The draws the lanes consume and the route, fixed by the spec.
        self._noise, self._jam = spec.analog_noise, spec.analog_jamming
        self._markov, self._partial = spec.any_markov, spec.any_partial
        self._dir = spec.any_directional
        mesh = plan.mesh
        if mesh is not None and not isinstance(mesh, SweepMesh):
            raise TypeError(
                f"plan.mesh must be a repro_torch.launch.mesh.SweepMesh "
                f"(make_sweep_mesh), got {type(mesh).__name__}")
        self._mesh_size = 1 if mesh is None else mesh.size
        axis = (lambda name: (0, None) if mesh is None
                else (mesh.axis_index(name), mesh.group(name)))
        # Worker and model shards (the model shards need D: built in run).
        self._ws = (_WorkerShards(self._u, plan.worker_shards,
                                  *axis("workers"))
                    if plan.worker_sharded else None)
        self._ms = None
        self._cols_cache = None
        self._model_axis = axis("model")
        # The lanes in execution order (`exec_src`: execution row -> source
        # lane, ghosts included) and this rank's block of them (`_rows`).
        # Grouped dispatch: the rows run in group order, ghost-padded per
        # family, and each group's rows, ScenarioParams and defense kernel
        # (None for the analog group) are fixed here, so a round only
        # indexes them.  The switch dispatch keeps lane order and one
        # selector over every family.  Results go back to lane order
        # (`_inverse`: each lane's first execution row) in `run`.
        shards = plan.data_shards
        num = len(spec)
        self._group_runs = None
        self._selector = None
        if spec.any_digital and plan.grouped_dispatch:
            groups = SC.build_lane_groups(spec.lane_codes, shards)
            exec_src, inverse = list(groups.perm), list(groups.inverse)
            if groups.num_ghosts > num:
                warnings.warn(
                    f"grouped dispatch executes {groups.exec_lanes} lanes "
                    f"for {num} scenarios ({groups.num_ghosts} ghosts: "
                    f"{len(groups.codes)} defense-code groups each padded to "
                    f"a multiple of {shards} ranks); grouped_dispatch=False "
                    f"may be faster")
        else:
            groups = None
            exec_src = list(range(num)) + [num - 1] * (-num % shards)
            inverse = list(range(num))
        self._exec_src = exec_src
        s_loc = len(exec_src) // shards
        lo = axis("data")[0] * s_loc
        self._lanes = slice(lo, lo + s_loc)
        self._lane_group = axis("data")[1]
        self._rows = exec_src[lo:lo + s_loc]
        dev = self.device
        self._local_src = (None if self._rows == list(range(num))
                           else torch.as_tensor(self._rows, dtype=torch.long,
                                                device=dev))
        self._inverse_rows = inverse
        self._inverse = (None if exec_src == inverse
                         else torch.as_tensor(inverse, dtype=torch.long,
                                              device=dev))
        self._sp_exec = (self._sp if self._local_src is None
                         else SC.permute_lanes(self._sp, self._local_src))
        if groups is not None:
            self._group_runs = [
                (slice(start, end), code,
                 SC.permute_lanes(self._sp_exec, slice(start, end)),
                 None if code == SC._FLOA_CODE
                 else DEF.make_group_defense_kernel(
                     code, spec.gm_iters, masked=self._partial,
                     plain=force_plain))
                for code, start, end in groups.local_slices]
        elif spec.any_digital:
            self._selector = DEF.make_flat_defense_selector(
                spec.digital_codes, spec.gm_iters, masked=self._partial,
                plain=force_plain)

    @property
    def _ws_run(self) -> Optional[_WorkerShards]:
        """The worker shards the round's math sees: none under
        strict_numerics, which gathers the full slab first."""
        return None if self.strict_numerics else self._ws

    @property
    def _ms_run(self) -> Optional[_ModelShards]:
        """The model shards the round's math sees: none under
        strict_numerics, which runs at full width."""
        return None if self.strict_numerics else self._ms

    # ------------------------------------------------------------ draws

    def _wanted_draws(self, s: int, d: int, t: int) -> Dict[str, tuple]:
        """key -> (shape, dtype) of every draw round t consumes."""
        u, f32 = self._u, torch.float32
        want = {"h_abs": ((s, u), f32)}
        for key, on, shape in [("z", self._noise, (s, d)),
                               ("jam", self._jam, (s, d)),
                               ("part", self._partial, (s, u)),
                               ("h_init", self._markov and t == 0, (s, u, 2)),
                               ("markov", self._markov, (s, u, 2)),
                               ("dir", self._dir, (s, d))]:
            if on:
                want[key] = (shape, torch.bool if key == "part" else f32)
        return want

    def seeded_draws(self, d: int) -> Callable[[int], Dict[str, Tensor]]:
        """The default draw provider (`_SeededDraws`): one generator a lane
        and stream on the engine's device.  Call it once per round, in
        round order."""
        return _SeededDraws(self, d)

    def _check_draw(self, draw, s: int, d: int, t: int) -> None:
        for key, (shape, dtype) in self._wanted_draws(s, d, t).items():
            x = draw.get(key)
            if (not isinstance(x, torch.Tensor) or tuple(x.shape) != shape
                    or x.dtype != dtype or x.device != self.device):
                raise ValueError(
                    f"draw {key!r} must be a {dtype} {shape} tensor on "
                    f"{self.device}, got "
                    f"{x if x is None else (x.dtype, tuple(x.shape), x.device)}")

    # ------------------------------------------------------------ a round

    def _stats(self, flat: Tensor, sizes) -> Tuple[Tensor, Tensor]:
        """Per-worker (gbar_i, eps2_i) [S_g, U] of a [S_g, U, D] slab: one
        launch, or per leaf segment under strict_numerics.  Sharded: this
        rank's workers' stats gathered, or its columns' partial sums added
        over the "model" ranks."""
        plain = self.force_plain
        if self.strict_numerics:
            return S.flat_scalar_stats(flat, sizes, plain=plain)
        ws, ms = self._ws_run, self._ms_run
        if ms is not None:
            s1, s2 = S.flat_partial_stats(flat, plain=plain)
            gbar_i, eps2_i = S.stats_from_partials(ms.psum(s1), ms.psum(s2),
                                                   ms.d)
        else:
            gbar_i, eps2_i = S.flat_scalar_stats(flat, plain=plain)
        if ws is not None:
            gbar_i, eps2_i = ws.gather_stats(gbar_i, eps2_i)
        return gbar_i, eps2_i

    def _select(self, gagg: Optional[Tensor], flat: Tensor,
                sp: SC.ScenarioParams, part: Optional[Tensor]) -> Tensor:
        """The switch dispatch's digital leg over all lanes: Byzantine rows
        sign-flipped, every family present run over every lane, each lane
        keeping its own family's row; analog lanes (code 0) keep `gagg`.
        `flat` is the full [S, U, D] slab; under model sharding the result
        is this rank's columns."""
        args = (sp.defense, _digital_flip(flat, sp), sp.def_trim, sp.def_f,
                sp.def_multi)
        dig = self._selector(*args) if part is None else self._selector(
            *args, part)
        if self._ms_run is not None:
            dig = self._ms_run.local_cols(dig)
        if gagg is None:   # all-digital: no analog leg at all
            return dig
        return torch.where((sp.defense == SC._FLOA_CODE)[:, None], gagg, dig)

    def _aggregate(self, w: Optional[Tensor], flat: Tensor, draw, sizes,
                   stats=None) -> Tuple[Optional[Tensor], Tensor]:
        """The round's aggregate from the slab `flat` (execution order,
        every column; this rank's workers under worker sharding, all of
        them under strict_numerics or an all-digital switch dispatch):
        (w_new, gagg), w_new None when `w` is None (the two-step route the
        tree state needs).  `stats` overrides the analog lanes' per-worker
        stats (the tree state's per-leaf sums).  Under model sharding `w`
        and the results are this rank's columns."""
        sp = self._sp_exec
        ws, ms = self._ws_run, self._ms_run
        part = draw.get("part") if self._partial else None
        if self._selector is not None and self.spec.all_digital:
            gagg = self._select(None, flat, sp, part)
            return (None if w is None else w - sp.alpha[:, None] * gagg), gagg
        local = flat if ms is None else ms.local_cols(flat)
        if self._group_runs is not None:
            w_parts, g_parts = [], []
            for rows, code, spg, kernel in self._group_runs:
                part_g = None if part is None else part[rows]
                if kernel is None:
                    st = (self._stats(local[rows], sizes) if stats is None
                          else stats(rows))
                    w_g, g_g = self._analog_step(
                        None if w is None else w[rows], local[rows],
                        SC.permute_lanes(draw, rows), spg, part_g, *st)
                else:
                    # Column-wise screens run on this rank's columns; the
                    # row-geometry ones score whole rows.
                    row_geo = (ms is not None
                               and code not in DEF.COLUMNWISE_CODES)
                    fg = flat[rows] if row_geo else local[rows]
                    if ws is not None:
                        fg = ws.gather_slab(fg)
                    args = (_digital_flip(fg, spg), spg.def_trim,
                            spg.def_f, spg.def_multi)
                    g_g = kernel(*args) if part_g is None else kernel(
                        *args, part_g)
                    if row_geo:
                        g_g = ms.local_cols(g_g)
                    elif ms is not None:
                        g_g = ms.mask(g_g)
                    w_g = (None if w is None
                           else w[rows] - spg.alpha[:, None] * g_g)
                w_parts.append(w_g)
                g_parts.append(g_g)
            gagg = torch.cat(g_parts)
            return (None if w is None else torch.cat(w_parts)), gagg
        if self._selector is None:   # all-analog
            st = self._stats(local, sizes) if stats is None else stats(
                slice(None))
            return self._analog_step(w, local, draw, sp, part, *st)
        st = self._stats(local, sizes) if stats is None else stats(
            slice(None))
        _, gagg = self._analog_step(None, local, draw, sp, part, *st)
        gagg = self._select(gagg, flat if ws is None
                            else ws.gather_slab(flat), sp, part)
        return (None if w is None else w - sp.alpha[:, None] * gagg), gagg

    def _analog_step(self, w: Optional[Tensor], grads: Tensor, draw,
                     sp: SC.ScenarioParams, part: Optional[Tensor],
                     gbar_i: Tensor, eps2_i: Tensor
                     ) -> Tuple[Optional[Tensor], Tensor]:
        """Steps 3-6 on analog lanes: (w [S_a, D] or None, grads
        [S_a, U, D], per-worker stats [S_a, U]) -> (w_new or None, gagg),
        with `draw`, `sp` and the participation masks `part` [S_a, U] (or
        None) for the same lanes.  With w the combine and update fuse unless
        jamming or a cohort direction lands in between.  Sharded: grads are
        this rank's workers (the combine an all_reduce of their weighted
        sum) or its columns (the draws sliced, the ghost columns masked)."""
        plain = self.force_plain
        ws, ms = self._ws_run, self._ms_run
        s, d = grads.shape[0], grads.shape[-1]
        # the PS mean over the participants of the per-worker stats (eq. 3)
        if part is None:
            gbar, eps2 = S.global_stats(gbar_i, eps2_i)
        else:
            gbar, eps2 = S.masked_global_stats(gbar_i, eps2_i, part)
        eps = torch.sqrt(eps2)
        # 3+4. channel draw + branchless power/attack coefficients.
        coeff, bias_w, jam_std, noise_std, dir_w = SC.scenario_coefficients(
            draw["h_abs"], sp, gbar, eps2, part)
        # 5. receiver noise row (all-zero when no analog lane is noisy).
        if self._noise:
            noise_row = noise_std[:, None] * draw["z"]
            if ms is not None:
                noise_row = ms.local_cols(noise_row)
        else:
            noise_row = torch.zeros((s, d), device=grads.device)
        bias_row = bias_w * gbar
        # 6. OTA combine + PS update: fused, or the combine, then jamming
        # and the cohorts' direction, then the update.
        if ws is not None:
            gagg = ws.psum_combine(coeff, grads, noise_row, bias_row, eps)
        elif w is not None and not (self._jam or self._dir):
            w_new, gagg = batched_floa_step(w, sp.alpha, coeff, grads,
                                            noise_row, bias_row, eps,
                                            plain=plain)
            if ms is not None:
                return ms.mask(w_new), ms.mask(gagg)
            return w_new, gagg
        else:
            gagg = batched_floa_combine(coeff, grads, noise_row, bias_row,
                                        eps, plain=plain)
        if ms is not None:   # the bias is a per-lane scalar broadcast
            gagg = ms.mask(gagg)
        if self._jam:
            jam_row = jam_std[:, None] * draw["jam"]
            gagg = gagg + (jam_row if ms is None else ms.local_cols(jam_row))
        if self._dir:
            gagg = gagg + dir_w[:, None] * self._direction(grads, draw, sp,
                                                           part)
        return (None if w is None else w - sp.alpha[:, None] * gagg), gagg

    def _direction(self, grads: Tensor, draw, sp: SC.ScenarioParams,
                   part: Optional[Tensor]) -> Tensor:
        """The cohort's shared row [S_a, D]: COLLUDING lanes a unit-RMS
        random direction (normalised at the full real D), every other lane
        the mean of its honest (participating) rows, which OMNISCIENT lanes
        transmit negated (the sign is in dir_w, 0 for other attacks)."""
        ws, ms = self._ws_run, self._ms_run
        dvec = draw["dir"]
        rms = torch.sqrt(torch.mean(dvec * dvec, dim=-1, keepdim=True))
        dvec = dvec / torch.clamp_min(rms, 1e-20)
        if ms is not None:
            dvec = ms.local_cols(dvec)
        honest = (~sp.byz_mask).float()
        if part is not None:
            honest = honest * part.float()
        cnt = torch.clamp_min(honest.sum(dim=-1), 1.0)
        if ws is None:
            hsum = torch.einsum("su,sud->sd", honest, grads)
        else:
            hsum = ws.psum(torch.einsum("su,sud->sd", ws.local_coeff(honest),
                                        grads))
        hmean = hsum / cnt[:, None]
        return torch.where((sp.attack == SC._COLLUDING)[:, None], dvec,
                           hmean)

    def _fade(self, h: Tensor, draw) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One Gauss-Markov step of the [S, U, 2] gains (execution order),
        and the draw with each rho > 0 lane's |h| taken off it (rho = 0
        lanes keep the i.i.d. draw)."""
        sp = self._sp_exec
        h = CH.gauss_markov_step(h, sp.sigma[..., None] * draw["markov"],
                                 sp.chan_rho[:, None, None])
        h_abs = torch.where((sp.chan_rho > 0.0)[:, None],
                            CH.complex_gain_abs(h), draw["h_abs"])
        return h, {**draw, "h_abs": h_abs}

    def _round_fn(self, unflatten_row, sizes):
        """round(state, batch, draw) -> (state_new, loss [S], gn [S]) and
        eval(state) -> dict of [S] for this plan's state representation:
        the flat [S, D] matrix or the dict of [S, ...] leaves."""
        loss_fn, u = self.loss_fn, self._u
        if self.flat_state:
            def flat_loss(w_row, batch):
                return loss_fn(unflatten_row(w_row), batch)

            ws, ms = self._ws, self._ms
            ws_run, ms_run = self._ws_run, self._ms_run
            u_run = u if ws is None else ws.u_loc
            fixed = self.strict_numerics
            grads_fn = vmap(lambda wr, b: per_worker_grads(
                flat_loss, wr, b, u_run, fixed_shapes=fixed),
                in_dims=(0, None))
            loss_lanes = vmap(flat_loss, in_dims=(0, None))
            # Worker sharding keeps this rank's workers unless the round
            # needs every worker's row: strict_numerics, and the switch
            # dispatch of an all-digital sweep (its screens are order
            # statistics over the workers).
            gather = ws is not None and (
                ws_run is None or (self._selector is not None
                                   and self.spec.all_digital))

            def one_round(w, batch, draw):
                # Model sharding: the gradients come off the gathered full
                # rows; the update runs on this rank's columns, or at full
                # width under strict_numerics (only the carry is sliced).
                # The full rows of the state a round returns are kept for
                # the next round and the eval (`_full_cols`): one gather a
                # round.
                w_full = self._full_cols(w)
                grads = grads_fn(w_full, batch if ws is None
                                 else ws.local_batch(batch)).contiguous()
                if gather:
                    grads = ws.gather_slab(grads)
                w_new, gagg = self._aggregate(
                    w if ms_run is not None else w_full, grads, draw, sizes)
                if ms_run is None:
                    gn = torch.sqrt(torch.sum(gagg * gagg, dim=-1))
                    loss = loss_lanes(w_new, batch)
                    if ms is not None:
                        self._cols_cache = (ms.local_cols(w_new), w_new)
                        w_new = self._cols_cache[0]
                else:
                    gn = torch.sqrt(ms.psum(torch.sum(gagg * gagg, dim=-1)))
                    self._cols_cache = (w_new, ms.gather_cols(w_new))
                    loss = loss_lanes(self._cols_cache[1], batch)
                return w_new, loss, gn

            return one_round, lambda w, i: unflatten_row(w[i])

        tree_grads = vmap(lambda p, b: per_worker_grads(
            loss_fn, p, b, u, fixed_shapes=self.strict_numerics),
            in_dims=(0, None))
        loss_lanes = vmap(loss_fn, in_dims=(0, None))

        def one_round(params, batch, draw):
            grads = tree_grads(params, batch)               # [S, U, ...]
            flat, unflatten = flatten_worker_grads(grads, batch_dims=2)
            stats = None
            if not self.strict_numerics:   # per leaf, off the tree
                def stats(rows):
                    return S.per_worker_scalar_stats(
                        tree_map(lambda g: g[rows], grads), batch_dims=2)
            _, gagg_flat = self._aggregate(None, flat, draw, sizes, stats)
            gagg = unflatten(gagg_flat)
            alpha = self._sp_exec.alpha
            new = tree_map(lambda p, g: p - (
                alpha.reshape(-1, *([1] * (p.dim() - 1))) * g).to(p.dtype),
                params, gagg)
            gn = torch.sqrt(torch.sum(gagg_flat * gagg_flat, dim=-1))
            return new, loss_lanes(new, batch), gn

        return one_round, lambda p, i: tree_map(lambda v: v[i], p)

    def _round_graph(self, one_round, seeded: Optional[_SeededDraws],
                     cur: List[int]) -> graphs.StepGraph:
        """One round of the flat state as a `graphs.StepGraph`:
        graph(state, batch, h, draw) -> (loss, gn), the state [S, D] and
        the Markov gains h held by reference and written in place, the
        batch row and a caller's draws (None under the seeded draws)
        copied in.  Under the seeded draws the round draws from every
        lane's generators inside the graph (registered with it), for round
        cur[0]."""
        def body(w, batch, h, draw):
            if seeded is not None:
                draw = seeded(cur[0])
            if self._markov:
                h_new, draw = self._fade(h, draw)
                h.copy_(h_new)
            w_new, loss, gn = one_round(w, batch, draw)
            w.copy_(w_new)
            return loss, gn

        gens = ([] if seeded is None
                else [g for gs in seeded.gens.values() for g in gs])
        return graphs.StepGraph(body, static=(0, 2), generators=gens)

    @torch.no_grad()
    def _eval(self, state, lane_view, num: int) -> Dict[str, Tensor]:
        rows = [self.eval_fn(lane_view(state, i)) for i in range(num)]
        return {k: torch.stack([torch.as_tensor(r[k],
                                                device=self.device).float()
                                for r in rows]) for k in rows[0]}

    # ------------------------------------------------------------ gathers

    def _gather_lanes(self, x: Tensor, dim: int = 0) -> Tensor:
        """This rank's lanes of `x` (along `dim`) -> every execution row,
        the ranks' blocks in "data" order (`x` itself without lane
        shards).  Host tensors travel on the engine's device."""
        if self._lane_group is None:
            return x
        return DIST.all_gather(x.to(self.device), self._lane_group,
                               dim).to(x.device)

    def _full_cols(self, w: Tensor) -> Tensor:
        """The flat state's real D columns (gathered over "model"; the last
        round's gather when `w` is the state that round returned)."""
        if self._ms is None:
            return w
        if self._cols_cache is not None and self._cols_cache[0] is w:
            return self._cols_cache[1]
        return self._ms.gather_cols(w)

    def _full_state(self, state):
        """The state in the unsharded layout: every execution row, the real
        D columns (the tree state is never sharded)."""
        if isinstance(state, dict):
            return state
        return self._gather_lanes(self._full_cols(state))

    def _host_blocks(self, traj: _Trajectory, keys=None) -> dict:
        """The trajectory so far on the host, every execution row:
        {"loss", "grad_norm": [T, S_exec], "metrics": {k: [T, S_exec]}}."""
        out = traj.host(keys)

        def rows(x: np.ndarray) -> np.ndarray:
            return self._gather_lanes(torch.from_numpy(
                np.ascontiguousarray(x)), dim=1).numpy()

        return {"loss": rows(out["loss"]), "grad_norm": rows(out["grad_norm"]),
                "metrics": {k: rows(v) for k, v in out["metrics"].items()}}

    # ------------------------------------------------------------ resume

    def _resume_extra(self, rounds: int, seeded: bool) -> dict:
        """The fingerprint a resume checkpoint carries: what its carry is
        valid for.  The reference's fields (its model_shards under a key of
        the port's own, so the JAX engine refuses the port's checkpoints),
        the execution order (ghost lanes included) and state
        representation, and the draw scheme (so the port refuses the JAX
        engine's)."""
        return {"resume_version": _RESUME_VERSION,
                "rounds_total": int(rounds),
                "chunk_rounds": int(self.chunk_rounds),
                "exec_lanes": len(self._exec_src),
                "eval_every": int(self.eval_every),
                "model_column_shards": int(self.plan.model_shards),
                "names": list(self.spec.names),
                "flat_state": bool(self.flat_state),
                "exec_order": list(self._exec_src),
                "draws": _SEEDED_DRAWS if seeded else _CALLER_DRAWS}

    def _save_checkpoint(self, t_next: int, rounds: int, state, h, draws,
                         traj: _Trajectory, seeded: bool) -> None:
        """Every rank gathers the carry in the unsharded layout (the
        generator states in lane order: each lane's first execution row);
        rank 0 alone writes it."""
        carry = {"state": self._full_state(state)}
        if h is not None:
            carry["h"] = self._gather_lanes(h)
        if seeded:
            first = self._inverse_rows
            carry["rng"] = {k: self._gather_lanes(v)[first]
                            for k, v in draws.state().items()}
        blocks = self._host_blocks(traj)
        if self._mesh_size > 1 and DIST.world()[0] != 0:
            return
        extra = self._resume_extra(rounds, seeded)
        extra["t_next"] = int(t_next)
        CKPT.save_pytree(self.checkpoint_dir, int(t_next),
                         {"carry": carry, "blocks": blocks}, extra=extra)

    def _restore_checkpoint(self, rounds: int, state, draws, seeded: bool):
        """The latest committed checkpoint, checked against this run:
        (t_start, state, h, trajectory prior) on the engine's device, this
        rank's share of them, or None when there is none yet (a fresh run).
        Sharded: rank 0's latest step, broadcast, is every rank's."""
        step = CKPT.latest_step(self.checkpoint_dir)
        if self._mesh_size > 1:
            step = DIST.broadcast_int(-1 if step is None else step,
                                      self.device)
            step = None if step < 0 else step
        if step is None:
            return None
        try:
            saved, meta = CKPT.restore_pytree(self.checkpoint_dir, step)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"rank {DIST.world()[0]} cannot read resume checkpoint step "
                f"{step} from {self.checkpoint_dir!r}: multi-process resume "
                f"requires checkpoint_dir on a filesystem shared by every "
                f"process (process 0 writes, the rest read)") from e
        ex = meta.get("extra", {})
        want = self._resume_extra(rounds, seeded)
        got = {k: ex.get(k) for k in want}
        if got != want:
            mismatch = sorted(k for k in want if got[k] != want[k])
            raise ValueError(
                f"resume checkpoint step {step} in {self.checkpoint_dir!r} "
                f"was written by an incompatible run: manifest keys "
                f"{mismatch} differ (checkpoint "
                f"{ {k: got[k] for k in mismatch} } vs engine "
                f"{ {k: want[k] for k in mismatch} })")
        carry, dev, lanes = saved["carry"], self.device, self._lanes
        if isinstance(state, dict):
            state = tree_map(lambda _, v: v.to(dev), state, carry["state"])
        else:
            state = carry["state"][lanes].to(dev)
            if self._ms is not None:
                state = self._ms.local_cols(state)
        h = carry["h"][lanes].to(dev) if "h" in carry else None
        if seeded:
            draws.load_state({k: v[self._rows]
                              for k, v in carry["rng"].items()})
        blocks = saved["blocks"]
        prior = {"loss": blocks["loss"].numpy()[:, lanes],
                 "grad_norm": blocks["grad_norm"].numpy()[:, lanes],
                 "metrics": {k: v.numpy()[:, lanes]
                             for k, v in blocks.get("metrics", {}).items()}}
        return int(ex["t_next"]), state, h, prior

    # ------------------------------------------------------------ run

    def run(self, params0: Dict[str, Tensor], batches: Dict[str, np.ndarray],
            draws: Optional[Callable[[int], Dict[str, Tensor]]] = None,
            resume: bool = False) -> SweepResult:
        """params0: one init tree (nested dicts, JAX layout), broadcast to
        every lane.
        batches: dict of [R, U*B, ...] arrays shared by every lane (host
        arrays; chunked plans stage [C, ...] blocks of them; every rank
        passes the same).  draws: optional per-round draw provider (module
        docstring); None uses `seeded_draws`.  resume=True (requires the
        plan's checkpoint_dir) continues from the latest committed
        checkpoint, bitwise as the uninterrupted run; with none on disk it
        is a fresh run.  Sharded, every rank returns the full result."""
        if resume and self.checkpoint_dir is None:
            raise ValueError(
                "resume=True needs a checkpoint to restore: construct the "
                "engine with plan=ExecutionPlan(checkpoint_dir=..., "
                "chunk_rounds=...)")
        dev, num, s_loc = self.device, len(self.spec), len(self._rows)
        params0 = tree_map(lambda v: torch.as_tensor(v, device=dev), params0)
        unflatten_row, sizes = make_row_unflatten(params0)
        d = sum(sizes)
        self._ms = (_ModelShards(d, self.plan.model_shards, *self._model_axis)
                    if self.plan.model_sharded else None)
        self._cols_cache = None   # (local state, its full columns)
        rounds = next(iter(batches.values())).shape[0]
        seeded = draws is None
        draws = self.seeded_draws(d) if seeded else draws
        # every lane starts from params0: this rank's rows of it
        stacked = stack_params(params0, s_loc)
        if self.flat_state:
            state, _ = flatten_worker_grads(stacked, batch_dims=1)
            state = state.contiguous()                      # [S_loc, D] f32
            if self._ms is not None:
                state = self._ms.local_cols(state)          # [S_loc, d_loc]
        else:
            state = tree_map(lambda v: v.contiguous(), stacked)
        one_round, lane_view = self._round_fn(unflatten_row, sizes)

        h = None   # the Gauss-Markov state [S_loc, U, 2], execution order
        t, prior = 0, None
        if resume:
            restored = self._restore_checkpoint(rounds, state, draws, seeded)
            if restored is not None:
                t, state, h, prior = restored
        traj = _Trajectory(s_loc, prior)
        # the round as a CUDA graph (the reference's lax.scan body): the
        # flat state on one device; `cur` is the round it draws for
        cur = [t]
        graph = (self._round_graph(one_round, draws if seeded else None,
                                   cur)
                 if self.flat_state and self.mesh is None else None)
        want = tuple(self._wanted_draws(s_loc, d, 1))
        chunk = self.chunk_rounds or max(rounds, 1)
        host = {k: np.asarray(v)[t:] for k, v in batches.items()}
        blocks = iter_chunk_blocks(host, chunk)
        stager = BlockStager(dev, self.async_staging)

        def stage():
            blk = next(blocks, None)
            return None if blk is None else stager.stage(blk)

        nxt = stage() if self.async_staging else None
        every, i = self.checkpoint_every_chunks, 0
        while t < rounds:
            staged = nxt if self.async_staging else stage()
            block = staged.ready()
            n = next(iter(block.values())).shape[0]
            for j in range(n):   # round t + j reads row j of the block
                batch = {k: v[j] for k, v in block.items()}
                cur[0] = t + j
                replay = (graph is not None and graphs.graphs_enabled()
                          and not (self._markov and t + j == 0))
                draw = None
                if not (replay and seeded):
                    draw = draws(t + j)
                if not seeded:   # full-S rows: this rank's, in its order
                    self._check_draw(draw, num, d, t + j)
                    if self._local_src is not None:
                        draw = SC.permute_lanes(draw, self._local_src)
                if replay:   # state and h written in place
                    loss, gn = graph(state, batch, h, None if seeded else
                                     {k: draw[k] for k in want})
                    loss, gn = loss.clone(), gn.clone()
                else:
                    if self._markov:
                        if t + j == 0:   # stationary: marginals Rayleigh
                            h = (self._sp_exec.sigma[..., None]
                                 * draw["h_init"])
                        h, draw = self._fade(h, draw)
                    state, loss, gn = one_round(state, batch, draw)
                due = t + j == rounds - 1 or (
                    self.eval_every > 0 and (t + j) % self.eval_every == 0)
                traj.add(loss, gn, self._eval(self._full_cols(state),
                                              lane_view, s_loc)
                         if due and self.eval_fn is not None else None)
            t += n
            del staged, block
            if self.async_staging:   # overlaps the rounds just enqueued
                nxt = stage()
            i += 1
            if (self.checkpoint_dir is not None and t < rounds
                    and i % every == 0):
                self._save_checkpoint(t, rounds, state, h, draws, traj,
                                      seeded)

        keys = None
        if rounds == 0 and self.eval_fn is not None:
            # no round ran: the eval's keys, as the JAX engine's traced
            # eval gives them
            keys = self._eval(self._full_cols(state), lane_view,
                              s_loc).keys()
        out = self._host_blocks(traj, keys)
        # Back to lane order: execution row self._inverse[i] is lane i.
        inv = (np.arange(num) if self._inverse is None
               else np.asarray(self._inverse_rows))

        def lanes(x: np.ndarray) -> np.ndarray:
            return np.ascontiguousarray(x.T[inv])

        final = self._full_state(state)
        self._cols_cache = None
        final = unflatten_row(final) if self.flat_state else final
        if self._inverse is not None:
            final = SC.permute_lanes(final, self._inverse)
        return SweepResult(
            names=self.spec.names,
            params=tree_map(lambda v: v.clone(), final),
            loss=lanes(out["loss"]), grad_norm=lanes(out["grad_norm"]),
            metrics={k: lanes(v) for k, v in out["metrics"].items()})


def run_sweep(loss_fn: Callable, params0, batches, spec: SweepSpec,
              eval_fn: Optional[Callable] = None, eval_every: int = 1,
              plan: Optional[ExecutionPlan] = None, *, resume: bool = False,
              device="cuda", draws=None, flat_state=_UNSET, mesh=_UNSET,
              chunk_rounds=_UNSET, async_staging=_UNSET) -> SweepResult:
    """One-shot convenience wrapper around SweepEngine.  plan= is the
    execution strategy; the loose per-knob kwargs are the deprecated
    spelling (a DeprecationWarning; mixing them with plan= raises).
    resume= forwards to `SweepEngine.run`."""
    plan = _plan_from(plan, dict(flat_state=flat_state, mesh=mesh,
                                 chunk_rounds=chunk_rounds,
                                 async_staging=async_staging), "run_sweep")
    return SweepEngine(loss_fn, spec, eval_fn=eval_fn, eval_every=eval_every,
                       plan=plan, device=device).run(params0, batches,
                                                     draws=draws,
                                                     resume=resume)

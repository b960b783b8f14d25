"""The sweep mesh over the ranks of a process group.

The counterpart of `repro/launch/mesh.py`'s `make_sweep_mesh`,
`make_debug_mesh` and the axis helpers.  A JAX mesh is a grid of devices of
one process; the port's devices are the ranks of the `torch.distributed`
process group (one process a device, `launch.distributed`), and the grid is
a `torch.distributed.device_mesh.DeviceMesh` whose dim names are the
reference's axes:

    mesh = make_sweep_mesh(8, worker_shards=2, model_shards=2)
    mesh.axis_names        # ("data", "workers", "model"), as the reference
    mesh.shape             # {"data": 2, "workers": 2, "model": 2}
    mesh.axis_index("model"), mesh.group("workers")

The mesh keeps the reference mesh's `axis_names` and `shape`, so
`fl/plan.py` checks it as it checks a JAX mesh.  A sweep mesh spans every
rank of the process group (every rank builds it, in the same order), or
it is the one-device mesh: this process's own device, which needs no
process group and has no groups.  The DeviceMesh's groups take the process
group's backend and timeout, named explicitly: nothing switches to another
backend (several ranks sharing one card run gloo over CUDA tensors).

The LM steps (`launch/steps.py`) take a mesh of the reference's
("data", "model") or ("pod", "data", "model") axes, its ranks laid out
row-major over them as `init_device_mesh` lays them out: U, the FL worker
count, is the size of the worker axes ("pod", "data"), and each worker is
the M ranks of one position on them (`worker_axes`), which split every
layer over the "model" axis (`model_axis`: tensor parallelism, M the
"model" size).  A worker's group of ranks is the ranks that share this
rank's model index.  `make_production_mesh` is the reference's
production layout over the ranks: 16 x 16 ("data", "model"), 256 ranks,
or 2 x 16 x 16 ("pod", "data", "model"), 512 (`--mesh single|multi`,
`mesh_from_arg`); on a fake process group of that size its rank 0 is what
`launch/dryrun.py` traces.  The "data" axis (`data_axis`) also shards
the storage of the large weights (`launch.sharding.fsdp_augment`).

The reference's `NamedSharding` placement helpers (`lane_sharding`,
`sweep_state_sharding`, `put_with_sharding`, `stage_batch_block`) have no
torch meaning: the sweep engine slices each rank's own lanes, workers and
columns explicitly (fl/sweep.py), and each rank stages the replicated
batch blocks to its own device (`launch.staging`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.distributed import group_options, world


class SweepMesh:
    """A grid of ranks with named axes (`make_sweep_mesh`,
    `make_debug_mesh`): axis_names  the axes in order; shape  {axis: size},
    ordered; device_mesh  the DeviceMesh over every rank (None for the
    one-device mesh of a process without a process group, or of one rank
    of a larger group)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        n = math.prod(shape)
        rank, size = world()
        assert size >= n, f"need {n} devices, have {size}"
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.rank = rank
        self.subgroups = {}   # `_subgroup`'s groups, by axes
        self.device_mesh = None
        if dist.is_initialized() and n == size:
            backend = dist.get_backend()
            self.device_mesh = init_device_mesh(
                "cuda" if torch.cuda.is_available() else "cpu", shape,
                mesh_dim_names=axis_names, backend_override={
                    a: (backend, group_options(backend)) for a in axis_names})
        elif n != 1:
            raise ValueError(
                f"a sweep mesh spans every rank of the process group or is "
                f"the one-device mesh: {n} devices, {size} ranks")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, name: str) -> int:
        """This rank's index along `name` (0 for an axis the mesh lacks)."""
        if self.device_mesh is None or name not in self.axis_names:
            return 0
        return self.device_mesh.get_local_rank(name)

    def group(self, name: str):
        """The process group of this rank's line along `name`; None for an
        axis the mesh lacks and on the one-device mesh."""
        if self.device_mesh is None or name not in self.axis_names:
            return None
        return self.device_mesh.get_group(name)

    def __repr__(self) -> str:
        return f"SweepMesh({dict(self.shape)}, rank={self.rank})"


def sweep_mesh_axes(num_devices: int, worker_shards: int = 1,
                    model_shards: int = 1) -> Tuple[Tuple[str, ...],
                                                    Tuple[int, ...]]:
    """(axis names, shape) of the sweep mesh of `num_devices` devices, by
    the reference's rules: the devices factor as data x W x M with the axes
    ordered ("data", "workers", "model") and size-1 axes dropped, and with
    W = M = 1 the 1-D ("data",) mesh of any size.  AssertionError, as the
    reference, when the count does not factor."""
    assert worker_shards >= 1, worker_shards
    assert model_shards >= 1, model_shards
    if worker_shards == 1 and model_shards == 1:
        return ("data",), (num_devices,)
    assert num_devices % (worker_shards * model_shards) == 0, (
        f"num_devices={num_devices} not divisible by worker_shards="
        f"{worker_shards} * model_shards={model_shards}")
    dims = (("data", num_devices // (worker_shards * model_shards)),
            ("workers", worker_shards), ("model", model_shards))
    kept = tuple((a, s) for a, s in dims if s > 1)
    return tuple(a for a, _ in kept), tuple(s for _, s in kept)


def make_sweep_mesh(num_devices: Optional[int] = None,
                    worker_shards: int = 1,
                    model_shards: int = 1) -> SweepMesh:
    """Sweep mesh: 1-D ("data",) over the lane axis by default;
    worker_shards=W > 1 adds a ("workers",) axis over which the [S, U, D]
    gradient slab's worker axis shards; model_shards=M > 1 adds a
    ("model",) axis over which the flat [S, D] state's D axis shards
    (`sweep_mesh_axes`: e.g. 8 devices with W = 4 are the 2 x 4 ("data",
    "workers") mesh, with M = 8 the 1-D ("model",) mesh, with W = M = 2
    the 2 x 2 x 2 mesh).

    The devices are the ranks: num_devices=None uses every rank of the
    process group (one without a group), and a mesh of one device is the
    calling rank's.  Raises AssertionError, as the reference does, when
    there are too few ranks or the count does not factor."""
    n = world()[1] if num_devices is None else num_devices
    assert world()[1] >= n, f"need {n} devices, have {world()[1]}"
    axes, shape = sweep_mesh_axes(n, worker_shards, model_shards)
    return SweepMesh(shape, axes)


def make_debug_mesh(shape: Sequence[int], axes: Sequence[str]) -> SweepMesh:
    return SweepMesh(tuple(shape), tuple(axes))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The FL-worker / batch axes of a mesh (everything except "model")."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def num_workers(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def model_parallel(mesh) -> int:
    return mesh.shape.get("model", 1)


# What of the LM steps' "model" axis is still to port: the message of its
# refusals.
Q_MODEL_AXIS = ("is not ported (ROADMAP.md Queue 1 item 8d: MLA layouts "
                "whose heads or q_lora, SSD layouts whose heads and RG-LRU "
                "layouts whose width the \"model\" axis does not divide, "
                "and sequence-parallel residuals)")
STEP_AXES = ("pod", "data", "model")
# The reference's production layouts (`repro/launch/mesh.py::
# make_production_mesh`): --mesh single and multi.
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> "SweepMesh":
    """The reference's production mesh over the ranks of the process group:
    16 x 16 ("data", "model") (256 ranks) or, multi_pod, 2 x 16 x 16
    ("pod", "data", "model") (512): 16 or 32 FL workers of 16
    tensor-parallel ranks each.  ValueError, naming the count it needs,
    unless the process group has exactly that many ranks."""
    shape, axes = PRODUCTION["multi" if multi_pod else "single"]
    n, ranks = math.prod(shape), world()[1]
    if ranks != n:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{' x '.join(map(str, shape))} {axes} needs {n} ranks; the "
            f"process group has {ranks}")
    return SweepMesh(shape, axes)


@dataclasses.dataclass(frozen=True)
class WorkerAxes:
    """This process's share of an LM step's U FL workers: it holds workers
    [first, first + count) and rows [first * B / U, (first + count) * B / U)
    of a global batch of B (the reference's `batch_specs` layout); `group`
    is the process group over the worker axes (the ranks of this rank's
    model index), None when this process holds every worker."""
    num_workers: int
    first: int = 0
    count: int = 1
    group: object = None

    @classmethod
    def every(cls, num_workers: int) -> "WorkerAxes":
        """All U workers in this process: the one-process twin of a
        U-worker mesh (the weighted-loss identity over U row blocks)."""
        return cls(num_workers, 0, num_workers, None)

    def rows(self, batch: int) -> slice:
        """This process's rows of a global batch of `batch` (which U
        divides)."""
        per = batch // self.num_workers
        return slice(self.first * per, (self.first + self.count) * per)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on an LM step's "model" axis: `size` M ranks split
    every layer (tensor parallelism), this rank is the `index`-th, and
    `group` is the process group of the M ranks (None for M = 1)."""
    size: int = 1
    index: int = 0
    group: object = None
    NAME = "model"

    def __post_init__(self):
        if self.size > 1 and self.group is None:
            raise ValueError(f"a \"{self.NAME}\" axis of {self.size} ranks "
                             f"needs their process group: take it from the "
                             f"mesh ({self.NAME}_axis(mesh))")

    def shards(self, n: int) -> bool:
        """Whether a dim of n is split over the axis: the reference's
        `ModelConfig.shard` rule, n a multiple of M (and M > 1)."""
        return self.size > 1 and n % self.size == 0

    def part(self, n: int) -> slice:
        """This rank's indices of a dim of n split over the axis."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


@dataclasses.dataclass(frozen=True)
class DataAxis(ModelAxis):
    """This rank's place on the "data" axis as the weights' storage sees
    it (`launch.sharding.fsdp_augment`): a data-sharded leaf is split over
    the `size` ranks of `group` (the ranks that share this rank's "pod"
    and "model" indices), this rank holding the `index`-th part, and
    gathered whole where a layer uses it."""
    NAME = "data"


def _subgroup(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's line over several axes of `mesh`
    (the ranks that differ only along `axes`), made once a mesh: every
    rank makes every line's group together, in one order, on first use."""
    cache = mesh.subgroups
    if axes not in cache:
        grid = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
        keep = [mesh.axis_names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in keep]
        lines = grid.transpose(rest + keep).reshape(
            -1, math.prod(mesh.shape[a] for a in axes))
        backend = dist.get_backend()
        opts = group_options(backend)
        mine, _ = dist.new_subgroups_by_enumeration(
            [list(map(int, line)) for line in lines], backend=backend,
            pg_options=opts,
            timeout=None if opts is None else opts._timeout)
        cache[axes] = mine
    return cache[axes]


def worker_axes(mesh) -> WorkerAxes:
    """The worker layout of an LM step's mesh.  None, a one-device mesh
    and a one-device (data, model) shape are U = 1.  A `SweepMesh` over the
    ranks has U = the product of its "pod" and "data" sizes; a rank is
    worker pod * |data| + data, and its rank is that worker times M plus
    its model index (`init_device_mesh` lays the ranks out row-major and
    the mesh spans every rank).  The worker group is the ranks of this
    rank's model index: the process group when M = 1.  An axis other than
    "pod", "data" and "model", or a tuple shape of several devices (it
    names no ranks), raises ValueError, anything else but a mesh
    TypeError.  A `WorkerAxes` is returned as is."""
    if isinstance(mesh, WorkerAxes):
        return mesh
    if mesh is None:
        return WorkerAxes(1)
    if isinstance(mesh, (tuple, list)):   # a (data, model) shape
        if math.prod(mesh) == 1:
            return WorkerAxes(1)
        raise ValueError(f"mesh {tuple(mesh)}: a shape names no ranks; pass "
                         f"make_debug_mesh(shape, axes) over the process "
                         f"group")
    if not hasattr(mesh, "axis_names"):
        raise TypeError(f"{mesh!r} is not a mesh: the LM steps take None, "
                        f"a SweepMesh over the ranks or a WorkerAxes")
    other = [a for a in mesh.axis_names if a not in STEP_AXES]
    if other:
        raise ValueError(f"mesh axes {mesh.axis_names}: the LM steps take "
                         f"{STEP_AXES}")
    m = model_parallel(mesh)
    w = 0
    for a in batch_axes(mesh):
        w = w * mesh.shape[a] + mesh.axis_index(a)
    if mesh.device_mesh is not None and (
            w * m + mesh.axis_index("model") != dist.get_rank()):
        raise AssertionError(f"worker {w} on rank {dist.get_rank()}: the "
                             f"mesh's ranks are not laid out row-major")
    u = num_workers(mesh)
    if u == 1:
        return WorkerAxes(1)
    if m == 1:
        return WorkerAxes(u, w, 1, dist.group.WORLD)
    wide = tuple(a for a in batch_axes(mesh) if mesh.shape[a] > 1)
    group = (mesh.group(wide[0]) if len(wide) == 1
             else _subgroup(mesh, wide))
    return WorkerAxes(u, w, 1, group)


def model_axis(mesh) -> ModelAxis:
    """The "model" axis of an LM step's mesh (`worker_axes`'s meshes):
    (M, this rank's model index, the group of the M ranks); M = 1 for
    None, a `WorkerAxes` and a mesh without the axis."""
    return _axis(mesh, "model", ModelAxis)


def _axis(mesh, name: str, cls):
    """`cls` of the `name` axis of an LM step's mesh (`worker_axes`'s
    meshes): size 1 for None, a `WorkerAxes` and a mesh without it."""
    worker_axes(mesh)
    if mesh is None or isinstance(mesh, (WorkerAxes, tuple, list)) \
            or mesh.shape.get(name, 1) == 1:
        return cls()
    return cls(mesh.shape[name], mesh.axis_index(name), mesh.group(name))


def data_axis(mesh) -> DataAxis:
    """The "data" axis of an LM step's mesh, over which the weights'
    storage is sharded (`launch.sharding.data_specs`): (R, this rank's
    data index, the group of the R ranks that share its pod and model
    indices); R = 1 for None, a `WorkerAxes` and a mesh without the
    axis."""
    return _axis(mesh, "data", DataAxis)


def pod_group(mesh):
    """The group of the ranks that differ from this one only in "pod"
    (None without a "pod" axis of more than one): over it a data-sharded
    leaf's gradient, already summed over "data", is summed over the rest
    of the workers."""
    return _axis(mesh, "pod", ModelAxis).group


def mesh_from_arg(spec: str) -> Optional[SweepMesh]:
    """The drivers' --mesh over the process group: "single" / "multi", the
    reference's production meshes (`make_production_mesh`: 256 or 512
    ranks, else ValueError naming the count), or "RxM", the (R, M)
    ("data", "model") debug mesh of every rank (R FL workers of M ranks
    each, tensor parallel over "model"), None for "1x1" in one process (no
    mesh).  R x M other than the number of ranks raises ValueError."""
    if spec in PRODUCTION:
        return make_production_mesh(multi_pod=spec == "multi")
    r, m = (int(x) for x in spec.lower().split("x"))
    ranks = world()[1]
    if r * m != ranks:
        raise ValueError(f"--mesh {spec}: a mesh spans every rank of the "
                         f"process group, which has {ranks} (the --mesh "
                         f"forms: launch.mesh.mesh_from_arg's docstring)")
    return None if ranks == 1 else make_debug_mesh((r, m), ("data", "model"))

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

The reference's `NamedSharding` placement helpers (`lane_sharding`,
`sweep_state_sharding`, `put_with_sharding`, `stage_batch_block`) have no
torch meaning: the sweep engine slices each rank's own lanes, workers and
columns explicitly (fl/sweep.py), and each rank stages the replicated
batch blocks to its own device (`launch.staging`).
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Sequence, Tuple

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

"""ExecutionPlan: the sweep engine's execution strategy as one validated value.

The counterpart of `repro/fl/plan.py`, with the same fields, defaults and
cross-knob rules, raising the same exception types, so a plan means the same
in both packages:

    plan = ExecutionPlan(chunk_rounds=16, async_staging=True)
    SweepEngine(loss_fn, spec, plan=plan)

Every knob changes HOW a sweep executes, never WHAT it computes; the
`SweepEngine` class docstring states each knob's equivalence contract.

Rules checked at construction:

  - ``chunk_rounds`` is None or a positive int (ValueError otherwise);
  - ``async_staging`` requires ``chunk_rounds`` (ValueError);
  - ``checkpoint_every_chunks`` is a positive int (ValueError), and other
    than 1 only with a ``checkpoint_dir`` (ValueError);
  - ``checkpoint_dir`` requires ``chunk_rounds`` (ValueError);
  - ``mesh`` requires ``flat_state`` (AssertionError), and its axis names
    must be one of the reference's sweep meshes (AssertionError);
  - ``worker_shards`` / ``model_shards`` > 1 need a mesh axis of that size
    (ValueError), and are derived from the mesh when left at 1.

The port imports no JAX, so these rules read only the mesh's
``axis_names`` and ``shape``; `SweepEngine` runs a `launch.mesh.SweepMesh`
(`make_sweep_mesh`), whose devices are the ranks of a process group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

_SWEEP_MESH_AXES = (("data",), ("workers",), ("data", "workers"),
                    ("model",), ("data", "model"), ("workers", "model"),
                    ("data", "workers", "model"))


def _mesh_axis(mesh, name: str) -> int:
    return 1 if mesh is None else dict(mesh.shape).get(name, 1)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """How one sweep executes (the reference's fields and defaults).

    flat_state      params as one [S, D] matrix across the rounds; False
                    keeps the tree-state reference (a dict of [S, ...]
                    leaves, per-round flatten and per-leaf update).
    strict_numerics pin the standardization stats' reduction (leaf-
                    segmented sums in a fixed order) so every strategy
                    replays the same trajectory bitwise.
    mesh            a sweep mesh (`launch.mesh.make_sweep_mesh`): "data"
                    shards the lanes, "workers" the worker axis, "model"
                    the flat parameter axis.
    grouped_dispatch  static per-defense-family lane partition (vs the
                    per-lane switch reference).
    chunk_rounds    rounds in blocks of C, with only [C, ...] batch blocks
                    on the device.
    async_staging   stage block k+1 while chunk k's rounds are enqueued.
    worker_shards / model_shards  the mesh's "workers" / "model" axis
                    sizes (derived from the mesh when left at 1).
    checkpoint_dir  directory of the preemption-safe resume checkpoints,
                    written at chunk boundaries (requires chunk_rounds).
    checkpoint_every_chunks  a checkpoint after every Nth chunk.
    """

    flat_state: bool = True
    strict_numerics: bool = False
    mesh: Optional[Any] = None
    grouped_dispatch: bool = True
    chunk_rounds: Optional[int] = None
    async_staging: bool = False
    worker_shards: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every_chunks: int = 1
    model_shards: int = 1

    def __post_init__(self):
        if self.chunk_rounds is not None and self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be a positive int or None, got "
                f"{self.chunk_rounds}")
        if self.async_staging and self.chunk_rounds is None:
            raise ValueError(
                "async_staging overlaps the per-chunk batch transfers; it "
                "requires chunk_rounds (the monolithic engine stages the "
                "whole [R, ...] stack once, so there is no chunk boundary "
                "to overlap)")
        if self.checkpoint_every_chunks < 1:
            raise ValueError(
                f"checkpoint_every_chunks must be a positive int, got "
                f"{self.checkpoint_every_chunks}")
        if self.checkpoint_dir is not None and self.chunk_rounds is None:
            raise ValueError(
                "checkpoint_dir requires chunk_rounds: the chunk boundary is "
                "the checkpoint boundary")
        if self.checkpoint_every_chunks != 1 and self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every_chunks has no effect without "
                "checkpoint_dir")
        if self.mesh is not None:
            assert self.flat_state, \
                "mesh-sharded sweeps require the flat-state path"
            names = tuple(getattr(self.mesh, "axis_names", ()))
            assert names in _SWEEP_MESH_AXES, (
                f"sweep mesh axes must be one of {_SWEEP_MESH_AXES}, "
                f"got {names}")
        for knob, axis in (("worker_shards", "workers"),
                           ("model_shards", "model")):
            shards, on_mesh = getattr(self, knob), _mesh_axis(self.mesh, axis)
            if shards == 1 and on_mesh > 1:
                object.__setattr__(self, knob, on_mesh)
                shards = on_mesh
            if shards == 1:
                continue
            if shards < 1:
                raise ValueError(f"{knob} must be >= 1, got {shards}")
            if not self.flat_state:
                raise ValueError(f"{knob} > 1 requires the flat-state path "
                                 f"(flat_state=True)")
            if on_mesh != shards:
                raise ValueError(
                    f"{knob}={shards} needs a mesh with a {axis!r} axis of "
                    f"that size; got "
                    f"{None if self.mesh is None else dict(self.mesh.shape)}")

    @property
    def data_shards(self) -> int:
        """Lane-axis shard count (1 without a mesh or a "data" axis)."""
        return _mesh_axis(self.mesh, "data")

    @property
    def worker_sharded(self) -> bool:
        return self.worker_shards > 1

    @property
    def model_sharded(self) -> bool:
        return self.model_shards > 1

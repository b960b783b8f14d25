"""FSDP storage over "data" (`repro_torch.launch.sharding.fsdp_augment`,
`data_specs`) against the reference's `repro.launch.sharding.fsdp_augment`,
and the production meshes' refusals, in this process (no ranks: the
rank runs are tests/test_torch_fsdp_ranks.py).

- `data_specs(cfg, M, 16)` of all ten full configs at M = 16 and M = 1
  equals, leaf by leaf, the "data" entry of the reference's
  `fsdp_augment` over the reference's `init_model(shape_only=True)` specs
  at model_parallel = M, with a stand-in mesh of ("data": 16, "model": M)
  (as tests/test_launch_logic.py does); and the bytes a rank stores on the
  16 x 16 mesh, the reference's spec arithmetic (each leaf's elements over
  the sizes of the axes its spec names), are what `init_model(..., "meta",
  mesh)` lays out;
- the reference's two `fsdp_augment` cases restated on the port;
- `shard_params` / `gather_params` round trips over both axes on a stand-in
  of one rank.
"""
import dataclasses
import math
import warnings

import jax
import pytest
import torch

with warnings.catch_warnings():
    # jax 0.9 deprecates jax.experimental.shard_map, which the reference
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as jget_config
    from repro.launch import steps as JSTEPS
    from repro.launch.sharding import fsdp_augment as jfsdp_augment

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (DataAxis, ModelAxis, make_production_mesh,
                                     mesh_from_arg)
from repro_torch.tree import tree_leaves

R = 16


class StandIn:
    """The reference's `fsdp_augment` reads only `mesh.shape`."""

    def __init__(self, m):
        self.shape = {"data": R, "model": m}


def _jspecs(arch, m):
    jcfg = dataclasses.replace(jget_config(arch), model_parallel=m)
    shapes, specs = JSTEPS.init_model(jcfg, jax.random.PRNGKey(0),
                                      shape_only=True)
    specs = jfsdp_augment(specs, shapes, StandIn(m))
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda z: isinstance(z, P))
    return jax.tree_util.tree_leaves(shapes), leaves


def _dim(spec, axis):
    return next((i for i, e in enumerate(spec) if e == axis), None)


@pytest.mark.parametrize("m", [16, 1])
def test_data_specs_equal_the_reference(m):
    """All ten full archs: each leaf's "data" dim is the reference's, and a
    rank's stored bytes on (16, M) are the reference's spec arithmetic
    (deepseek-v2-236b's under 3 GB on (16, 16))."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        jshapes, jspecs = _jspecs(arch, m)
        got = tree_leaves(SH.data_specs(cfg, m, R))
        assert got == [_dim(s, "data") for s in jspecs], (arch, m)
        want = sum(math.prod(x.shape) * x.dtype.itemsize
                   // (R if "data" in s else 1)
                   // (m if "model" in s else 1)
                   for x, s in zip(jshapes, jspecs))
        full = SH.init_params(cfg, None, "meta")
        mine = sum(math.prod(
            n // (R if i == d else 1) // (m if i == dm else 1)
            for i, n in enumerate(x.shape)) * x.element_size()
            for x, d, dm in zip(tree_leaves(full), got,
                                tree_leaves(SH.param_specs(cfg, m))))
        assert mine == want, (arch, m)
        if arch == "deepseek-v2-236b" and m == 16:
            assert mine < 3e9


def test_fsdp_augment_shards_large_leaves_only():
    """The reference's case (tests/test_launch_logic.py): a 16M-element
    leaf takes "data" on dim 0 beside its "model" dim 1, a small leaf
    nothing."""
    shapes = {"big": torch.empty(1 << 12, 1 << 12, device="meta"),
              "small": torch.empty(128, device="meta")}
    out = SH.fsdp_augment({"big": 1, "small": None}, shapes, 4)
    assert out == {"big": 0, "small": None}
    assert SH.fsdp_augment({"big": 1, "small": None}, shapes, 1) == {
        "big": None, "small": None}


def test_fsdp_augment_skips_leading_scan_dim():
    """The reference's case: a stacked [60, 4096, 4096] leaf split on dim 2
    over "model" takes "data" on dim 1, never the layer dim 0."""
    shapes = {"stacked": torch.empty(60, 4096, 4096, device="meta")}
    assert SH.fsdp_augment({"stacked": 2}, shapes, 4) == {"stacked": 1}
    assert SH.fsdp_augment({"stacked": 1}, shapes, 4) == {"stacked": 2}


class _Mesh:
    """A stand-in for one rank of a (2, 2) ("data", "model") mesh in this
    process: `shard_params` and `gather_params` read its axes only."""


def test_shard_and_gather_over_both_axes(monkeypatch):
    """Each rank of a (2, 2) mesh stores the slice of both dims; the four
    ranks' slices, gathered over "data" then "model", are the leaf."""
    full = {"w": torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6),
            "b": torch.arange(6.0)}
    specs, dspecs = {"w": 1, "b": None}, {"w": 0, "b": None}
    parts = {}
    for d in range(2):
        for m in range(2):
            monkeypatch.setattr(SH, "model_axis",
                                lambda mesh, m=m: ModelAxis(2, m, object()))
            monkeypatch.setattr(SH, "data_axis",
                                lambda mesh, d=d: DataAxis(2, d, object()))
            parts[d, m] = SH.shard_params(full, specs, _Mesh(), dspecs)
            assert parts[d, m]["w"].shape == (4, 3)
            assert torch.equal(parts[d, m]["w"],
                               full["w"][4 * d:4 * d + 4, 3 * m:3 * m + 3])
            assert parts[d, m]["b"] is full["b"]
    joined = torch.cat([torch.cat([parts[d, m]["w"] for d in range(2)])
                        for m in range(2)], dim=1)
    assert torch.equal(joined, full["w"])


def test_production_meshes_need_their_ranks():
    """--mesh single / multi name the ranks they need on one process."""
    for spec, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            mesh_from_arg(spec)
    with pytest.raises(ValueError, match="16 x 16"):
        make_production_mesh()

"""The port's lane-sharded sweep (a ("data",) mesh over the ranks of a
process group) against the JAX `SweepEngine` and the port's unsharded
engine: tests/test_sweep_sharded.py's cases, and the sharded cases of
test_sweep_chunked.py and test_scenario_axes.py, by name.

Every sharded run happens in 2 CPU ranks of a gloo process group
(tests/torch_dist_driver.py, which imports no JAX), all of one module's jobs
in one spawn.  The ranks replay the JAX engine's draws (`torch_parity`), so
each run is held against the JAX unsharded engine at rtol 1e-5 (params at
atol 1e-6), against the port's unsharded run at the reference's sharded
tolerance (rtol 1e-6, atol 1e-7), and bitwise under strict_numerics against
the port's unsharded strict run in the same rank.  Every rank must return
the same full result, bitwise.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core.scenario as JSC
    import repro.fl as JFL
    from sweep_testlib import defense_grid_cases, grid_cases, tiny_problem
    from test_sweep_workers import _eval_fn

import torch_dist_driver as DRV
from repro_torch.core import scenario as SC
from repro_torch.fl import ExecutionPlan, SweepEngine, SweepSpec
from repro_torch.launch.mesh import make_sweep_mesh
from torch_parity import (as_result, assert_bitwise, assert_port_close,
                          assert_ranks_agree, assert_sweeps_match, axis_grids,
                          jax_case, numpy_problem, port_sweep, run_ranks,
                          sweep_job)

ROUNDS, WORLD = 4, 2
RTOL_JAX, ATOL_JAX = 1e-5, 1e-6
RTOL_SHARD, ATOL_SHARD = 1e-6, 1e-7


@functools.lru_cache(maxsize=None)
def _problem():
    return numpy_problem(tiny_problem(rounds=ROUNDS))


def _grids(dim):
    return {"grid16": grid_cases(dim, 16), "grid13": grid_cases(dim, 13),
            "grid8": grid_cases(dim, 8),
            "defense16": defense_grid_cases(dim, 16),
            "defense13": defense_grid_cases(dim, 13),
            "axes": [jax_case(c) for c in axis_grids(dim)["mixed"]]}


BASELINE = dict(baseline=True)
# name: (grid, ExecutionPlan knobs besides the mesh, job options)
JOBS = {
    "grid16": ("grid16", {}, {}),
    "grid13": ("grid13", {}, {}),
    "grid8_strict": ("grid8", dict(strict_numerics=True), BASELINE),
    "defense16": ("defense16", {}, {}),
    "defense13": ("defense13", {}, {}),
    "defense13_switch": ("defense13", dict(grouped_dispatch=False), {}),
    "defense13_strict": ("defense13", dict(strict_numerics=True),
                         BASELINE),
    "grid13_chunked": ("grid13", dict(chunk_rounds=3, async_staging=True),
                       {}),
    "defense13_chunked": ("defense13", dict(chunk_rounds=3), {}),
    "defense13_chunked_strict": ("defense13", dict(
        chunk_rounds=2, async_staging=True, strict_numerics=True),
        BASELINE),
    "axes": ("axes", {}, {}),
    "axes_strict": ("axes", dict(strict_numerics=True), BASELINE),
    "grid13_seeded": ("grid13", {}, dict(seeded=True)),
}


def _job(name):
    grid, plan, opts = JOBS[name]
    return sweep_job(name, _grids(_problem()[2])[grid], _problem(),
                     (WORLD, 1, 1), plan, **opts)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every job of this module in one spawn of WORLD ranks."""
    return run_ranks([_job(n) for n in JOBS], WORLD,
                     tmp_path_factory.mktemp("sharded"))


def _sharded(ranks, name):
    assert_ranks_agree(ranks, name, WORLD)
    return as_result(ranks[f"{name}.r0"]), ranks[f"{name}.r0"]["layout"]


@functools.lru_cache(maxsize=None)
def _jax(grid, **plan):
    loss, params, _, batches = _problem()
    jspec = JFL.SweepSpec.build(_grids(_problem()[2])[grid])
    return JFL.SweepEngine(loss, jspec, eval_fn=_eval_fn,
                           plan=JFL.ExecutionPlan(**plan)).run(params,
                                                               batches)


def _port(name, mesh=None, **plan):
    """The port's own run of a job's lanes and draws in this process, under
    `plan` (default: the job's knobs)."""
    return port_sweep(_job(name), mesh, plan or None)


def _check(ranks, name, reference_plan=None):
    """The sharded run against the JAX unsharded engine and the port's
    unsharded run (of `reference_plan`, default the job's own knobs without
    the mesh)."""
    got, layout = _sharded(ranks, name)
    grid, knobs, _ = JOBS[name]
    ref = knobs if reference_plan is None else reference_plan
    assert_sweeps_match(got, _jax(grid, **ref), rtol=RTOL_JAX, atol=ATOL_JAX)
    assert_port_close(got, port_sweep(_job(name), plan=ref)[1], RTOL_SHARD,
                      ATOL_SHARD)
    return got, layout


def _strict(ranks, name):
    got, _ = _check(ranks, name)
    assert_bitwise(got, as_result(ranks[f"{name}.base"]))


# ---------------------------------------------------------------- 1 device

def test_single_device_mesh_matches_unsharded():
    """A one-device ("data",) mesh needs no process group and is the plain
    engine, bitwise (the analog grid, the defense grid, and the grouped
    dispatch's layout against the switch reference)."""
    for name in ("grid8_strict", "defense13"):
        _, plain = _port(name)
        engine, meshed = _port(name, mesh=make_sweep_mesh(1))
        assert engine.mesh.axis_names == ("data",)
        assert engine._lane_group is None and engine._ws is None
        assert_bitwise(meshed, plain)
    _, switch = _port("defense13", grouped_dispatch=False)
    _, grouped = _port("defense13", mesh=make_sweep_mesh(1))
    assert_port_close(grouped, switch, RTOL_SHARD, ATOL_SHARD)


def test_mesh_requires_flat_state():
    with pytest.raises(AssertionError, match="flat-state"):
        ExecutionPlan(flat_state=False, mesh=make_sweep_mesh(1))
    with pytest.warns(DeprecationWarning), pytest.raises(AssertionError):
        SweepEngine(DRV.mlp_loss, SweepSpec.build(_job("grid8_strict")[
            "cases"]), flat_state=False, mesh=make_sweep_mesh(1),
            device="cpu")


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_lane_groups_and_ghost_padding_match_the_reference(shards):
    """`build_lane_groups(codes, shards)` and `pad_lanes` are the
    reference's: per-family ghosts, shard-major order, each lane's first
    execution row."""
    codes = [c.defense.code for c in defense_grid_cases(35, 13)]
    got = SC.build_lane_groups(codes, shards)
    want = JSC.build_lane_groups(codes, shards)
    assert (got.codes, got.perm, got.inverse, got.local_slices,
            got.shards) == (want.codes, want.perm, want.inverse,
                            want.local_slices, want.shards)
    assert (got.exec_lanes, got.lanes_per_shard, got.num_ghosts) == (
        want.exec_lanes, want.lanes_per_shard, want.num_ghosts)
    x = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    total = 13 + (-13 % shards)
    np.testing.assert_array_equal(
        SC.pad_lanes(torch.from_numpy(x), total).numpy(),
        np.asarray(JSC.pad_lanes(x, total)))
    sp = SweepSpec.build(_job("grid13")["cases"]).stacked_params()
    assert SC.pad_lanes(sp, 13) is sp
    assert SC.pad_lanes(sp, 16).alpha.shape == (16,)


# ---------------------------------------------------------------- 2 ranks

def test_sharded_matches_unsharded_grid16(ranks):
    _check(ranks, "grid16")


def test_sharded_padded_s13_matches_unsharded(ranks):
    """S = 13 over 2 ranks: padded to 14 with a ghost of the last lane,
    which the result drops."""
    got, layout = _check(ranks, "grid13")
    assert layout["exec_lanes"] == 14 and layout["rows"] == list(range(7))
    assert ranks["grid13.r1"]["layout"]["rows"] == [7, 8, 9, 10, 11, 12, 12]
    assert got.loss.shape == (13, ROUNDS)


def test_sharded_strict_and_custom_keys(ranks):
    """strict_numerics with the caller's draws (the reference's custom
    keys): bitwise the unsharded strict run."""
    _strict(ranks, "grid8_strict")


def test_sharded_defense_lanes_match_unsharded(ranks):
    _check(ranks, "defense16")


def test_sharded_grouped_matches_switch_s13(ranks):
    """The grouped dispatch at S = 13 over 2 ranks, every defense family
    ghost-padded to a multiple of 2 (a median ghost runs a median lane),
    against the unsharded switch reference; and bitwise the unsharded
    grouped run under strict_numerics."""
    got, layout = _check(ranks, "defense13")
    groups = SC.build_lane_groups([c.defense.code for c in _job(
        "defense13")["cases"]], WORLD)
    assert layout["exec_lanes"] == groups.exec_lanes == 16
    assert groups.num_ghosts == 3
    assert got.loss.shape == (13, ROUNDS)
    assert_port_close(got, _port("defense13", grouped_dispatch=False)[1],
                      RTOL_SHARD, ATOL_SHARD)
    _check(ranks, "defense13_switch")
    _strict(ranks, "defense13_strict")


def test_sharded_chunked_matches_unsharded_monolithic(ranks):
    """S = 13 over 2 ranks, C = 3 over R = 4 with async staging: every
    real lane replays the unsharded monolithic engine."""
    _check(ranks, "grid13_chunked", reference_plan={})


def test_sharded_chunked_grouped_defense_grid(ranks):
    """The grouped defense grid chunked over 2 ranks against the unsharded
    monolithic engine, and bitwise under strict_numerics."""
    _check(ranks, "defense13_chunked", reference_plan={})
    _strict(ranks, "defense13_chunked_strict")


def test_all_axes_sharded_matches_unsharded(ranks):
    """The mixed adaptive-axes grid (Markov fading, K-of-U participation,
    colluding / omniscient cohorts, digital lanes) over 2 ranks: the
    Markov gains and the participation masks shard with the lanes."""
    got, layout = _check(ranks, "axes")
    assert layout["exec_lanes"] % WORLD == 0


def test_all_axes_sharded_strict_bitwise(ranks):
    _strict(ranks, "axes_strict")


def test_sharded_seeded_draws_do_not_depend_on_the_shards(ranks):
    """The default seeded draws: a lane draws from its own seed on
    whichever rank runs it, so the sharded run is the unsharded one."""
    got, _ = _sharded(ranks, "grid13_seeded")
    _, plain = _port("grid13_seeded")
    assert_port_close(got, plain, RTOL_SHARD, ATOL_SHARD)

"""The port's worker-sharded sweep (a "workers" mesh axis over the ranks of
a process group) against the JAX `SweepEngine` and the port's unsharded
engine: tests/test_sweep_workers.py's cases by name.

Each rank computes the gradients of its own ceil(U / W) workers, the stats
gather the per-worker scalars, the analog combine is an all_reduce of each
rank's weighted sum, and the digital lanes gather the full slab.  The ranks
(tests/torch_dist_driver.py, 2 and 4 CPU ranks of a gloo process group,
one spawn each) replay the JAX engine's draws: each run is held against
the JAX unsharded engine at rtol 1e-5 (params at atol 1e-6), against the
port's unsharded run at the reference's worker-sharded tolerance (rtol
5e-6, atol 1e-6: the all_reduce adds the ranks' partial sums in another
order), and bitwise under strict_numerics against the port's unsharded
strict run in the same rank.

The reference's U = 6 grid is U = 10 here: at U = 6 its CI lane's 1/|h|
inversion lifts the two frameworks' rounding differences past 1e-5 within
4 rounds (the port's unsharded run included), which would say nothing
about sharding.
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
    import repro.fl as JFL
    from test_sweep_workers import (_eval_fn, analog_cases, mixed_cases,
                                    worker_problem)

from repro_torch.fl import ExecutionPlan
from repro_torch.fl import sweep as TS
from repro_torch.launch.mesh import make_sweep_mesh, sweep_mesh_axes
from torch_parity import (as_result, assert_bitwise, assert_port_close,
                          assert_ranks_agree, assert_sweeps_match, axis_grids,
                          jax_case, numpy_problem, port_sweep, run_ranks,
                          sweep_job)

ROUNDS = 4
RTOL_JAX, ATOL_JAX = 1e-5, 1e-6
RTOL_SHARD, ATOL_SHARD = 5e-6, 1e-6
BASELINE = dict(baseline=True)


@functools.lru_cache(maxsize=None)
def _problem(u):
    return numpy_problem(worker_problem(u, rounds=ROUNDS))


def _grid(grid):
    """(U, JAX lanes) of a named grid."""
    kind, u = grid.rsplit("_", 1)
    u = int(u)
    dim = _problem(u)[2]
    if kind == "analog":
        return u, analog_cases(u, dim, 6, jam_lane=True)
    if kind == "mixed":
        return u, mixed_cases(u, dim, 8 if u == 10 else 6)
    if kind == "digital":
        return u, [c for c in mixed_cases(u, dim, 6) if c.defense.is_digital]
    assert kind == "axes" and u == 4
    return u, [jax_case(c) for c in axis_grids(dim)["mixed"]]


# name: (grid, mesh (devices, W, M), plan knobs, job options)
JOBS = {
    2: {"analog_w2": ("analog_8", (2, 2, 1), {}, {}),
        "mixed_w2": ("mixed_10", (2, 2, 1), {}, {}),
        "mixed_w2_strict": ("mixed_8", (2, 2, 1),
                            dict(strict_numerics=True), BASELINE),
        "mixed_w2_chunked": ("mixed_8", (2, 2, 1),
                             dict(chunk_rounds=3, async_staging=True), {}),
        "mixed_w2_switch": ("mixed_8", (2, 2, 1),
                            dict(grouped_dispatch=False), {}),
        "digital_w2_switch": ("digital_8", (2, 2, 1),
                              dict(grouped_dispatch=False), {}),
        "axes_w2": ("axes_4", (2, 2, 1), {}, {}),
        "axes_w2_strict": ("axes_4", (2, 2, 1), dict(strict_numerics=True),
                           BASELINE)},
    4: {"analog_dw": ("analog_8", (4, 2, 1), {}, {}),
        "analog_w4": ("analog_8", (4, 4, 1), {}, {}),
        "mixed_dw": ("mixed_10", (4, 2, 1), {}, {}),
        "nondivisible_w4": ("mixed_10", (4, 4, 1), {}, {})},
}
SPEC = {name: job for jobs in JOBS.values() for name, job in jobs.items()}


def _job(name):
    grid, mesh, plan, opts = SPEC[name]
    u, jcases = _grid(grid)
    return sweep_job(name, jcases, _problem(u), mesh, plan, **opts)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return run_ranks([_job(n) for n in JOBS[2]], 2,
                     tmp_path_factory.mktemp("workers2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks([_job(n) for n in JOBS[4]], 4,
                     tmp_path_factory.mktemp("workers4"))


@functools.lru_cache(maxsize=None)
def _jax(grid, **plan):
    u, jcases = _grid(grid)
    loss, params, _, batches = _problem(u)
    return JFL.SweepEngine(loss, JFL.SweepSpec.build(jcases),
                           eval_fn=_eval_fn,
                           plan=JFL.ExecutionPlan(**plan)).run(params,
                                                               batches)


def _check(results, name, reference_plan=None):
    """The sharded run (every rank the same) against the JAX unsharded
    engine and the port's unsharded run of `reference_plan` (default the
    job's own knobs)."""
    grid, mesh, knobs, _ = SPEC[name]
    assert_ranks_agree(results, name, mesh[0])
    got = as_result(results[f"{name}.r0"])
    ref = knobs if reference_plan is None else reference_plan
    assert_sweeps_match(got, _jax(grid, **ref), rtol=RTOL_JAX, atol=ATOL_JAX)
    assert_port_close(got, port_sweep(_job(name), plan=ref)[1], RTOL_SHARD,
                      ATOL_SHARD)
    if SPEC[name][3].get("baseline"):
        assert_bitwise(got, as_result(results[f"{name}.base"]))
    layout = results[f"{name}.r0"]["layout"]
    axes, shape = sweep_mesh_axes(*mesh)
    assert (layout["axes"], layout["shape"]) == (axes, dict(zip(axes,
                                                                shape)))
    assert layout["device_mesh"] == (axes, shape)   # the DeviceMesh's dims
    return got, layout


@pytest.mark.parametrize("name", ["analog_w2", "analog_dw", "analog_w4"])
def test_worker_sharded_matches_unsharded_analog(name, request):
    """The analog grid with a jamming lane: the all_reduce combine equals
    the unsharded combine on the ("workers",) mesh of 2 and of 4 ranks and
    the 2 x 2 ("data", "workers") mesh."""
    results = request.getfixturevalue("ranks2" if SPEC[name][1][0] == 2
                                      else "ranks4")
    _, layout = _check(results, name)
    w = SPEC[name][1][1]
    assert layout["u_loc"] == 8 // w and layout["u_pad"] == 8


def test_worker_sharded_matches_unsharded_mixed_defenses(ranks2, ranks4):
    """Mixed analog + screening lanes: the digital groups gather their
    slab, the analog group sums over the ranks (("workers",) of 2 and
    ("data", "workers") 2 x 2)."""
    _check(ranks2, "mixed_w2")
    _check(ranks4, "mixed_dw")


def test_worker_sharded_nondivisible_u_ghost_padding(ranks4):
    """U = 10 over 4 worker shards: u_loc = 3, two ghost workers (worker
    9's rows, zero coefficients) that move no real worker."""
    _, layout = _check(ranks4, "nondivisible_w4")
    assert (layout["u_loc"], layout["u_pad"]) == (3, 12)


def test_worker_sharded_strict_numerics_bitwise(ranks2):
    """Under strict_numerics every rank gathers the full slab and runs the
    unsharded math: bitwise the unsharded strict run (mixed grid and the
    adaptive-axes grid)."""
    _check(ranks2, "mixed_w2_strict")
    _check(ranks2, "axes_w2_strict")


def test_worker_sharded_composes_with_chunking_and_switch(ranks2):
    """Chunked + async-staged execution against the unsharded monolithic
    run, the switch dispatch (the mixed grid, and an all-digital grid whose
    every screen needs every worker's row)."""
    _check(ranks2, "mixed_w2_chunked", reference_plan={})
    _check(ranks2, "mixed_w2_switch")
    _check(ranks2, "digital_w2_switch")


def test_worker_sharded_adaptive_axes(ranks2):
    """Markov fading (the full-U gains on every rank), K-of-U masks and the
    omniscient cohort's honest mean, a sum of each rank's rows."""
    _check(ranks2, "axes_w2")


def test_worker_plan_validation_runs_everywhere():
    """The plan refuses worker_shards without a matching mesh; a
    one-device mesh builds no worker shards and is the plain engine."""
    with pytest.raises(ValueError, match="worker_shards"):
        ExecutionPlan(worker_shards=2)
    with pytest.raises(AssertionError, match="need 2 devices"):
        make_sweep_mesh(2, worker_shards=2)
    job = _job("mixed_w2_switch")
    engine, meshed = port_sweep(job, make_sweep_mesh(1))
    assert engine._ws is None and engine.plan.worker_shards == 1
    assert_bitwise(meshed, port_sweep(job)[1])


@pytest.mark.parametrize("index", range(4))
def test_worker_shards_slice_batch_and_coefficients(index):
    """`_WorkerShards` at U = 10 over 4 shards: each rank's batch rows (the
    ghosts worker 9's), and its coefficients (the ghosts zero)."""
    ws = TS._WorkerShards(10, 4, index, None)
    b = 2
    batch = {"x": torch.arange(10 * b * 3).reshape(10 * b, 3)}
    got = ws.local_batch(batch)["x"].reshape(3, b, 3)
    for k in range(3):
        worker = min(index * 3 + k, 9)
        assert torch.equal(got[k], batch["x"][worker * b:(worker + 1) * b])
    coeff = torch.arange(1, 21, dtype=torch.float32).reshape(2, 10)
    loc = ws.local_coeff(coeff)
    assert loc.shape == (2, 3)
    for k in range(3):
        w = index * 3 + k
        want = coeff[:, w] if w < 10 else torch.zeros(2)
        assert torch.equal(loc[:, k], want)

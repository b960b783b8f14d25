"""The port's model-sharded sweep (a "model" mesh axis over the ranks of a
process group: each rank holds a block of the flat state's columns)
against the JAX `SweepEngine` and the port's unsharded engine:
tests/test_sweep_model_sharded.py's cases and test_lm_lane.py's
model-sharded LM lane, by name.

D is zero-padded to model_shards * d_loc, d_loc a multiple of the FLOA
kernels' widest f32 load (4 columns); the gradients come off the gathered
full rows, the stats add each rank's partial sums, and the combine, the
fused step and the column-wise screens run on each rank's columns.  The
ranks (tests/torch_dist_driver.py, 2 and 4 CPU ranks of a gloo process
group, one spawn each) replay the JAX engine's draws: each run is held
against the JAX unsharded engine at rtol 1e-5 (params at atol 1e-6; the
LM lane at rtol 5e-5), against the port's unsharded run at the reference's
tolerance (rtol 5e-6, atol 1e-6; the LM lane rtol 5e-5, atol 1e-5), and
bitwise under strict_numerics against the port's unsharded strict run in
the same rank.  A chunked, checkpointed model-sharded run is stopped after
its first checkpoint on every rank and resumed by a fresh engine: bitwise
the uninterrupted run.
"""
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from test_torch_lm_lane import (ROUNDS as LM_ROUNDS, _jax_run,
                                    _port_cfg, _port_run, _problem as
                                    _lm_problem)

from repro_torch import figures as TF
from repro_torch.core import standardize as S
from repro_torch.fl import ExecutionPlan
from repro_torch.fl import sweep as TS
from repro_torch.launch.mesh import make_sweep_mesh, sweep_mesh_axes
from test_torch_workers import ROUNDS, _grid, _jax, _problem
from torch_parity import (as_result, assert_bitwise, assert_port_close,
                          assert_ranks_agree, assert_sweeps_match,
                          port_sweep, replay_numpy_draws, run_ranks,
                          sweep_job)

RTOL_JAX, ATOL_JAX = 1e-5, 1e-6
RTOL_SHARD, ATOL_SHARD = 5e-6, 1e-6
RTOL_LM, ATOL_LM = 5e-5, 1e-5
BASELINE = dict(baseline=True)


CHUNKED = dict(chunk_rounds=2)
# name: (grid, mesh (devices, W, M), plan knobs, job options)
JOBS = {
    2: {"analog_m2": ("analog_8", (2, 1, 2), {}, {}),
        "mixed_m2": ("mixed_10", (2, 1, 2), {}, {}),
        "mixed_m2_strict": ("mixed_8", (2, 1, 2),
                            dict(strict_numerics=True), BASELINE),
        "mixed_m2_switch": ("mixed_8", (2, 1, 2),
                            dict(grouped_dispatch=False), {}),
        "digital_m2_switch": ("digital_8", (2, 1, 2),
                              dict(grouped_dispatch=False), {}),
        "axes_m2": ("axes_4", (2, 1, 2), {}, {}),
        "mixed_m2_chunked": ("mixed_8", (2, 1, 2), CHUNKED,
                             dict(resume=True)),
        "mixed_m2_preempted": ("mixed_8", (2, 1, 2), CHUNKED,
                               dict(resume=True, preempt_after=1))},
    4: {"mixed_dm": ("mixed_10", (4, 1, 2), {}, {}),
        "analog_m4": ("analog_8", (4, 1, 4), {}, {}),
        "mixed_wm": ("mixed_8", (4, 2, 2), {}, {}),
        "mixed_wm_switch": ("mixed_8", (4, 2, 2),
                            dict(grouped_dispatch=False), {}),
        "axes_wm_strict": ("axes_4", (4, 2, 2), dict(strict_numerics=True),
                           BASELINE)},
}
SPEC = {name: job for jobs in JOBS.values() for name, job in jobs.items()}


def _job(name, workdir=None):
    grid, mesh, plan, opts = SPEC[name]
    u, jcases = _grid(grid)
    if workdir is not None and "chunk_rounds" in plan:
        plan = dict(plan, checkpoint_dir=str(workdir / name))
    return sweep_job(name, jcases, _problem(u), mesh, plan, **opts)


def _lm_jobs():
    """The tiny LM lane (test_torch_lm_lane.py) at model_shards = 2, with
    the JAX engine's draws, default and strict; and `run_lm_lane` (the
    example's entry point, seeded draws) at model_shards = 2."""
    _, _, jparams, batches, spec, jspec, _ = _lm_problem(LM_ROUNDS)
    cfg = _port_cfg()
    draws = replay_numpy_draws(jspec, LM_ROUNDS,
                               jspec.cases[0].floa.power.dim)
    lane = dict(kind="sweep", mesh=(2, 1, 2), loss=cfg,
                cases=list(spec.cases), params=jparams, batches=batches,
                draws=draws)
    return [dict(lane, name="lm_m2", plan={}),
            dict(lane, name="lm_m2_strict", plan=dict(strict_numerics=True),
                 baseline=True),
            dict(name="lm_entry", kind="lm_lane", mesh=(2, 1, 2), rounds=3,
                 lm=dict(cfg=cfg, seq=16), baseline=True)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    work = tmp_path_factory.mktemp("model2")
    results = run_ranks([_job(n, work) for n in JOBS[2]] + _lm_jobs(), 2,
                        work)
    results["workdir"] = work
    return results


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks([_job(n) for n in JOBS[4]], 4,
                     tmp_path_factory.mktemp("model4"))


def _check(results, name, reference_plan=None):
    """The sharded run (every rank the same) against the JAX unsharded
    engine and the port's unsharded run of `reference_plan` (default the
    job's own knobs)."""
    grid, mesh, knobs, opts = SPEC[name]
    assert_ranks_agree(results, name, mesh[0])
    got = as_result(results[f"{name}.r0"])
    ref = knobs if reference_plan is None else reference_plan
    assert_sweeps_match(got, _jax(grid, **ref), rtol=RTOL_JAX, atol=ATOL_JAX)
    assert_port_close(got, port_sweep(_job(name), plan=ref)[1], RTOL_SHARD,
                      ATOL_SHARD)
    if opts.get("baseline"):
        assert_bitwise(got, as_result(results[f"{name}.base"]))
    layout = results[f"{name}.r0"]["layout"]
    axes, shape = sweep_mesh_axes(*mesh)
    assert (layout["axes"], layout["shape"]) == (axes, dict(zip(axes,
                                                                shape)))
    assert layout["device_mesh"] == (axes, shape)   # the DeviceMesh's dims
    return got, layout


@pytest.mark.parametrize("name", ["analog_m2", "analog_m4"])
def test_model_sharded_matches_unsharded_analog(name, request):
    """The analog grid with a jamming lane over the ("model",) mesh of 2
    and of 4 ranks: the column-block combine and the partial-sum stats."""
    results = request.getfixturevalue("ranks2" if SPEC[name][1][0] == 2
                                      else "ranks4")
    _check(results, name)


def test_model_sharded_matches_unsharded_mixed_defenses(ranks2, ranks4):
    """Mixed analog + screening lanes: the column-wise screens (median,
    trimmed mean) on each rank's columns, Krum on gathered rows; the
    ("model",) mesh of 2 and the 2 x 2 ("data", "model") mesh."""
    _check(ranks2, "mixed_m2")
    _check(ranks4, "mixed_dm")


def test_model_sharded_gathers_the_state_once_a_round(ranks2):
    """The state's columns are gathered once at the start and once a round
    (the round's new state, which the next round's gradients, the eval and
    the result reuse); under strict_numerics a round runs at full width
    and keeps its full rows, so only the start gathers."""
    for r in range(2):
        assert ranks2[f"analog_m2.r{r}"]["layout"]["col_gathers"] == (
            ROUNDS + 1)
        assert ranks2[f"mixed_m2_strict.r{r}"]["layout"][
            "col_gathers"] == 1


def test_model_sharded_ghost_column_padding(ranks2):
    """D = 35 over 2 model shards: padded to 40 (2 x 4 x 5 columns), the
    ghost columns zero, no real coordinate moved."""
    _, layout = _check(ranks2, "mixed_m2")
    assert _problem(10)[2] == 35
    assert (layout["d_pad"], layout["d_loc"]) == (40, 20)
    assert TS._ModelShards(35, 2, 1, None).lo == 20
    ms = TS._ModelShards(35, 4, 3, None)
    assert (ms.d_pad, ms.d_loc, ms.lo) == (48, 12, 36)
    row = torch.arange(1, 36, dtype=torch.float32)
    assert torch.equal(ms.local_cols(row), torch.tensor([0.0] * 12))
    assert ms.col_mask("cpu").sum() == 0


def test_model_sharded_strict_numerics_bitwise(ranks2, ranks4):
    """Under strict_numerics the round runs at full width on gathered rows
    and only the carry is sliced: bitwise the unsharded strict run (the
    mixed grid over ("model",) and the adaptive-axes grid over the 2 x 2
    ("workers", "model") mesh)."""
    _check(ranks2, "mixed_m2_strict")
    _check(ranks4, "axes_wm_strict")


def test_model_sharded_three_axis_mesh_composition(ranks2, ranks4):
    """The 2 x 2 ("workers", "model") mesh: the worker-axis all_reduce
    combine and the column blocks compose, grouped and switched; the
    switch dispatch and an all-digital switched grid over ("model",)."""
    _check(ranks4, "mixed_wm")
    _check(ranks4, "mixed_wm_switch")
    _check(ranks2, "mixed_m2_switch")
    _check(ranks2, "digital_m2_switch")


def test_model_sharded_adaptive_axes(ranks2):
    """Markov fading, K-of-U masks, the colluding direction (normalised at
    the full D, then sliced) and the omniscient mean over column blocks."""
    _check(ranks2, "axes_m2")


def test_model_sharded_composes_with_chunking(ranks2):
    """Chunked model-sharded run == the unsharded monolithic run; an engine
    resuming from its checkpoint, and a run stopped on every rank right
    after its first checkpoint then resumed, are bitwise the uninterrupted
    run."""
    got, _ = _check(ranks2, "mixed_m2_chunked", reference_plan={})
    for name in ("mixed_m2_chunked", "mixed_m2_preempted"):
        assert_ranks_agree(ranks2, f"{name}.resumed", 2)
        assert_bitwise(as_result(ranks2[f"{name}.resumed.r0"]), got)
    # the checkpoint is in the unsharded layout, but its fingerprint holds
    # the model shard count: one process (model_shards = 1) refuses it
    ckpt = str(ranks2["workdir"] / "mixed_m2_chunked")
    with pytest.raises(ValueError, match="model_column_shards"):
        port_sweep(_job("mixed_m2_chunked"),
                   plan=dict(CHUNKED, checkpoint_dir=ckpt), resume=True)


def test_lm_lane_model_sharded_matches_unsharded(ranks2):
    """The tiny LM's flat state (D = 69 856) over 2 model shards: the JAX
    unsharded engine at rtol 5e-5, the port's unsharded run at rtol 5e-5 /
    atol 1e-5, bitwise under strict_numerics."""
    assert_ranks_agree(ranks2, "lm_m2", 2)
    got = as_result(ranks2["lm_m2.r0"])
    assert_sweeps_match(got, _jax_run(LM_ROUNDS), rtol=RTOL_LM, atol=ATOL_LM)
    assert_port_close(got, _port_run(LM_ROUNDS), RTOL_LM, ATOL_LM)
    assert ranks2["lm_m2.r0"]["layout"]["d_loc"] == 69856 // 2
    assert_ranks_agree(ranks2, "lm_m2_strict", 2)
    assert_bitwise(as_result(ranks2["lm_m2_strict.r0"]),
                   as_result(ranks2["lm_m2_strict.base"]))


def test_run_lm_lane_model_shards_in_two_ranks(ranks2):
    """`figures.run_lm_lane(..., model_shards=2)` (the example's
    --model-shards) in a 2-rank group: every rank returns the full result,
    the unsharded run's at rtol 5e-5 / atol 1e-5."""
    assert_ranks_agree(ranks2, "lm_entry", 2)
    got = as_result(ranks2["lm_entry.r0"])
    assert got.names == ("bev-clean", "bev-signflip", "median-signflip")
    assert_port_close(got, as_result(ranks2["lm_entry.base"]), RTOL_LM,
                      ATOL_LM)


def test_model_plan_validation_runs_everywhere():
    """The plan refuses model_shards without a matching mesh (and on the
    tree state); a one-device mesh builds no model shards and is the plain
    engine; one process cannot hold a ("model",) mesh of 2."""
    with pytest.raises(ValueError, match="model_shards"):
        ExecutionPlan(model_shards=2)
    with pytest.raises(ValueError, match="model_shards"):
        ExecutionPlan(model_shards=2, flat_state=False)
    with pytest.raises(AssertionError, match="model_shards=2"):
        make_sweep_mesh(model_shards=2)
    job = _job("mixed_m2_switch")
    engine, meshed = port_sweep(job, make_sweep_mesh(1))
    assert engine._ms is None and engine.plan.model_shards == 1
    assert_bitwise(meshed, port_sweep(job)[1])
    with pytest.raises(AssertionError, match="model_shards=2"):
        TF.run_lm_lane(2, cfg=_port_cfg(), device="cpu", model_shards=2)


def test_flat_partial_stats_add_up_to_the_row_stats():
    """`flat_partial_stats` over column blocks (ghost zeros included),
    added and finished by `stats_from_partials`, are the whole row's stats
    to f32 rounding; the blocks' sums are the grad_stats route's."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(3, 4, 35)).astype(np.float32))
    padded = torch.nn.functional.pad(g, (0, 5))
    parts = [S.flat_partial_stats(padded[..., i:i + 20].contiguous())
             for i in (0, 20)]
    s1 = parts[0][0] + parts[1][0]
    s2 = parts[0][1] + parts[1][1]
    gbar, eps2 = S.stats_from_partials(s1, s2, 35)
    want = S.flat_scalar_stats(g.contiguous())
    np.testing.assert_allclose(gbar.numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(eps2.numpy(), want[1].numpy(), rtol=1e-5)
    one = S.flat_partial_stats(g)
    np.testing.assert_allclose(one[0].numpy(), g.sum(-1).numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(one[1].numpy(), (g * g).sum(-1).numpy(),
                               rtol=1e-6)

"""The port's execution plan (`repro_torch.fl.plan`, the plan intake of
`repro_torch.fl.sweep`) against the JAX package's, and every single-device
plan route against the JAX `SweepEngine` under the same plan.

Each test restates one contract of the reference:

  - tests/test_execution_plan.py: the plan's construction rules raise the
    same exception types as the JAX plan's; the deprecated per-knob kwargs
    warn and run bitwise as the plan; plan + kwargs raises; the mesh and
    sharding knobs are refused (ROADMAP.md Queue 1 item 8);
  - tests/test_sweep_chunked.py: chunked == monolithic bitwise within the
    port for C in {1, 3, 7, 10}; async == sync bitwise; the eval schedule
    anchored to the absolute round; R = 0; the chunk iterators;
  - the `SweepEngine` docstring: switch dispatch (grouped_dispatch=False)
    and tree state (flat_state=False), default and strict_numerics, equal
    the JAX engine under the same plan at rtol 1e-5 from replayed draws, and
    within the port switch == grouped and tree == flat at rtol 1e-6,
    bitwise under strict_numerics (both hold bitwise on the CPU).

Tiny problem: tests/sweep_testlib.py's regression MLP (U = 4, D = 35) and
the grids of tests/test_torch_axes.py.  rtol 1e-5 against the JAX engine:
the frameworks sum in different orders; every lane is checked finite first.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.core.defenses as JDEF
    import repro.core.standardize as JSTD
    import repro.fl as JFL
    from jax.sharding import Mesh
    from repro.data.pipeline import FederatedSampler as JSampler
    from repro.data.pipeline import iter_chunk_blocks as j_iter_chunk_blocks
    from repro.data.synthetic_digits import make_dataset, worker_split
    from repro.fl import ExecutionPlan as JPlan
    from repro.launch.mesh import make_sweep_mesh
    from sweep_testlib import tiny_problem

import repro_torch
from repro_torch.core import defenses as TDEF
from repro_torch.core import standardize as TSTD
from repro_torch.core.power_control import Policy
from repro_torch.core.scenario import DefenseSpec
from repro_torch.data.pipeline import FederatedSampler as TSampler
from repro_torch.data.pipeline import iter_chunk_blocks
from repro_torch.fl import ExecutionPlan
from repro_torch.fl import sweep as TS
from repro_torch.kernels import ops as tops
from torch_parity import (assert_sweeps_match, axis_grids, digital, jax_case,
                          lane, replay_sweep_draws, tiny_torch_loss,
                          torch_params)

ROUNDS = 10
RTOL = 1e-5
RTOL_PORT = 1e-6


def _eval_t(p):
    return {"accuracy": p["w1"].mean()}


def _eval_j(p):
    return {"accuracy": jnp.mean(p["w1"])}


def defense_grid(dim):
    """The defense grid in miniature: a BEV lane beside every digital
    family (tests/sweep_testlib.py's DEFENSES)."""
    fams = [DefenseSpec(name="mean"), DefenseSpec(name="median"),
            DefenseSpec(name="trimmed_mean", trim=1),
            DefenseSpec(name="krum", num_byzantine=1),
            DefenseSpec(name="multi_krum", num_byzantine=1, multi=2),
            DefenseSpec(name="geometric_median")]
    return ([lane("bev", dim, Policy.BEV, 1, 500)]
            + [digital(f"{d.name}#{i}", dim, 1, 501 + i, d)
               for i, d in enumerate(fams)])


def grid(name, dim):
    return defense_grid(dim) if name == "defenses" else axis_grids(dim)[name]


def _problem(rounds=ROUNDS):
    loss, jp, dim, batches = tiny_problem(rounds=rounds)
    return loss, jp, dim, batches


def _port(cases, plan=None, eval_every=3, **kw):
    return TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(cases),
                          eval_fn=_eval_t, eval_every=eval_every,
                          plan=plan, device="cpu", **kw)


def assert_bitwise(a, b):
    """Loss, grad norm, metrics (NaN == NaN) and final params equal."""
    assert a.names == b.names
    np.testing.assert_array_equal(a.loss, b.loss)
    np.testing.assert_array_equal(a.grad_norm, b.grad_norm)
    assert set(a.metrics) == set(b.metrics)
    for k in a.metrics:
        np.testing.assert_array_equal(a.metrics[k], b.metrics[k])
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(torch.as_tensor(a.params[k]),
                           torch.as_tensor(b.params[k])), k


def assert_close(a, b, rtol):
    for run in (a, b):
        assert np.isfinite(run.loss).all() and np.isfinite(run.grad_norm).all()
    np.testing.assert_allclose(a.loss, b.loss, rtol=rtol)
    np.testing.assert_allclose(a.grad_norm, b.grad_norm, rtol=rtol)
    for k in a.params:
        np.testing.assert_allclose(a.params[k].numpy(), b.params[k].numpy(),
                                   rtol=rtol, atol=1e-7)


# ------------------------------------------------- construction-time rules


def _bad_axes_mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("lanes",))


def _bad_order_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("model", "data"))


# tests/test_execution_plan.py's bad plans, as kwargs factories (the meshes
# are JAX meshes: the port's plan reads their axis names and shape).
BAD_PLANS = {
    "chunk_zero": lambda: dict(chunk_rounds=0),
    "chunk_negative": lambda: dict(chunk_rounds=-3),
    "async_without_chunks": lambda: dict(async_staging=True),
    "mesh_needs_flat_state": lambda: dict(flat_state=False,
                                          mesh=make_sweep_mesh(1)),
    "mesh_axis_names": lambda: dict(mesh=_bad_axes_mesh()),
    "mesh_axis_order": lambda: dict(mesh=_bad_order_mesh()),
    "worker_shards_no_mesh": lambda: dict(worker_shards=4),
    "worker_shards_mesh_mismatch": lambda: dict(worker_shards=4,
                                                mesh=make_sweep_mesh(1)),
    "worker_shards_zero": lambda: dict(worker_shards=0,
                                       mesh=make_sweep_mesh(1)),
    "model_shards_no_mesh": lambda: dict(model_shards=2),
    "checkpoint_without_chunks": lambda: dict(checkpoint_dir="/tmp/ck"),
    "checkpoint_every_zero": lambda: dict(chunk_rounds=2,
                                          checkpoint_dir="/tmp/ck",
                                          checkpoint_every_chunks=0),
    "checkpoint_every_without_dir": lambda: dict(chunk_rounds=2,
                                                 checkpoint_every_chunks=3),
}


@pytest.mark.parametrize("case", sorted(BAD_PLANS))
def test_bad_plans_raise_as_the_reference(case):
    """The same exception type as the JAX plan, for each of the
    reference's bad plans."""
    with pytest.raises(Exception) as want:
        JPlan(**BAD_PLANS[case]())
    with pytest.raises(want.type):
        ExecutionPlan(**BAD_PLANS[case]())


def test_plan_fields_and_defaults_are_the_reference():
    import dataclasses
    tf = {f.name: f.default for f in dataclasses.fields(ExecutionPlan)}
    jf = {f.name: f.default for f in dataclasses.fields(JPlan)}
    assert tf == jf
    p = ExecutionPlan()
    assert (p.data_shards, p.worker_sharded, p.model_sharded) == (1, False,
                                                                  False)
    q = ExecutionPlan(chunk_rounds=2, checkpoint_dir="/tmp/ck",
                      checkpoint_every_chunks=3, async_staging=True)
    assert (q.chunk_rounds, q.checkpoint_every_chunks, q.async_staging) == (
        2, 3, True)


def test_plan_is_exported_from_fl_and_the_root():
    """As the reference exports it (tests/test_execution_plan.py)."""
    import repro_torch.fl as fl
    assert "ExecutionPlan" in fl.__all__
    assert repro_torch.ExecutionPlan is ExecutionPlan
    for name in ("SweepEngine", "SweepResult", "SweepSpec", "ScenarioCase",
                 "run_sweep", "save_pytree", "restore_pytree",
                 "latest_step"):
        assert name in repro_torch.__all__ and hasattr(repro_torch, name)


@pytest.mark.parametrize("axes", [dict(data=1), dict(workers=1),
                                  dict(data=1, workers=1, model=1)])
def test_mesh_plans_are_refused_citing_item_8(axes):
    """A JAX mesh: refused at engine construction, naming the port's own
    mesh (`launch.mesh.make_sweep_mesh`, over the ranks of a process group;
    Queue 1 item 8's sweep half, tests/test_torch_sharded.py)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(axes)),
                tuple(axes))
    cases = axis_grids(_problem(2)[2])["mixed"]
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        _port(cases, plan=ExecutionPlan(mesh=mesh))
    with pytest.raises(TypeError, match="ExecutionPlan"):
        _port(cases, plan=JPlan())


LEGACY = [dict(chunk_rounds=3), dict(flat_state=False, strict_numerics=True),
          dict(grouped_dispatch=False), dict(chunk_rounds=4,
                                             async_staging=True)]


@pytest.mark.parametrize("legacy", LEGACY, ids=lambda kw: "+".join(kw))
def test_legacy_kwargs_warn_and_match_the_plan_bitwise(legacy):
    _, jp, dim, batches = _problem(6)
    cases = axis_grids(dim)["mixed"]
    with pytest.warns(DeprecationWarning, match="plan=ExecutionPlan"):
        old = _port(cases, **legacy)
    new = _port(cases, plan=ExecutionPlan(**legacy))
    assert old.plan == new.plan
    for knob, value in legacy.items():
        assert getattr(old, knob) == value
    assert_bitwise(old.run(torch_params(jp), batches),
                   new.run(torch_params(jp), batches))


def test_run_sweep_legacy_kwargs_warn_and_match_the_plan_bitwise():
    _, jp, dim, batches = _problem(6)
    spec = TS.SweepSpec.build(axis_grids(dim)["mixed"])
    with pytest.warns(DeprecationWarning, match="plan=ExecutionPlan"):
        old = TS.run_sweep(tiny_torch_loss, torch_params(jp), batches, spec,
                           device="cpu", chunk_rounds=4, flat_state=False)
    new = TS.run_sweep(tiny_torch_loss, torch_params(jp), batches, spec,
                       plan=ExecutionPlan(chunk_rounds=4, flat_state=False),
                       device="cpu")
    assert_bitwise(old, new)


def test_plan_plus_legacy_kwargs_raises():
    _, jp, dim, batches = _problem(2)
    cases = axis_grids(dim)["mixed"]
    with pytest.raises(ValueError, match="not both"):
        _port(cases, plan=ExecutionPlan(), chunk_rounds=2)
    with pytest.raises(ValueError, match="not both"):
        TS.run_sweep(tiny_torch_loss, torch_params(jp), batches,
                     TS.SweepSpec.build(cases), plan=ExecutionPlan(),
                     device="cpu", chunk_rounds=2)


# ------------------------------------------------------------- chunking


def test_iter_chunk_blocks_partitions_exactly():
    _, _, _, batches = _problem(7)
    for c in (1, 2, 3, 7, 9):
        blocks = list(iter_chunk_blocks(batches, c))
        jblocks = list(j_iter_chunk_blocks(batches, c))
        assert len(blocks) == len(jblocks) == -(-7 // c)
        for k in batches:
            np.testing.assert_array_equal(
                np.concatenate([b[k] for b in blocks]), batches[k])
            for b, jb in zip(blocks, jblocks):
                np.testing.assert_array_equal(b[k], jb[k])
    with pytest.raises(ValueError, match="chunk_rounds"):
        next(iter_chunk_blocks(batches, 0))


def test_iter_round_chunks_replays_stack_rounds():
    """Blocks concatenate to stack_rounds(R), and to the JAX sampler's."""
    x, y = make_dataset(200, seed=0)
    shards = worker_split(x, y, 4)
    want = TSampler(shards, 3, seed=5).stack_rounds(7)
    jwant = JSampler(shards, 3, seed=5).stack_rounds(7)
    blocks = list(TSampler(shards, 3, seed=5).iter_round_chunks(7, 3))
    assert [len(b["x"]) for b in blocks] == [3, 3, 1]
    for k in want:
        got = np.concatenate([b[k] for b in blocks])
        np.testing.assert_array_equal(got, want[k])
        np.testing.assert_array_equal(got, jwant[k])


@pytest.mark.parametrize("chunk", [1, 3, 7, 10])
def test_chunked_matches_monolithic_bitwise(chunk):
    """Any C, R % C != 0 included, on the mixed grid (grouped dispatch,
    Markov carry, cohorts, K-of-U) with the default seeded draws."""
    _, jp, dim, batches = _problem()
    cases = axis_grids(dim)["mixed"]
    mono = _port(cases).run(torch_params(jp), batches)
    got = _port(cases, plan=ExecutionPlan(chunk_rounds=chunk)).run(
        torch_params(jp), batches)
    assert_bitwise(got, mono)


@pytest.mark.parametrize("plan", [dict(flat_state=False),
                                  dict(grouped_dispatch=False),
                                  dict(strict_numerics=True)],
                         ids=lambda kw: "+".join(kw))
def test_chunked_matches_monolithic_bitwise_on_every_route(plan):
    _, jp, dim, batches = _problem()
    cases = axis_grids(dim)["mixed"]
    mono = _port(cases, plan=ExecutionPlan(**plan)).run(torch_params(jp),
                                                         batches)
    got = _port(cases, plan=ExecutionPlan(chunk_rounds=3, **plan)).run(
        torch_params(jp), batches)
    assert_bitwise(got, mono)


@pytest.mark.parametrize("grid_name", ["mixed", "partial_digital"])
def test_chunked_port_matches_monolithic_jax_engine(grid_name):
    """Chunked port == the JAX engine's monolithic run, rtol 1e-5, under
    the JAX engine's replayed draws."""
    loss, jp, dim, batches = _problem()
    cases = axis_grids(dim)[grid_name]
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    want = JFL.SweepEngine(loss, jspec).run(jp, batches)
    got = TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(cases),
                         plan=ExecutionPlan(chunk_rounds=3), device="cpu"
                         ).run(torch_params(jp), batches,
                               draws=replay_sweep_draws(jspec, ROUNDS, dim))
    assert_sweeps_match(got, want)


def test_async_staging_bitwise_equal_to_sync():
    _, jp, dim, batches = _problem()
    cases = axis_grids(dim)["mixed"]
    sync = _port(cases, plan=ExecutionPlan(chunk_rounds=4)).run(
        torch_params(jp), batches)
    got = _port(cases, plan=ExecutionPlan(chunk_rounds=4,
                                          async_staging=True)).run(
        torch_params(jp), batches)
    assert_bitwise(got, sync)


def test_chunked_eval_schedule_anchored_to_absolute_round():
    """eval_every=3 with C=4: rounds 0, 3, 6, 9 (the last) evaluated,
    whatever chunk they fall in; NaN elsewhere."""
    _, jp, dim, batches = _problem()
    cases = axis_grids(dim)["mixed"]
    got = _port(cases, plan=ExecutionPlan(chunk_rounds=4)).run(
        torch_params(jp), batches)
    acc = got.metrics["accuracy"]
    evaluated = ~np.isnan(acc).all(axis=0)
    assert np.flatnonzero(evaluated).tolist() == [0, 3, 6, 9]
    assert not np.isnan(acc[:, evaluated]).any()


@pytest.mark.parametrize("plan", [dict(), dict(chunk_rounds=3),
                                  dict(flat_state=False, chunk_rounds=2)],
                         ids=["monolithic", "chunked", "tree_chunked"])
def test_zero_rounds_match_the_jax_engine(plan):
    """R = 0: params0 broadcast, [S, 0] trajectories, metrics keyed as the
    JAX engine keys them (its eval is traced, so its keys exist)."""
    loss, jp, dim, batches = _problem(3)
    empty = {k: v[:0] for k, v in batches.items()}
    cases = axis_grids(dim)["mixed"]
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    want = JFL.SweepEngine(loss, jspec, eval_fn=_eval_j,
                           plan=JPlan(**plan)).run(jp, empty)
    got = _port(cases, plan=ExecutionPlan(**plan)).run(torch_params(jp),
                                                        empty)
    s = len(cases)
    assert got.loss.shape == got.grad_norm.shape == np.shape(want.loss) == (
        s, 0)
    assert set(got.metrics) == set(want.metrics) == {"accuracy"}
    for k in want.metrics:
        assert got.metrics[k].shape == np.shape(want.metrics[k])
    assert set(got.params) == set(want.params)
    for k in want.params:
        np.testing.assert_array_equal(got.params[k].numpy(),
                                      np.asarray(want.params[k]))
        np.testing.assert_array_equal(
            got.params[k].numpy(),
            np.broadcast_to(np.asarray(jp[k]), (s,) + jp[k].shape))


# -------------------------------------- switch dispatch and tree state


PLAN_ROUTES = {
    "switch": dict(grouped_dispatch=False),
    "switch_strict": dict(grouped_dispatch=False, strict_numerics=True),
    "tree": dict(flat_state=False),
    "tree_strict": dict(flat_state=False, strict_numerics=True),
    "tree_switch": dict(flat_state=False, grouped_dispatch=False),
    "strict": dict(strict_numerics=True),
}


@pytest.mark.parametrize("grid_name", ["defenses", "partial_digital",
                                       "mixed", "markov"])
@pytest.mark.parametrize("route", sorted(PLAN_ROUTES))
def test_plan_routes_match_the_jax_engine(route, grid_name):
    """Each plan route equals the JAX engine under the same plan, rtol
    1e-5, from the JAX engine's replayed draws: the defense grid and the
    masked (K-of-U) digital grid for the switch, the mixed and the
    all-analog Markov grids for the tree state."""
    loss, jp, dim, batches = _problem(5)
    cases = grid(grid_name, dim)
    plan = PLAN_ROUTES[route]
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    want = JFL.SweepEngine(loss, jspec, plan=JPlan(**plan)).run(jp, batches)
    tops.reset_launches()
    got = TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(cases),
                         plan=ExecutionPlan(**plan), device="cpu").run(
        torch_params(jp), batches, draws=replay_sweep_draws(jspec, 5, dim))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert_sweeps_match(got, want)


@pytest.mark.parametrize("grid_name", ["defenses", "partial_digital",
                                       "mixed", "markov"])
@pytest.mark.parametrize("strict", [False, True], ids=["default", "strict"])
def test_switch_and_tree_match_grouped_flat_within_the_port(grid_name,
                                                            strict):
    """switch == grouped and tree == flat (and tree + switch == flat +
    grouped): rtol 1e-6 by default, bitwise under strict_numerics."""
    _, jp, dim, batches = _problem()
    cases = grid(grid_name, dim)
    ref = _port(cases, plan=ExecutionPlan(strict_numerics=strict)).run(
        torch_params(jp), batches)
    for other in (dict(grouped_dispatch=False), dict(flat_state=False),
                  dict(flat_state=False, grouped_dispatch=False)):
        got = _port(cases, plan=ExecutionPlan(strict_numerics=strict,
                                              **other)).run(
            torch_params(jp), batches)
        if strict:
            assert_bitwise(got, ref)
        else:
            assert_close(got, ref, RTOL_PORT)


@pytest.mark.parametrize("masked", [False, True])
def test_switch_selector_matches_the_reference(masked):
    """make_flat_defense_selector against the JAX selector under vmap on
    every family (codes outside the list take the first branch)."""
    rng = np.random.default_rng(3)
    s, u, d = 8, 6, 33
    flat = rng.standard_normal((s, u, d)).astype(np.float32)
    codes = np.array([1, 2, 3, 4, 5, 6, 0, 2], np.int32)
    trim = np.array([0, 0, 1, 0, 0, 0, 0, 0], np.int32)
    f = np.array([0, 0, 0, 1, 1, 0, 0, 0], np.int32)
    multi = np.array([1, 1, 1, 1, 2, 1, 1, 1], np.int32)
    mask = np.ones((s, u), bool)
    if masked:
        mask[:, 0] = False
        mask[1::2, 3] = False
    listed = [1, 2, 3, 4, 5, 6]
    jsel = JDEF.make_flat_defense_selector(listed, gm_iters=4, masked=masked)
    tsel = TDEF.make_flat_defense_selector(listed, gm_iters=4, masked=masked)
    jargs = [jnp.asarray(a) for a in (codes, flat, trim, f, multi)]
    targs = [torch.from_numpy(a) for a in (codes, flat, trim, f, multi)]
    if masked:
        jargs.append(jnp.asarray(mask))
        targs.append(torch.from_numpy(mask))
    want = np.asarray(jax.vmap(jsel)(*jargs))
    got = tsel(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL_PORT, atol=1e-6)


# --------------------------------------------- strict (segmented) stats


def test_segmented_stats_match_the_reference_and_the_per_leaf_sums():
    """flat_scalar_stats(flat, sizes): the JAX segmented stats at rtol
    1e-6 with atol 1e-7 (a row's mean is a sum of ~100 draws with mean
    near 0, which cancels: its rounding is absolute, ~1e-8), and bitwise
    the port's per-leaf `per_worker_scalar_stats` (the tree path's sums),
    at every row offset of a wider slab."""
    rng = np.random.default_rng(4)
    shapes = {"b1": (7,), "b2": (3,), "w1": (5, 7), "w2": (7, 3)}
    leaves = {k: rng.standard_normal((3, 4) + sh).astype(np.float32)
              for k, sh in shapes.items()}
    sizes = [int(np.prod(shapes[k])) for k in sorted(shapes)]
    flat = np.concatenate([leaves[k].reshape(3, 4, -1)
                           for k in sorted(shapes)], axis=-1)
    got = TSTD.flat_scalar_stats(torch.from_numpy(flat), sizes)
    want = jax.vmap(lambda g: JSTD.flat_scalar_stats(g, sizes))(
        jnp.asarray(flat))
    tree = TSTD.per_worker_scalar_stats(
        {k: torch.from_numpy(v) for k, v in leaves.items()}, batch_dims=2)
    for g, w, t in zip(got, want, tree):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_PORT,
                                   atol=1e-7)
        assert torch.equal(g, t)
    # a lane group's rows of the slab (another row offset): the same bits
    sub = TSTD.flat_scalar_stats(torch.from_numpy(flat)[1:], sizes)
    for g, s_ in zip(got, sub):
        assert torch.equal(g[1:], s_)
    with pytest.raises(ValueError, match="leaf sizes"):
        TSTD.flat_scalar_stats(torch.from_numpy(flat), sizes[:-1])


def test_fixed_order_grad_stats_takes_row_strided_views():
    """The fixed-order route on a leaf segment's row-strided view equals
    the plain version on a contiguous copy (the CPU route), and refuses
    overlapping rows."""
    x = torch.randn(6, 40, generator=torch.Generator().manual_seed(0))
    seg = x[:, 5:22]
    got = tops.grad_stats_fixed(seg)
    assert torch.equal(got, tops.grad_stats_ref(seg.contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        tops.grad_stats(seg)
    with pytest.raises(ValueError, match="overlap"):
        tops.grad_stats_fixed(x.as_strided((6, 10), (3, 1)))


def test_per_worker_scalar_stats_batched_matches_the_reference():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((2, 3, 4, 5)).astype(np.float32),
             "b": rng.standard_normal((2, 3, 6)).astype(np.float32)}
    got = TSTD.per_worker_scalar_stats(
        {k: torch.from_numpy(v) for k, v in grads.items()}, batch_dims=2)
    want = jax.vmap(JSTD.per_worker_scalar_stats)(
        {k: jnp.asarray(v) for k, v in grads.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_PORT)

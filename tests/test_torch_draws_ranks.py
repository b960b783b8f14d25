"""The train step's own seeded draws on gloo CPU ranks: one spawn of 2
ranks (tests/torch_dist_driver.py) runs the f32 smoke qwen3-4b on (2, 1),
FSDP over "data" at a lowered size (so the noise of most leaves is drawn
by "data" part), and on (1, 2) (drawn by "model" part), 2 BEV steps each:

- with the step's own draws (`draws=None`: the gains and the noise from
  the counter-based stream keyed by the step index);
- with the one-process run's draws replayed: the same gains, and each
  leaf's noise the stream's draw of the WHOLE leaf (`kernels.philox.
  normal`), of which each rank takes its part.

The two equal bit for bit on every rank, gathered params and stats: what a
rank draws for its part is the one-process draw's slice.  Both stand
within the rank tests' rtol 1e-5 / atol 1e-6 of the one-process run with
its own draws (`WorkerAxes.every(2)` for (2, 1), no mesh for (1, 2)): the
gradients' sums run in another order over ranks, so the params cannot be
bitwise there, but a noise drawn apart from the one-process stream would
stand about alpha * scale ~ 1e-5 absolute away.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.configs import get_smoke
from repro_torch.kernels import philox as P
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import WorkerAxes
from repro_torch.tree import tree_leaves, tree_map

ARCH, BATCH, SEQ, STEPS, ALPHA = "qwen3-4b", 4, 8, 2, 0.02
RTOL, ATOL = 1e-5, 1e-6
AXES = ("data", "model")
MESHES = {"d21": (2, 1), "m12": (1, 2)}


def _cfg():
    return dataclasses.replace(get_smoke(ARCH), dtype=torch.float32)


def _tokens(cfg):
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                          generator=gen, dtype=torch.int32).numpy()
            for _ in range(STEPS)]


def _whole_draws(cfg, u):
    """The one-process run's draws of each step: its gains
    (`philox.rayleigh_gains`), and every leaf's noise drawn whole from the
    stream."""
    channel = ST.default_floa(WorkerAxes.every(u),
                              ST.param_count(cfg))["channel"]
    shapes = [tuple(x.shape) for x in tree_leaves(
        ST.init_model(cfg, None, "meta"))]
    return [{"h_abs": P.rayleigh_gains(t, channel.sigmas()).numpy(),
             "z": [P.normal(P.Draw(t, i, P.Part.whole(sh)), "cpu").numpy()
                   for i, sh in enumerate(shapes)]}
            for t in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    params = ST.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    params0 = tree_map(lambda x: x.numpy(), params)
    tokens = _tokens(cfg)
    jobs = []
    for name, shape in MESHES.items():
        base = dict(kind="train_step", mesh=(shape, AXES), arch=ARCH,
                    config={"dtype": torch.float32}, params0=params0,
                    tokens=tokens, extra=None, policy="bev", use_floa=True,
                    alpha=ALPHA, batch=BATCH, seq=SEQ, fsdp_min_size=2048)
        jobs += [dict(base, name=name, draws=None),
                 dict(base, name=name + "_replay",
                      draws=_whole_draws(cfg, shape[0]))]
    res = run_ranks(jobs, 2, tmp_path_factory.mktemp("draws_ranks"))
    one = {}
    for name, (u, _) in MESHES.items():
        step, _ = ST.make_train_step(
            cfg, WorkerAxes.every(u) if u > 1 else None,
            dict(global_batch=BATCH, seq_len=SEQ, kind="train"),
            alpha=ALPHA)
        p, state = params, ST.init_floa_state()
        for t, toks in enumerate(tokens):
            p, state, _ = step(p, state, {"tokens": torch.as_tensor(toks)},
                               t)
        one[name] = (p, state)
    return res, one


@pytest.mark.parametrize("name", list(MESHES))
def test_seeded_ranks_equal_the_whole_draw_replayed(runs, name):
    """The ranks' own draws are the one-process stream's, bit for bit:
    gathered params and stats equal the run replaying the whole-leaf
    draws, on every rank."""
    res, _ = runs
    assert_ranks_agree(res, name, 2, skip=("worker", "model"))
    for r in range(2):
        got, want = res[f"{name}.r{r}"], res[f"{name}_replay.r{r}"]
        assert_trees_equal(got["params"], want["params"], "params")
        for a, b in zip(got["log"], want["log"]):
            for k in ("gbar", "eps2", "loss", "grad_scale"):
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(MESHES))
def test_seeded_ranks_match_the_one_process_run(runs, name):
    """The ranks' seeded run within rtol 1e-5 / atol 1e-6 of the one-process
    seeded run, params and stale stats."""
    res, one = runs
    p1, s1 = one[name]
    got = res[f"{name}.r0"]
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    for k in ("gbar", "eps2"):
        np.testing.assert_allclose(got["log"][-1][k].numpy(),
                                   s1[k].numpy(), rtol=RTOL, atol=ATOL)

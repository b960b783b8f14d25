"""The real-model LM lane of the port (`figures.run_lm_lane`, `SweepEngine`
over the nested qwen3-shaped parameter tree) against the JAX
`SweepEngine`.

`test_lm_lane.py`'s tiny lane (the lm_sweep config shrunk to D = 69 856;
U = 8 workers of 2 sequences of 48 tokens, 3 attackers, lr 0.3): clean
BEV, the Thm-1 sign-flip attack under CI, and median screening of the same
attack.  Both engines start from the weights of JAX `init_lm(PRNGKey(0))`
(`params_from_jax`), take the same Markov token batches, and the port
replays the JAX engine's per-round draws (`torch_parity`).  6 rounds, rtol
1e-5 on loss, grad norm and the final params leaf by leaf: the flat state,
the tree state (`flat_state=False`) and the chunked plan (chunk_rounds=3,
bitwise equal to the monolithic run).  Then the LM lane's `SweepResult`
read by the other package both ways, and the paper MLP's flat-dict sweep
bitwise as before the tree repair.  The longer runs on the same lane
(the 30-round separation claims, a resumed tree-state run, `run_lm_lane`
on the CPU) are tests/test_torch_lm_lane_runs.py, which takes this
module's helpers.
"""
import dataclasses
import functools
import math
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.fl as JFL
    from repro.checkpoint import read_tree as jread_tree
    from repro.configs import registry as JR
    from repro.models import transformer as JT
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_lm_lane import BATCH, LR, N_ATK, SEQ, U, tiny_lm_cfg

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP as TPAPER
from repro_torch.configs import registry as TR
from repro_torch.core.aggregation import FLOAConfig
from repro_torch.core.attacks import AttackConfig, AttackType, first_n_mask
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.power_control import Policy, PowerConfig
from repro_torch.core.scenario import DefenseSpec
from repro_torch.data import stack_token_rounds
from repro_torch.fl import ExecutionPlan
from repro_torch.fl import sweep as TS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths
from torch_parity import assert_sweeps_match, jax_case, replay_sweep_draws

ROUNDS, ROUNDS_LONG = 6, 30
TINY = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256)     # test_lm_lane.py::tiny_lm_cfg
# The final params of an LM lane are ~0.05-0.2 in scale: 1e-5 of that.
PARAMS_ATOL = 1e-6


def _port_cfg():
    return dataclasses.replace(TR.get_lm_sweep(), **TINY)


def _cases(dim):
    """test_lm_lane.py::lm_problem's three lanes in the port."""
    def floa(policy, attack, n, noise=0.05):
        return FLOAConfig(
            channel=ChannelConfig(num_workers=U, sigma=1.0,
                                  noise_std=0.0 if policy == Policy.EF
                                  else noise),
            power=PowerConfig(num_workers=U, dim=dim, p_max=1.0,
                              policy=policy),
            attack=AttackConfig(attack=attack if n else AttackType.NONE,
                                byzantine_mask=first_n_mask(U, n)))

    return [
        TS.ScenarioCase("clean", floa(Policy.BEV, AttackType.NONE, 0), LR,
                        seed=1),
        TS.ScenarioCase("signflip", floa(Policy.CI, AttackType.STRONGEST,
                                         N_ATK), LR, seed=2),
        TS.ScenarioCase("median", floa(Policy.EF, AttackType.STRONGEST,
                                       N_ATK, noise=0.0), LR, seed=3,
                        defense=DefenseSpec(name="median"))]


@functools.lru_cache(maxsize=None)
def _problem(rounds):
    """(port loss, port params0, JAX params0, batches, port spec, JAX spec,
    replayed draws) of the tiny lane."""
    jcfg, tcfg = tiny_lm_cfg(), _port_cfg()
    dim = TR.flat_param_dim(tcfg)
    assert dim == JR.flat_param_dim(jcfg)
    cases = _cases(dim)
    jspec = JFL.SweepSpec.build([jax_case(c) for c in cases])
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    batches = {"tokens": stack_token_rounds(rounds, U * BATCH, SEQ + 1,
                                            tcfg.vocab_size, seed=0)}
    return ((lambda p, b: TT.lm_loss(p, b, tcfg)),
            TT.params_from_jax(jparams, "cpu"), jparams, batches,
            TS.SweepSpec.build(cases), jspec,
            replay_sweep_draws(jspec, rounds, dim))


@functools.lru_cache(maxsize=None)
def _jax_run(rounds):
    jcfg = tiny_lm_cfg()
    _, _, jparams, batches, _, jspec, _ = _problem(rounds)
    return JFL.SweepEngine(lambda p, b: JT.lm_loss(p, b, jcfg), jspec).run(
        jparams, batches)


def _port_run(rounds, plan=None, **engine_kw):
    loss, params0, _, batches, spec, _, draws = _problem(rounds)
    return TS.SweepEngine(loss, spec, plan=plan, device="cpu",
                          **engine_kw).run(params0, batches, draws=draws)


def _bitwise(a, b):
    assert np.array_equal(a.loss, b.loss)
    assert np.array_equal(a.grad_norm, b.grad_norm)
    assert tree_paths(a.params) == tree_paths(b.params)
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a.params), tree_leaves(b.params)))


@pytest.mark.parametrize("route", ["flat", "tree", "chunked"])
def test_lm_lane_matches_jax_engine(route):
    plan = {"flat": None, "tree": ExecutionPlan(flat_state=False),
            "chunked": ExecutionPlan(chunk_rounds=3)}[route]
    got = _port_run(ROUNDS, plan)
    assert got.loss.shape == (3, ROUNDS)
    assert tree_paths(got.params)[:2] == ["blocks/b0/attn/k_norm",
                                         "blocks/b0/attn/q_norm"]
    assert_sweeps_match(got, _jax_run(ROUNDS), atol=PARAMS_ATOL)
    if route == "chunked":
        _bitwise(got, _port_run(ROUNDS))


def test_lm_lane_result_read_by_both_packages(tmp_path):
    """An LM lane's SweepResult (nested params) written by each package
    reads back in the other byte for byte, the tree intact."""
    got, want = _port_run(ROUNDS), _jax_run(ROUNDS)
    got.save(str(tmp_path / "port"))
    tree, meta = jread_tree(str(tmp_path / "port"))
    assert meta["extra"]["names"] == list(got.names)
    jleaves = jax.tree_util.tree_leaves(tree["params"])
    assert len(jleaves) == len(tree_leaves(got.params))
    for a, b in zip(jleaves, tree_leaves(got.params)):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    np.testing.assert_array_equal(np.asarray(tree["loss"]), got.loss)
    want.save(str(tmp_path / "jax"))
    back = TS.SweepResult.load(str(tmp_path / "jax"))
    assert back.names == tuple(want.names)
    assert tree_paths(back.params) == tree_paths(got.params)
    for a, b in zip(tree_leaves(back.params),
                    jax.tree_util.tree_leaves(want.params)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


# ------------------------------------- the tree repair leaves flat dicts be


def _old_stack_params(params, num):
    return {k: v[None].expand(num, *v.shape) for k, v in params.items()}


def _old_make_row_unflatten(template):
    keys = sorted(template)
    shapes = [tuple(template[k].shape) for k in keys]
    sizes = tuple(math.prod(s) for s in shapes)

    def unflatten_row(w):
        out, off = {}, 0
        for k, shape, n in zip(keys, shapes, sizes):
            out[k] = w[..., off:off + n].reshape(*w.shape[:-1], *shape)
            off += n
        return out

    return unflatten_row, sizes


def _old_flatten_worker_grads(grads_u, batch_dims=1):
    keys = sorted(grads_u)
    lead = grads_u[keys[0]].shape[:batch_dims]
    shapes = {k: grads_u[k].shape[batch_dims:] for k in keys}
    dtypes = {k: grads_u[k].dtype for k in keys}
    flat = torch.cat([grads_u[k].reshape(*lead, -1).float() for k in keys],
                     dim=-1)

    def unflatten(vec):
        out, off = {}, 0
        for k in keys:
            n = shapes[k].numel()
            out[k] = (vec[..., off:off + n]
                      .reshape(*vec.shape[:-1], *shapes[k]).to(dtypes[k]))
            off += n
        return out

    return flat, unflatten


@pytest.mark.parametrize("flat_state", [True, False])
def test_mlp_flat_dict_sweep_bitwise_as_before_the_tree_repair(
        monkeypatch, flat_state):
    """Fig. 3's lanes on the paper MLP (a flat dict): the engine with the
    nested-tree helpers equals, bit for bit, the engine with the flat-dict
    helpers it had before (restored here by monkeypatching)."""
    mc = dataclasses.replace(TPAPER.smoke(), d_hidden=16)
    exps = [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                          attacker_sigma=3.0, rounds=4)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    plan = ExecutionPlan(flat_state=flat_state)

    def run():
        engine, params, batches = TF.figure_engine(exps, mc=mc, device="cpu",
                                                   plan=plan)
        return engine.run(params, batches)

    new = run()
    monkeypatch.setattr(TS, "stack_params", _old_stack_params)
    monkeypatch.setattr(TS, "make_row_unflatten", _old_make_row_unflatten)
    monkeypatch.setattr(TS, "flatten_worker_grads", _old_flatten_worker_grads)
    old = run()
    _bitwise(new, old)

"""The port's LM steps over a "model" axis (tensor parallelism) against the
JAX package: `launch.steps` with a `launch.mesh.SweepMesh` of ("data",
"model") axes over gloo CPU ranks (tests/torch_dist_driver.py's LM-step
jobs), each rank holding its shards of the weights (`launch.sharding`).

One JAX subprocess on 8 host devices (`JAX_REF`) runs the reference on the
same mesh shapes, its config `dataclasses.replace(get_smoke(arch),
model_parallel=M)` as tests/test_distributed.py:55 builds it: the FLOA
train step of the smoke qwen3-4b (f32, B = 8, 3 steps) on (1, 2) and
(2, 2) for BEV, CI, EF and use_floa=False, on (4, 2) for BEV with one
strongest attacker (U = 4) and on (1, 4), where KV 2 < M and wk / wv split
d; the smoke moonshot (MoE) on (1, 2) and (2, 2), and with
impl="capacity_gather" on (1, 2); deepseek-v2-236b (MLA + MoE) on (1, 2),
and mamba2-1.3b (SSD) and recurrentgemma-9b (RG-LRU + local attention)
on (1, 2) and (1, 4) (B = 4, BEV); the qwen3 prefill on (1, 4); the
one-device decode of the smoke qwen3-4b, of starcoder2-3b (72 steps into
its 64-slot ring), of deepseek and mamba2 (10 steps), and of
recurrentgemma (40 steps, past its 32-slot local ring).  It replays each train step's draws (gains off
PRNGKey(t)'s first key, leaf i's noise off fold_in(second key, i), at the
leaf's full shape), which the port's ranks slice.  Then one spawn of 2
ranks, one of 4 and one of 8:

- the train step: params (gathered), gbar, eps2 and the metrics at rtol
  1e-5 / atol 1e-6; every rank's gathered params bitwise equal (the model
  replicas of the workers, and each replicated leaf across the model
  ranks);
- the MoE, MLA, SSD and RG-LRU at the same tolerance; prefill at rtol
  1e-5, decode at rtol 1e-4 against the one-device step (MLA, SSD and
  the hybrid on their model meshes too); greedy `serve` on (1, 2) gives
  the one-process tokens;
- the vocab-parallel CE and the embed / lm_head gradients at M = 2 and 4
  against the unsharded `chunked_ce` at rtol 1e-6;
- the layout: `param_specs` and the caches of `init_caches(...,
  model_parallel=M)` against the reference's spec trees (in this process,
  shapes only), `shard_params` / `gather_params` and `init_model` on a
  mesh bitwise, the worker and model axes;
- the training entry point with `--mesh 2x2` on 4 torchrun-style ranks,
  its checkpoint read back by the JAX package as the whole tree.

Marked slow, as tests/test_torch_lm_mesh.py is.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
from jax.sharding import PartitionSpec
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro import checkpoint as JCK
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke as jget_smoke
    from repro.launch.sharding import cache_specs as jcache_specs
    from repro.models import transformer as JT

from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.power_control import Policy
from repro_torch.data import sample_tokens
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import WorkerAxes
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import param_specs
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
DECODE_RTOL, CE_RTOL = 1e-4, 1e-6
STEPS, BATCH, SEQ, ALPHA = 3, 8, 16, 0.02
ROUTES = [("bev", True), ("ci", True), ("ef", True), ("bev", False)]
AXES = ("data", "model")
TRAIN_CASES = {   # name: (mesh shape, routes, arch, moe impl, batch)
    "m12": ((1, 2), ROUTES, "qwen3-4b", None, BATCH),
    "m22": ((2, 2), ROUTES, "qwen3-4b", None, BATCH),
    "m42": ((4, 2), [("bev", True)], "qwen3-4b", None, BATCH),
    "m14": ((1, 4), [("bev", True)], "qwen3-4b", None, BATCH),
    "moe12": ((1, 2), [("bev", True)], "moonshot-v1-16b-a3b", None, 4),
    "moe22": ((2, 2), [("bev", True)], "moonshot-v1-16b-a3b", None, 4),
    "cap12": ((1, 2), [("bev", True)], "moonshot-v1-16b-a3b",
              "capacity_gather", 4),
    "ds12": ((1, 2), [("bev", True)], "deepseek-v2-236b", None, 4),
    "mb12": ((1, 2), [("bev", True)], "mamba2-1.3b", None, 4),
    "mb14": ((1, 4), [("bev", True)], "mamba2-1.3b", None, 4),
    "rg12": ((1, 2), [("bev", True)], "recurrentgemma-9b", None, 4),
    "rg14": ((1, 4), [("bev", True)], "recurrentgemma-9b", None, 4),
}
SPAWNS = {2: ("m12", "moe12", "cap12", "ds12", "mb12", "rg12"),
          4: ("m22", "m14", "moe22", "mb14", "rg14"), 8: ("m42",)}
# the one-device decode of the MLA, SSD and RG-LRU archs, against their
# model-axis decodes: (arch, meshes)
MLA_SSM_DECODE = {"deepseek-v2-236b": ((1, 2),),
                  "mamba2-1.3b": ((1, 2), (1, 4)),
                  "recurrentgemma-9b": ((1, 2), (1, 4))}
# decode steps of each of them: recurrentgemma's run past its 32-slot ring
DECODE_STEPS = {"deepseek-v2-236b": 10, "mamba2-1.3b": 10,
                "recurrentgemma-9b": 40}
SERVE = dict(batch=4, prompt_len=8, gen=8, seed=3)
PREFILL = dict(batch=4, seq=24, seed=9)
QWEN_DECODE = dict(batch=4, n=12, seed=5)
MODEL_SIZES = (2, 4, 16)

JAX_REF = textwrap.dedent("""
    import dataclasses, pickle, sys, warnings
    import numpy as np
    import jax
    import jax.numpy as jnp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.configs import get_smoke
        from repro.core.channel import sample_channel_gains
        from repro.core.power_control import Policy
        from repro.data import sample_tokens
        from repro.launch import steps as S
        from repro.launch.mesh import make_debug_mesh
        from repro.models import transformer as T

    STEPS, SEQ, ALPHA = {steps}, {seq}, {alpha}
    AXES = ("data", "model")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


    def config(arch, m, impl=None):
        cfg = dataclasses.replace(get_smoke(arch), model_parallel=m)
        if impl:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=impl))
        return cfg


    def draws(mesh, dim, leaves):
        channel = S.default_floa(mesh, dim)["channel"]
        out = []
        for t in range(STEPS):
            k_ch, k_z = jax.random.split(jax.random.PRNGKey(t))
            out.append({{
                "h_abs": np.asarray(sample_channel_gains(k_ch, channel)),
                "z": [np.asarray(jax.random.normal(
                    jax.random.fold_in(k_z, i), x.shape, jnp.float32))
                    for i, x in enumerate(leaves)]}})
        return out


    def train(shape, routes, arch, impl, batch):
        cfg = config(arch, shape[1], impl)
        params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
        mesh = make_debug_mesh(shape, AXES)
        toks = [sample_tokens(batch, SEQ + 1, vocab=cfg.vocab_size, seed=t)
                for t in range(STEPS)]
        res = {{"params0": np_tree(params), "tokens": toks}}
        for policy, use_floa in routes:
            art = S.make_train_step(
                cfg, mesh, dict(global_batch=batch, seq_len=SEQ,
                                kind="train"),
                policy=Policy(policy), alpha=ALPHA, use_floa=use_floa)
            p, state, log = params, S.init_floa_state(), []
            with mesh:
                fn = jax.jit(art.fn, in_shardings=art.in_shardings)
                for t in range(STEPS):
                    p, state, m = fn(p, state,
                                     {{"tokens": jnp.asarray(toks[t])}},
                                     jnp.uint32(t))
                    log.append({{**np_tree(state), **np_tree(m)}})
            res[(policy, use_floa)] = {{"params": np_tree(p), "log": log,
                                       "meta": art.meta}}
        res["draws"] = draws(mesh, art.meta["dim"],
                             jax.tree_util.tree_leaves(params))
        return res


    def decode(arch, batch, n, seed):
        cfg = get_smoke(arch)
        params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
        toks = sample_tokens(batch, n, vocab=cfg.vocab_size, seed=seed)
        caches = T.init_caches(cfg, batch, n, window=cfg.window)
        step = jax.jit(lambda p, c, t, pos: T.decode_step(
            p, c, t, pos, cfg, window=cfg.window))
        logits = []
        for i in range(n):
            lg, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]),
                              jnp.int32(i))
            logits.append(np.asarray(lg[:, 0]))
        return {{"params0": np_tree(params), "tokens": toks,
                "logits": np.stack(logits)}}


    out = {{name: train(*case) for name, case in {cases}.items()}}

    b, s, seed = {prefill}
    cfg = config("qwen3-4b", 4)
    params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
    mesh = make_debug_mesh((1, 4), AXES)
    art = S.make_prefill_step(cfg, mesh, dict(global_batch=b, seq_len=s,
                                              kind="prefill"))
    toks = sample_tokens(b, s, vocab=cfg.vocab_size, seed=seed)
    with mesh:
        logits = jax.jit(art.fn, in_shardings=art.in_shardings)(
            params, {{"tokens": jnp.asarray(toks)}})
    out["prefill"] = {{"params0": np_tree(params), "tokens": toks,
                      "logits": np.asarray(logits)}}
    out["decode_qwen"] = decode("qwen3-4b", *{qwen_decode})
    sc = get_smoke("starcoder2-3b")
    out["decode_sc"] = decode("starcoder2-3b", 8, sc.window + 8, 3)
    for arch, n in {decode_steps}.items():
        out["decode_" + arch] = decode(arch, 4, n, 5)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    print("JAX_REF_OK", flush=True)
""").format(steps=STEPS, seq=SEQ, alpha=ALPHA, cases=TRAIN_CASES,
            prefill=tuple(PREFILL.values()),
            qwen_decode=tuple(QWEN_DECODE.values()),
            decode_steps=DECODE_STEPS)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`JAX_REF`), run once in a subprocess with
    8 host devices."""
    path = tmp_path_factory.mktemp("jax_ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", JAX_REF, str(path)],
                       capture_output=True, text=True, timeout=900, env=env,
                       cwd=ROOT)
    assert r.returncode == 0 and "JAX_REF_OK" in r.stdout, (
        r.stdout[-3000:] + r.stderr[-3000:])
    with open(path, "rb") as f:
        return pickle.load(f)


def _train_jobs(ref, name):
    shape, routes, arch, impl, batch = TRAIN_CASES[name]
    return [dict(name=f"{name}_{p}_{f}", kind="train_step",
                 mesh=(shape, AXES), arch=arch, moe_impl=impl,
                 params0=ref[name]["params0"], tokens=ref[name]["tokens"],
                 draws=ref[name]["draws"], policy=p, use_floa=f,
                 alpha=ALPHA, batch=batch, seq=SEQ) for p, f in routes]


def _mla_ssm_decode_jobs(ref, world):
    """The MLA, SSD and RG-LRU decode jobs on the meshes of `world`
    ranks."""
    return [dict(name=f"decode_{arch}_{shape[1]}", kind="decode",
                 mesh=(shape, AXES), arch=arch,
                 params0=ref["decode_" + arch]["params0"],
                 tokens=ref["decode_" + arch]["tokens"])
            for arch, shapes in MLA_SSM_DECODE.items() for shape in shapes
            if shape[0] * shape[1] == world]


def _ce_inputs(m, tied):
    """A config whose vocab is off the 256 grid (the padding ids on the
    last rank) and whose head runs in chunks of 4 positions, its embed /
    lm_head, hidden states, labels (some at the top of the vocab) and the
    embedding's weights."""
    cfg = dataclasses.replace(get_smoke("qwen3-4b"), vocab_size=500,
                              lm_head_chunk=4, tie_embeddings=tied)
    g = np.random.default_rng(m + 10 * tied)
    vp, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": g.standard_normal((vp, d)).astype(np.float32) * .05}
    if not tied:
        params["lm_head"] = g.standard_normal((d, vp)).astype(np.float32) * .05
    labels = g.integers(0, cfg.vocab_size, (2, 10))
    labels[0, :3] = cfg.vocab_size - 1 - np.arange(3)
    return dict(cfg=cfg, params0=params, labels=labels,
                h=g.standard_normal((2, 10, d)).astype(np.float32),
                r=g.standard_normal((2, 10, d)).astype(np.float32))


def _ce_jobs(shape):
    return [dict(name=f"ce_{shape[1]}_{tied}", kind="ce", mesh=(shape, AXES),
                 **_ce_inputs(shape[1], tied)) for tied in (False, True)]


@pytest.fixture(scope="module")
def ranks2(jax_ref, tmp_path_factory):
    """2 ranks on (1, 2): the qwen3 train step for every route, the MoE
    (both impls), greedy serve, the CE at M = 2."""
    jobs = [j for n in SPAWNS[2] for j in _train_jobs(jax_ref, n)]
    jobs.append(dict(name="serve", kind="serve", mesh=((1, 2), AXES),
                     arch="qwen3-4b", **SERVE))
    jobs += _ce_jobs((1, 2))
    jobs += _mla_ssm_decode_jobs(jax_ref, 2)
    return run_ranks(jobs, 2, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """4 ranks on (2, 2) and (1, 4): the train step, the MoE on (2, 2), the
    fallback layout on (1, 4) with its prefill and decode, the CE at M = 4,
    the layout jobs."""
    jobs = [j for n in SPAWNS[4] for j in _train_jobs(jax_ref, n)]
    pf, dq = jax_ref["prefill"], jax_ref["decode_qwen"]
    jobs += [dict(name="prefill", kind="prefill", mesh=((1, 4), AXES),
                  arch="qwen3-4b", params0=pf["params0"],
                  tokens=pf["tokens"]),
             dict(name="decode_qwen", kind="decode", mesh=((1, 4), AXES),
                  arch="qwen3-4b", params0=dq["params0"],
                  tokens=dq["tokens"])]
    jobs += _ce_jobs((1, 4))
    jobs += [dict(name=f"layout_{a}{b}", kind="layout", mesh=((a, b), AXES),
                  arch="qwen3-4b", params0=dq["params0"])
             for a, b in ((2, 2), (1, 4))]
    jobs += _mla_ssm_decode_jobs(jax_ref, 4)
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("tp4"))


@pytest.fixture(scope="module")
def ranks8(jax_ref, tmp_path_factory):
    """8 ranks on (4, 2): BEV with one attacker, and the same on (2, 2, 2)
    ("pod", "data", "model"); starcoder2's decode."""
    dec = jax_ref["decode_sc"]
    jobs = _train_jobs(jax_ref, "m42")
    jobs.append(dict(jobs[0], name="m222_bev_True",
                     mesh=((2, 2, 2), ("pod", "data", "model"))))
    jobs.append(dict(name="decode_sc", kind="decode", mesh=((4, 2), AXES),
                     arch="starcoder2-3b", params0=dec["params0"],
                     tokens=dec["tokens"]))
    return run_ranks(jobs, 8, tmp_path_factory.mktemp("tp8"))


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_train_matches(got, want):
    assert got["meta"]["num_workers"] == want["meta"]["num_workers"]
    assert got["meta"]["dim"] == want["meta"]["dim"]
    for t, (g, w) in enumerate(zip(got["log"], want["log"])):
        for k in ("gbar", "eps2", "loss", "grad_scale"):
            _close(g[k], w[k], err_msg=f"step {t} {k}")
    jleaves = [v for _, v in sorted(_flat(want["params"]).items())]
    for path, g, w in zip(tree_paths(got["params"]),
                          tree_leaves(got["params"]), jleaves):
        assert np.isfinite(w).all()
        _close(g, w, err_msg=path)


def _check_train(ranks, jax_ref, world, name, route):
    """A train job: every rank's gathered params and log bitwise equal (the
    replicas and the replicated leaves), the shards 1/M of the split
    leaves, and the result against the JAX run on the same mesh."""
    policy, use_floa = route
    job = f"{name}_{policy}_{use_floa}"
    shape = TRAIN_CASES[name][0]
    assert_ranks_agree(ranks, job, world, skip=("worker", "model"))
    first = ranks[f"{job}.r0"]
    assert [ranks[f"{job}.r{r}"]["model"] for r in range(world)] == [
        (shape[1], r % shape[1]) for r in range(world)]
    assert [ranks[f"{job}.r{r}"]["worker"] for r in range(world)] == [
        (shape[0], r // shape[1], 1) for r in range(world)]
    specs = tree_leaves(first["meta"]["params_specs"])
    for local, full, dim in zip(first["shapes"],
                                tree_leaves(first["params"]), specs):
        want = list(full.shape)
        if dim is not None:
            want[dim] //= shape[1]
        assert list(local) == want
    _assert_train_matches(first, jax_ref[name][route])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["m12", "m22"])
def test_train_step_on_model_meshes_matches_jax(ranks2, ranks4, jax_ref,
                                                name, route):
    """The smoke qwen3-4b on (1, 2) (U = 1) and (2, 2) (U = 2, each worker
    two ranks), every route, against the reference on the same mesh."""
    ranks, world = (ranks2, 2) if name == "m12" else (ranks4, 4)
    _check_train(ranks, jax_ref, world, name, route)


def test_train_step_on_eight_ranks_with_an_attacker(ranks8, jax_ref):
    """(4, 2), as tests/test_distributed.py:45 runs it: U = 4 workers of
    two ranks, worker 0 the strongest attacker."""
    _check_train(ranks8, jax_ref, 8, "m42", ("bev", True))
    meta = ranks8["m42_bev_True.r0"]["meta"]
    floa = TSTEPS.default_floa(WorkerAxes(4), meta["dim"])
    assert floa["attack"].byzantine_mask == (True, False, False, False)


def test_pod_data_model_mesh_orders_ranks_row_major(ranks8):
    """On (2, 2, 2) ("pod", "data", "model") rank r is worker r // 2 and
    model index r % 2, the worker group a group over both "pod" and
    "data": the (4, 2) run, attacker and all, bit for bit."""
    assert [ranks8[f"m222_bev_True.r{r}"]["worker"] for r in range(8)] == [
        (4, r // 2, 1) for r in range(8)]
    assert [ranks8[f"m222_bev_True.r{r}"]["model"] for r in range(8)] == [
        (2, r % 2) for r in range(8)]
    pod, flat = ranks8["m222_bev_True.r0"], ranks8["m42_bev_True.r0"]
    assert_trees_equal(pod["params"], flat["params"], "params")
    assert_trees_equal(pod["log"], flat["log"], "log")


def test_train_step_on_the_fallback_layout(ranks4, jax_ref):
    """(1, 4): KV = 2 < M = 4, so wk / wv split d (a row-parallel
    projection, summed, each rank keeping the KV head of its query heads);
    against the reference's (1, 4) run."""
    first = ranks4["m14_bev_True.r0"]
    specs = first["meta"]["params_specs"]["blocks"]["b0"]["attn"]
    assert (specs["wq"], specs["wk"], specs["wv"], specs["wo"]) == (2, 1, 1,
                                                                    1)
    _check_train(ranks4, jax_ref, 4, "m14", ("bev", True))


@pytest.mark.parametrize("name", ["moe12", "moe22", "cap12"])
def test_moe_on_model_meshes_matches_jax(ranks2, ranks4, jax_ref, name):
    """The smoke moonshot: scan_dense with each expert's f split (and the
    shared experts'), one reduce a layer, on (1, 2) and (2, 2); the
    capacity_gather impl expert-parallel (2 of 4 experts a rank) on (1, 2).
    The replicated f32 router's gradient is whole on both ranks, so the
    gathered trees agree bitwise."""
    ranks, world = (ranks4, 4) if name == "moe22" else (ranks2, 2)
    _check_train(ranks, jax_ref, world, name, ("bev", True))


@pytest.mark.parametrize("name", ["ds12", "mb12", "mb14"])
def test_mla_and_ssd_on_model_meshes_match_jax(ranks2, ranks4, jax_ref,
                                               name):
    """deepseek-v2-236b (MLA: wq_a's q_lora columns gathered, the heads
    split, the latent whole on every rank; the MoE's f split) on (1, 2);
    mamba2-1.3b (the SSD mixer: in_proj's columns gathered, the heads
    split, the gated norm's mean square summed over the ranks) on (1, 2),
    and on (1, 4), where in_proj's 138-column shards cut across the z /
    xBC boundary at 256; against the reference on the same mesh, the
    gathered trees bitwise across ranks."""
    world = TRAIN_CASES[name][0][1]
    ranks = ranks2 if world == 2 else ranks4
    _check_train(ranks, jax_ref, world, name, ("bev", True))
    specs = ranks[f"{name}_bev_True.r0"]["meta"]["params_specs"]["blocks"][
        "b0"]
    if name == "ds12":
        assert {k: specs["attn"][k] for k in ("wq_a", "wq_b", "wkv_a",
                                              "wk_b", "wv_b", "wo")} == {
            "wq_a": 2, "wq_b": 2, "wkv_a": None, "wk_b": 2, "wv_b": 2,
            "wo": 1}
    else:
        assert specs["mixer"] == {"in_proj": 2, "conv_w": None,
                                  "conv_b": None, "A_log": 1, "D": 1,
                                  "dt_bias": 1, "norm": 1, "out_proj": 1}


@pytest.mark.parametrize("arch,m", [("deepseek-v2-236b", 2),
                                    ("mamba2-1.3b", 2), ("mamba2-1.3b", 4)])
def test_mla_and_ssd_decode_on_model_meshes(ranks2, ranks4, jax_ref, arch,
                                            m):
    """Teacher-forced decode on (1, M) against the one-device JAX step: an
    MLA rank keeps the whole latent cache [L, B, S, kv_lora], an SSD rank
    the conv window of its x channels plus B and C."""
    ranks = ranks2 if m == 2 else ranks4
    name = f"decode_{arch}_{m}"
    assert_ranks_agree(ranks, name, m, skip=("model",))
    got, want = ranks[f"{name}.r0"], jax_ref["decode_" + arch]["logits"]
    cfg = get_smoke(arch)
    if cfg.mla is not None:
        assert got["cache_shape"] == (cfg.n_layers, 4, 10, cfg.mla.kv_lora)
    else:
        s = cfg.ssm
        assert got["cache_shape"] == (
            cfg.n_layers, 4, s.d_conv - 1,
            s.expand * cfg.d_model // m + 2 * s.ngroups * s.d_state)
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        _close(g, w, rtol=DECODE_RTOL,
               atol=DECODE_RTOL * float(np.abs(want).max()),
               err_msg=f"step {i}")


@pytest.mark.parametrize("name", ["rg12", "rg14"])
def test_rglru_hybrid_on_model_meshes_matches_jax(ranks2, ranks4, jax_ref,
                                                  name):
    """recurrentgemma-9b on (1, 2) and (1, 4): the RG-LRU mixer split on
    W (the convolved x gathered for w_a / w_i, whose columns are split),
    the local MQA attention with wk / wv split on d (KV 1 < M); against
    the reference on the same mesh, the gathered trees bitwise across
    ranks."""
    world = TRAIN_CASES[name][0][1]
    ranks = ranks2 if world == 2 else ranks4
    _check_train(ranks, jax_ref, world, name, ("bev", True))
    specs = ranks[f"{name}_bev_True.r0"]["meta"]["params_specs"]
    assert specs["blocks"]["b0"]["mixer"] == {
        "in_x": 2, "in_gate": 2, "conv_w": 2, "conv_b": 1, "w_a": 2,
        "b_a": 1, "w_i": 2, "b_i": 1, "lam": 1, "out": 1}
    assert specs["tail1"]["b0"]["mixer"]["w_a"] == 1
    assert {k: specs["blocks"]["b2"]["attn"][k]
            for k in ("wq", "wk", "wv", "wo")} == {"wq": 2, "wk": 1,
                                                    "wv": 1, "wo": 1}


@pytest.mark.parametrize("m", [2, 4])
def test_rglru_hybrid_decode_on_model_meshes(ranks2, ranks4, jax_ref, m):
    """recurrentgemma-9b teacher-forced 40 steps on (1, M), past the
    32-slot local ring, against the one-device JAX step: a rank's RG-LRU
    state is its W / M channels ([L, B, 3, W / M] conv window), its local
    ring the one KV head."""
    arch = "recurrentgemma-9b"
    ranks = ranks2 if m == 2 else ranks4
    name = f"decode_{arch}_{m}"
    assert_ranks_agree(ranks, name, m, skip=("model",))
    got, want = ranks[f"{name}.r0"], jax_ref["decode_" + arch]["logits"]
    cfg = get_smoke(arch)
    assert got["cache_shape"] == (1, 4, 3, cfg.rglru_width // m)
    assert len(got["logits"]) == DECODE_STEPS[arch]
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        _close(g, w, rtol=DECODE_RTOL,
               atol=DECODE_RTOL * float(np.abs(want).max()),
               err_msg=f"step {i}")


def test_prefill_and_decode_on_the_fallback_layout(ranks4, jax_ref):
    """The smoke qwen3-4b on (1, 4): prefill against the reference's (1, 4)
    prefill; decode from rank-local caches of one KV head against the
    one-device JAX step."""
    assert_ranks_agree(ranks4, "prefill", 4, skip=("model",))
    got, want = ranks4["prefill.r0"]["logits"], jax_ref["prefill"]["logits"]
    assert got.shape == want.shape
    _close(got, want, atol=RTOL * float(np.abs(want).max()))
    assert_ranks_agree(ranks4, "decode_qwen", 4, skip=("model",))
    dq = ranks4["decode_qwen.r0"]
    want = jax_ref["decode_qwen"]["logits"]
    assert dq["cache_shape"][-2] == 1     # [L, B, S, 1 KV head, hd]
    for i, (g, w) in enumerate(zip(dq["logits"], want)):
        _close(g, w, rtol=DECODE_RTOL,
               atol=DECODE_RTOL * float(np.abs(want).max()),
               err_msg=f"step {i}")


def test_decode_on_eight_ranks_matches_one_device(ranks8, jax_ref):
    """starcoder2-3b's decode on (4, 2) past its 64-slot ring, each rank 2
    rows and 4 of 8 query heads against 1 of 2 KV heads, against the JAX
    one-device step (the reference's
    test_decode_step_on_mesh_matches_single_device)."""
    assert_ranks_agree(ranks8, "decode_sc", 8, skip=("model",))
    got, want = ranks8["decode_sc.r0"], jax_ref["decode_sc"]["logits"]
    assert got["cache_batch"] == 2 and got["cache_shape"][-2] == 1
    assert got["logits"].shape == want.shape
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        _close(g, w, rtol=DECODE_RTOL,
               atol=DECODE_RTOL * float(np.abs(want).max()),
               err_msg=f"step {i}")


def test_greedy_serve_on_two_model_ranks_equals_one_process(ranks2):
    assert_ranks_agree(ranks2, "serve", 2)
    cfg = get_smoke("qwen3-4b")
    one = serve(cfg, SERVE["batch"], SERVE["prompt_len"], SERVE["gen"],
                device="cpu", seed=SERVE["seed"])
    got = ranks2["serve.r0"]
    assert torch.equal(got["tokens"], one.tokens)
    _close(got["logits"], one.logits.numpy(), rtol=RTOL,
           atol=RTOL * float(one.logits.abs().max()))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_vocab_parallel_ce_and_gradients(ranks2, ranks4, m, tied):
    """The CE over vocab-split logits (an all_reduce MAX, a SUM of exps and
    of the owner's label logit) and the gradients of h, embed and lm_head
    (through the CE and the split embedding) against the unsharded
    `chunked_ce` and lookup; the padding ids (500..511) on the last
    rank."""
    ranks = ranks2 if m == 2 else ranks4
    name = f"ce_{m}_{tied}"
    assert_ranks_agree(ranks, name, m, skip=("model",))
    got = ranks[f"{name}.r0"]
    x = _ce_inputs(m, tied)
    cfg = x["cfg"]
    params = {k: torch.as_tensor(v).requires_grad_(True)
              for k, v in x["params0"].items()}
    h = torch.as_tensor(x["h"]).requires_grad_(True)
    labels = torch.as_tensor(x["labels"])
    ce = TT.chunked_ce(params, h, labels, cfg)
    emb = TT.embed_tokens(params, labels, cfg)
    gh, *gp = torch.autograd.grad(
        ce.sum() + (emb * torch.as_tensor(x["r"])).sum(),
        [h] + [params[k] for k in sorted(params)])
    assert torch.equal(got["embedded"], emb.detach())
    for name_, g, w in [("ce", got["ce"], ce.detach()),
                        ("grad_h", got["grad_h"], gh)] + [
            (k, got["grads"][k], g_) for k, g_ in zip(sorted(params), gp)]:
        _close(g, w.numpy(), rtol=CE_RTOL,
               atol=CE_RTOL * float(w.abs().max()), err_msg=name_)


def _model_dims(specs):
    """The "model" dim of each PartitionSpec of a reference spec tree (None
    where it has none), in leaf order."""
    return [next((i for i, e in enumerate(s) if e == "model"), None)
            for s in jax.tree_util.tree_leaves(specs, is_leaf=lambda z:
                                               isinstance(z, PartitionSpec))]


@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("full", [False, True])
def test_param_specs_equal_the_reference(m, full):
    """For every arch the port registers, full and smoke, the "model" dim
    of each leaf equals the reference's `init_lm(..., shape_only=True)`
    specs at model_parallel = M (nothing allocated on either side).  The
    caches `init_caches(..., model_parallel=M)` builds split the dim the
    reference's `cache_specs` splits, the KV heads, where M divides them;
    where it does not, a rank caches the one KV head its query heads read,
    whole (the deviation `models/attention.py` states).  An MLA rank keeps
    the whole latent, which the reference splits (kv_lora or the
    sequence); an SSD rank the ssm state of its heads, the dim the
    reference splits, and the conv window of its x channels plus B and C,
    where the reference splits the channels evenly (`models/ssm.py`); an
    RG-LRU rank its W / M channels of the conv window and of h, the dim
    the reference splits, beside its local attention's KV caches."""
    for arch in ARCH_IDS:
        cfg = get_config(arch) if full else get_smoke(arch)
        jcfg = dataclasses.replace(
            jget_config(arch) if full else jget_smoke(arch),
            model_parallel=m)
        shapes, jspecs = JT.init_lm(jax.random.PRNGKey(0), jcfg,
                                    shape_only=True)
        assert tree_leaves(param_specs(cfg, m)) == _model_dims(jspecs), (
            arch, full, m)
        assert [tuple(x.shape) for x in tree_leaves(
            TT.init_lm(None, cfg, "meta"))] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]
        try:
            TATT.check_heads(cfg, m)
        except NotImplementedError:
            with pytest.raises(NotImplementedError, match="item 8d"):
                TT.init_caches(cfg, 4, 64, device="meta", model_parallel=m)
            continue
        jcaches = jax.eval_shape(lambda c=jcfg: JT.init_caches(c, 4, 64))
        mesh = SimpleNamespace(shape={"data": 1, "model": m},
                               axis_names=AXES)
        whole = tree_leaves(TT.init_caches(cfg, 4, 64, device="meta"))
        local = tree_leaves(TT.init_caches(cfg, 4, 64, device="meta",
                                           model_parallel=m))
        jdims = _model_dims(jcache_specs(jcaches, jcfg, mesh, 4))
        assert len(whole) == len(local) == len(jdims), (arch, m)
        if "rglru" in cfg.block_pattern:
            # the RG-LRU state [.., B, 3, W] / [.., B, W] splits W; the
            # rest are the local attention's KV caches
            paths = tree_paths(TT.init_caches(cfg, 4, 64, device="meta"))
            keep = []
            for p, f, loc, d in zip(paths, whole, local, jdims):
                if p.endswith("/conv") or p.endswith("/h"):
                    assert d == f.dim() - 1, (arch, m, p)
                    assert loc.shape[-1] == f.shape[-1] // m, (arch, m, p)
                    assert loc.shape[:-1] == f.shape[:-1], (arch, m, p)
                else:
                    keep.append((f, loc, d))
            whole, local, jdims = zip(*keep)
        if cfg.mla is not None:
            for f, loc, d in zip(whole, local, jdims):
                assert loc.shape == f.shape and d is not None, (arch, m)
            continue
        if cfg.ssm is not None:
            # [L, B, H, N, P]: the reference's rule splits the heads, or at
            # full width P, whose 64 equals the bookkeeping n_kv_heads it
            # looks for; [L, B, d_conv - 1, channels]: the channels
            (fc, lc, dc), (fs, ls, ds) = zip(whole, local, jdims)
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            assert ds in (2, 4) and ls.shape[2] == fs.shape[2] // m, (
                arch, m)
            assert ds == 2 or s.headdim == cfg.n_kv_heads, (arch, m)
            assert dc == 3 and lc.shape[3] == (
                d_in // m + 2 * s.ngroups * s.d_state), (arch, m)
            continue
        for f, loc, d in zip(whole, local, jdims):
            heads = f.dim() - 2
            assert loc.shape[:heads] == f.shape[:heads], (arch, m)
            assert loc.shape[heads + 1:] == f.shape[heads + 1:], (arch, m)
            if cfg.n_kv_heads % m == 0:
                assert d == heads, (arch, m)
                assert loc.shape[heads] == f.shape[heads] // m, (arch, m)
            else:
                assert d not in (None, heads), (arch, m)
                assert loc.shape[heads] == 1, (arch, m)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_layout_round_trips_and_axes(ranks4, jax_ref, shape):
    """`gather_params(shard_params(p))` is p bit for bit, and so are a
    rank's shards drawn leaf by leaf (`init_model(..., mesh=)`) and those
    of the whole draw; the ranks are
    row-major over (data, model); `default_floa` and `num_workers` give
    U = |data| on a model mesh; an unported head layout and --mesh single
    raise."""
    a, b = shape
    name = f"layout_{a}{b}"
    dq = TT.params_from_jax(jax_ref["decode_qwen"]["params0"], "cpu")
    specs = param_specs(get_smoke("qwen3-4b"), b)
    for r in range(4):
        got = ranks4[f"{name}.r{r}"]
        assert_trees_equal(got["round_trip"], dq)
        assert_trees_equal(got["drawn"], got["sliced"])
        assert got["model"] == (b, r % b)
        assert got["worker"] == ((a, r // b, 1) if a > 1 else (1, 0, 1))
        assert got["num_workers"] == a
        assert got["floa_workers"] == (a, a, a)
        assert got["heads_refused"][0] == "NotImplementedError"
        assert "item 8d" in got["heads_refused"][1]
        assert got["single"][0] == "NotImplementedError"
        assert "256-chip TPU pod layout" in got["single"][1]
        assert "--mesh RxM" in got["single"][1]
        full = [tuple(x.shape) for x in tree_leaves(dq)]
        for loc, f, d in zip(got["local_shapes"], full, tree_leaves(specs)):
            assert loc == (f if d is None else tuple(
                n // b if i == d else n for i, n in enumerate(f)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_entry_point_on_a_2x2_mesh(tmp_path):
    """`python -m repro_torch.launch.train --mesh 2x2 --device cpu` on four
    torchrun-style ranks: rank 0 prints finite losses, and its checkpoint
    (the shards gathered) reads back in the JAX package as the whole
    tree, the params of the same two steps over both workers in one
    process (`WorkerAxes.every(2)`, the same seeded draws)."""
    port = _free_port()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-4b", "--smoke", "--device", "cpu", "--mesh", "2x2",
           "--steps", "2", "--batch", "4", "--seq", "8", "--ckpt",
           str(tmp_path)]
    procs = [subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                            OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), WORLD_SIZE="4",
                            RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0, 0], outs
    out = outs[0][0]
    lines = [x for x in out.splitlines() if x.startswith("step")]
    assert len(lines) == 2 and "workers=2" in out, out
    assert all(np.isfinite(float(x.split()[3])) for x in lines)
    assert all(o.strip() == "" for o, _ in outs[1:])
    assert JCK.latest_step(str(tmp_path)) == 2
    tree, _ = JCK.restore_pytree(str(tmp_path))
    cfg = get_smoke("qwen3-4b")
    step, _ = TSTEPS.make_train_step(
        cfg, WorkerAxes.every(2), dict(global_batch=4, seq_len=8,
                                       kind="train"),
        alpha=0.02, policy=Policy.BEV, n_byzantine=0)
    params = TSTEPS.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TSTEPS.init_floa_state()
    for t in range(2):
        params, state, _ = step(params, state, {"tokens": torch.as_tensor(
            sample_tokens(4, 9, vocab=cfg.vocab_size, seed=t))}, t)
    got = jax.tree_util.tree_leaves(tree["params"])
    assert len(got) == len(tree_leaves(params))
    for path, g, w in zip(tree_paths(params), got, tree_leaves(params)):
        _close(np.asarray(g), w.numpy(), err_msg=path)

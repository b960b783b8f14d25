"""The port's LM steps over a "model" axis (tensor parallelism) against the
JAX package: `launch.steps` with a `launch.mesh.SweepMesh` of ("data",
"model") axes over gloo CPU ranks (tests/torch_dist_driver.py's LM-step
jobs), each rank holding its shards of the weights (`launch.sharding`).
The dense core: the smoke qwen3-4b; the other arch families are in
tests/test_torch_lm_tp_layouts.py (the fallback layout, 8 ranks),
test_torch_lm_tp_moe.py (MoE, MLA), test_torch_lm_tp_recurrent.py (SSD,
RG-LRU) and test_torch_lm_tp_frontends.py (the VLM prefix, the
encoder-decoder).

One JAX subprocess on 4 host devices (`torch_lm_ranks.JAX_REF`) runs the
reference on the same mesh shapes, its config `dataclasses.replace(
get_smoke(arch), model_parallel=M)` as tests/test_distributed.py:55 builds
it: the FLOA train step of the smoke qwen3-4b (f32, B = 8, 3 steps) on
(1, 2) and (2, 2) for BEV, CI, EF and use_floa=False, each step's draws
replayed, which the port's ranks slice.  Then one spawn of 2 ranks and
one of 4:

- the train step: params (gathered), gbar, eps2 and the metrics at rtol
  1e-5 / atol 1e-6; every rank's gathered params bitwise equal (the model
  replicas of the workers, and each replicated leaf across the model
  ranks); greedy `serve` on (1, 2) gives the one-process tokens;
- the vocab-parallel CE and the embed / lm_head gradients at M = 2 and 4
  against the unsharded `chunked_ce` at rtol 1e-6;
- the layout: `param_specs` and the decode caches of every one of the ten
  archs against the reference's spec trees (in this process, shapes
  only), `shard_params` / `gather_params` and `init_model` on a mesh
  bitwise, the worker and model axes;
- the training entry point with `--mesh 2x2` on 4 torchrun-style ranks,
  its checkpoint read back by the JAX package as the whole tree.

Marked slow, as tests/test_torch_lm_mesh.py is.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax
    from jax.sharding import PartitionSpec
    from repro import checkpoint as JCK
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke as jget_smoke
    from repro.launch import steps as JSTEPS
    from repro.launch.sharding import cache_specs as jcache_specs
    from repro.models import encdec as JED
    from repro.models import transformer as JT

from torch_lm_ranks import (AXES, ROOT, ROUTES, RTOL, check_train, close,
                            jax_reference, train_jobs)
from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks
from types import SimpleNamespace

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.power_control import Policy
from repro_torch.data import sample_tokens
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import WorkerAxes
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import param_specs
from repro_torch.models import attention as TATT
from repro_torch.models import encdec as TED
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_paths

pytestmark = pytest.mark.slow

CE_RTOL = 1e-6
TRAIN_CASES = {   # name: (mesh shape, routes, arch, moe impl, batch)
    "m12": ((1, 2), ROUTES, "qwen3-4b", None, 8),
    "m22": ((2, 2), ROUTES, "qwen3-4b", None, 8),
}
SERVE = dict(batch=4, prompt_len=8, gen=8, seed=3)
MODEL_SIZES = (2, 4, 16)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's train runs (`torch_lm_ranks.JAX_REF`), once, in a
    subprocess with 4 host devices."""
    return jax_reference(tmp_path_factory, 4, train=TRAIN_CASES)


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
    """2 ranks on (1, 2): the qwen3 train step for every route, greedy
    serve, the CE at M = 2."""
    jobs = train_jobs(jax_ref, "m12", TRAIN_CASES)
    jobs.append(dict(name="serve", kind="serve", mesh=((1, 2), AXES),
                     arch="qwen3-4b", **SERVE))
    jobs += _ce_jobs((1, 2))
    return run_ranks(jobs, 2, tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """4 ranks on (2, 2) and (1, 4): the train step on (2, 2), the CE at
    M = 4, the layout jobs."""
    jobs = train_jobs(jax_ref, "m22", TRAIN_CASES)
    jobs += _ce_jobs((1, 4))
    jobs += [dict(name=f"layout_{a}{b}", kind="layout", mesh=((a, b), AXES),
                  arch="qwen3-4b", params0=jax_ref["m12"]["params0"])
             for a, b in ((2, 2), (1, 4))]
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("tp4"))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["m12", "m22"])
def test_train_step_on_model_meshes_matches_jax(ranks2, ranks4, jax_ref,
                                                name, route):
    """The smoke qwen3-4b on (1, 2) (U = 1) and (2, 2) (U = 2, each worker
    two ranks), every route, against the reference on the same mesh."""
    ranks, world = (ranks2, 2) if name == "m12" else (ranks4, 4)
    check_train(ranks, jax_ref, world, name, route, TRAIN_CASES)


def test_greedy_serve_on_two_model_ranks_equals_one_process(ranks2):
    assert_ranks_agree(ranks2, "serve", 2)
    cfg = get_smoke("qwen3-4b")
    one = serve(cfg, SERVE["batch"], SERVE["prompt_len"], SERVE["gen"],
                device="cpu", seed=SERVE["seed"])
    got = ranks2["serve.r0"]
    assert torch.equal(got["tokens"], one.tokens)
    close(got["logits"], one.logits.numpy(), rtol=RTOL,
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
        close(g, w.numpy(), rtol=CE_RTOL,
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
    """For all ten archs, full and smoke, the "model" dim of each leaf
    equals the reference's `init_model(..., shape_only=True)` specs at
    model_parallel = M (nothing allocated on either side): the
    encoder-decoder's `init_encdec` tree, the VLM's projector beside the
    decoder's.  The
    caches `init_caches(..., model_parallel=M)` builds split the dim the
    reference's `cache_specs` splits, the KV heads, where M divides them;
    where it does not, a rank caches the one KV head its query heads read,
    whole (the deviation `models/attention.py` states).  An MLA rank keeps
    the whole latent, which the reference splits (kv_lora or the
    sequence); an SSD rank the ssm state of its heads, the dim the
    reference splits, and the conv window of its x channels plus B and C,
    where the reference splits the channels evenly (`models/ssm.py`); an
    RG-LRU rank its W / M channels of the conv window and of h, the dim
    the reference splits, beside its local attention's KV caches.  The
    encoder-decoder's self-attention caches (`encdec.init_dec_caches`)
    follow the GQA rule against the `cache_specs` of the reference's
    decode step."""
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        cfg = get_config(arch) if full else get_smoke(arch)
        jcfg = dataclasses.replace(
            jget_config(arch) if full else jget_smoke(arch),
            model_parallel=m)
        shapes, jspecs = JSTEPS.init_model(jcfg, jax.random.PRNGKey(0),
                                           shape_only=True)
        assert tree_leaves(param_specs(cfg, m)) == _model_dims(jspecs), (
            arch, full, m)
        assert [tuple(x.shape) for x in tree_leaves(
            TSTEPS.init_model(cfg, None, "meta"))] == [
            tuple(x.shape) for x in jax.tree_util.tree_leaves(shapes)]
        audio = cfg.arch_type == "audio"
        caches = ((lambda mp=1: TED.init_dec_caches(
            cfg, 4, 64, device="meta", model_parallel=mp)) if audio else
            (lambda mp=1: TT.init_caches(cfg, 4, 64, device="meta",
                                         model_parallel=mp)))
        try:
            TATT.check_heads(cfg, m)
        except NotImplementedError:
            with pytest.raises(NotImplementedError, match="item 8d"):
                caches(m)
            continue
        mesh = SimpleNamespace(shape={"data": 1, "model": m},
                               axis_names=AXES)
        if audio:   # the reference's decode step: {"dec_blocks": caches}
            jcaches = jax.eval_shape(lambda c=jcfg: JED.init_dec_caches(
                c, 4, 64))
            jdims = _model_dims(jcache_specs({"dec_blocks": jcaches}, jcfg,
                                             mesh, 4)["dec_blocks"])
        else:
            jcaches = jax.eval_shape(lambda c=jcfg: JT.init_caches(c, 4, 64))
            jdims = _model_dims(jcache_specs(jcaches, jcfg, mesh, 4))
        whole, local = tree_leaves(caches()), tree_leaves(caches(m))
        assert len(whole) == len(local) == len(jdims), (arch, m)
        if "rglru" in cfg.block_pattern:
            # the RG-LRU state [.., B, 3, W] / [.., B, W] splits W; the
            # rest are the local attention's KV caches
            paths = tree_paths(caches())
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
    dq = TT.params_from_jax(jax_ref["m12"]["params0"], "cpu")
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
        close(np.asarray(g), w.numpy(), err_msg=path)

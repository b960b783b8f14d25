"""The port's LM steps over a "model" axis against the JAX package (see
tests/test_torch_lm_tp.py): the layouts beyond the dense core.  The smoke
qwen3-4b on (1, 4), where KV 2 < M and wk / wv split d, its train step,
prefill and decode; on (4, 2) (U = 4 workers of two ranks, BEV with one
strongest attacker) and the same on (2, 2, 2) ("pod", "data", "model");
starcoder2-3b's decode on (4, 2), 72 steps past its 64-slot ring.

The head layouts the "model" axis does not divide (the reference's
`_wspec` fallback, `models/attention.py`): starcoder2-3b's smoke config at
H 6 / KV 2 on (1, 4) (wq / wk / wv split d, wo hd: every rank computes
every head), llama4's smoke config (H 4, d 128) on (1, 8), the same
layout; H 12 / KV 3 on (1, 4) (3 query heads a rank reading a window of
two KV heads, wk / wv split d), and H 6 / KV 2 at d 90, hd 18 on (1, 4),
where no dim of wq, wk, wv or wo divides 4 (all replicated).  Each: the
train step, prefill, the shard / gather round trip, and decode but for the
last (the decode kernel takes head dims 32, 64, 128 and 256, all of
which 4 divides).

Two JAX subprocesses at once on 8 host devices (`torch_lm_ranks.JAX_REF`,
the cases dealt out between them) run the reference on the same meshes
(the prefills on their meshes, the decodes on one device); then one spawn
of 4 ranks and one of 8.  Train at rtol
1e-5 / atol 1e-6, prefill at rtol 1e-5, decode at rtol 1e-4 against the
one-device step.

The steps run the default "sequence" route (the residual stream split
over "model" on the sequence, the reference's `make_constrain`); sc6's
train step and prefill also run "batch_only" against the same reference.
Under remat on (1, 4) each recomputed block saves this rank's rows
[B, S / 4, d] of its input, where "batch_only" saves [B, S, d]
(`saved_tensors_hooks`); a prefill of 22 positions, which 4 does not
divide, runs "batch_only" and says so.

Marked slow, as tests/test_torch_lm_mesh.py is.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from torch_lm_ranks import (AXES, RTOL, SEQ, batch_only_jobs,
                            check_batch_only, check_train, close,
                            close_decode, jax_reference, train_jobs)
from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.configs import get_smoke
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import WorkerAxes
from repro_torch.launch.sharding import param_specs
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.slow

# the head layouts M does not divide: name -> (mesh shape, arch, the
# smoke config's replaced fields, the "model" dims of a block's wq, wk,
# wv, wo, its stacked layer dim counted)
HEADS = {
    "sc6": ((1, 4), "starcoder2-3b", dict(n_heads=6), (1, 1, 1, 2)),
    "h12": ((1, 4), "qwen3-4b", dict(n_heads=12, n_kv_heads=3),
            (2, 1, 1, 1)),
    "nodim": ((1, 4), "qwen3-4b", dict(d_model=90, n_heads=6, n_kv_heads=2,
                                       head_dim=18), (None,) * 4),
    "l4": ((1, 8), "llama4-maverick-400b-a17b", {}, (1, 1, 1, 2)),
}
HEADS_DECODE = ("sc6", "h12", "l4")   # nodim's hd 18: no decode kernel
ODD = 22   # a prefill length 4 does not divide
TRAIN_CASES = {   # name: (mesh shape, routes, arch, moe impl, batch[, over])
    "m42": ((4, 2), [("bev", True)], "qwen3-4b", None, 8),
    "m14": ((1, 4), [("bev", True)], "qwen3-4b", None, 8),
    **{name: (shape, [("bev", True)], arch, None, 8, over)
       for name, (shape, arch, over, _) in HEADS.items()},
}
PREFILL = {"prefill": ((1, 4), "qwen3-4b", 4, 24, 9),
           **{f"prefill_{name}": (shape, arch, 4, 24, 9, over)
              for name, (shape, arch, over, _) in HEADS.items()}}
DECODE = {"decode_qwen": ("qwen3-4b", 4, 12, 5),
          "decode_sc": ("starcoder2-3b", 8, 72, 3),   # 64-slot ring + 8
          **{f"decode_{name}": (HEADS[name][1], 4, 8, 5, HEADS[name][2])
             for name in HEADS_DECODE}}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`torch_lm_ranks.JAX_REF`), once, in two
    subprocesses at once with 8 host devices each."""
    return jax_reference(tmp_path_factory, 8, train=TRAIN_CASES,
                         prefill=PREFILL, decode=DECODE, procs=2)


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """4 ranks on (1, 4): the fallback layout's train step, prefill and
    decode."""
    jobs = train_jobs(jax_ref, "m14", TRAIN_CASES)
    pf, dq = jax_ref["prefill"], jax_ref["decode_qwen"]
    jobs += [dict(name="prefill", kind="prefill", mesh=((1, 4), AXES),
                  arch="qwen3-4b", params0=pf["params0"],
                  tokens=pf["tokens"]),
             dict(name="decode_qwen", kind="decode", mesh=((1, 4), AXES),
                  arch="qwen3-4b", params0=dq["params0"],
                  tokens=dq["tokens"]),
             dict(name="prefill_odd", kind="prefill", mesh=((1, 4), AXES),
                  arch="qwen3-4b", params0=pf["params0"],
                  tokens=pf["tokens"][:, :ODD]),
             dict(jobs[0], name="saved", kind="saved",
                  config=dict(lm_head_chunk=SEQ // 2))]
    jobs += heads_jobs(jax_ref, 4)
    jobs += batch_only_jobs(jax_ref, ["sc6"], TRAIN_CASES)
    jobs += [dict(j, name="prefill_sc6_batch_only", constrain="batch_only")
             for j in jobs if j["name"] == "prefill_sc6"]
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("tp4"))


def heads_jobs(jax_ref, world):
    """The jobs of the HEADS cases on `world` ranks: the train step, the
    prefill, the decode and the layout round trip of each."""
    jobs = []
    for name, (shape, arch, over, _) in HEADS.items():
        if shape[0] * shape[1] != world:
            continue
        jobs += train_jobs(jax_ref, name, TRAIN_CASES)
        mesh, pf = (shape, AXES), jax_ref[f"prefill_{name}"]
        jobs += [dict(name=f"prefill_{name}", kind="prefill", mesh=mesh,
                      arch=arch, config=over, params0=pf["params0"],
                      tokens=pf["tokens"]),
                 dict(name=f"layout_{name}", kind="layout", mesh=mesh,
                      arch=arch, config=over,
                      params0=jax_ref[name]["params0"])]
        if name in HEADS_DECODE:
            dec = jax_ref[f"decode_{name}"]
            jobs.append(dict(name=f"decode_{name}", kind="decode",
                             mesh=mesh, arch=arch, config=over,
                             params0=dec["params0"], tokens=dec["tokens"]))
    return jobs


@pytest.fixture(scope="module")
def ranks8(jax_ref, tmp_path_factory):
    """8 ranks on (4, 2): BEV with one attacker, and the same on (2, 2, 2)
    ("pod", "data", "model"); starcoder2's decode."""
    dec = jax_ref["decode_sc"]
    jobs = train_jobs(jax_ref, "m42", TRAIN_CASES)
    jobs.append(dict(jobs[0], name="m222_bev_True",
                     mesh=((2, 2, 2), ("pod", "data", "model"))))
    jobs.append(dict(name="decode_sc", kind="decode", mesh=((4, 2), AXES),
                     arch="starcoder2-3b", params0=dec["params0"],
                     tokens=dec["tokens"]))
    jobs += heads_jobs(jax_ref, 8)
    return run_ranks(jobs, 8, tmp_path_factory.mktemp("tp8"))


def test_train_step_on_eight_ranks_with_an_attacker(ranks8, jax_ref):
    """(4, 2), as tests/test_distributed.py:45 runs it: U = 4 workers of
    two ranks, worker 0 the strongest attacker."""
    check_train(ranks8, jax_ref, 8, "m42", ("bev", True), TRAIN_CASES)
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
    check_train(ranks4, jax_ref, 4, "m14", ("bev", True), TRAIN_CASES)


def test_prefill_and_decode_on_the_fallback_layout(ranks4, jax_ref):
    """The smoke qwen3-4b on (1, 4): prefill against the reference's (1, 4)
    prefill; decode from rank-local caches of one KV head against the
    one-device JAX step."""
    assert_ranks_agree(ranks4, "prefill", 4, skip=("model",))
    got, want = ranks4["prefill.r0"]["logits"], jax_ref["prefill"]["logits"]
    assert got.shape == want.shape
    close(got, want, atol=RTOL * float(np.abs(want).max()))
    assert_ranks_agree(ranks4, "decode_qwen", 4, skip=("model",))
    dq = ranks4["decode_qwen.r0"]
    want = jax_ref["decode_qwen"]["logits"]
    assert dq["cache_shape"][-2] == 1     # [L, B, S, 1 KV head, hd]
    close_decode(dq["logits"], want)


def test_decode_on_eight_ranks_matches_one_device(ranks8, jax_ref):
    """starcoder2-3b's decode on (4, 2) past its 64-slot ring, each rank 2
    rows and 4 of 8 query heads against 1 of 2 KV heads, against the JAX
    one-device step (the reference's
    test_decode_step_on_mesh_matches_single_device)."""
    assert_ranks_agree(ranks8, "decode_sc", 8, skip=("model",))
    got, want = ranks8["decode_sc.r0"], jax_ref["decode_sc"]["logits"]
    assert got["cache_batch"] == 2 and got["cache_shape"][-2] == 1
    assert got["logits"].shape == want.shape
    close_decode(got["logits"], want)


def _ranks(ranks4, ranks8, name):
    """The spawn a HEADS case ran in, and its world size."""
    world = math.prod(HEADS[name][0])
    return (ranks4 if world == 4 else ranks8), world


@pytest.mark.parametrize("name", list(HEADS))
def test_train_step_where_m_does_not_divide_the_heads(ranks4, ranks8,
                                                      jax_ref, name):
    """The BEV train step of each HEADS case against the reference's on the
    same mesh: the specs of `_wspec`'s fallback (every block's wq, wk,
    wv, wo), each rank's shards, its gathered params and log."""
    ranks, world = _ranks(ranks4, ranks8, name)
    first = ranks[f"{name}_bev_True.r0"]
    for block in first["meta"]["params_specs"]["blocks"].values():
        attn = block["attn"]
        assert (attn["wq"], attn["wk"], attn["wv"], attn["wo"]) == \
            HEADS[name][3], name
    check_train(ranks, jax_ref, world, name, ("bev", True), TRAIN_CASES)


@pytest.mark.parametrize("name", list(HEADS))
def test_prefill_where_m_does_not_divide_the_heads(ranks4, ranks8, jax_ref,
                                                   name):
    """Each HEADS case's prefill against the reference's on its mesh, every
    rank's logits the same bits."""
    ranks, world = _ranks(ranks4, ranks8, name)
    assert_ranks_agree(ranks, f"prefill_{name}", world, skip=("model",))
    got = ranks[f"prefill_{name}.r0"]["logits"]
    want = jax_ref[f"prefill_{name}"]["logits"]
    assert got.shape == want.shape
    close(got, want, atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", HEADS_DECODE)
def test_decode_where_m_does_not_divide_the_heads(ranks4, ranks8, jax_ref,
                                                  name):
    """Each HEADS case's decode, teacher-forced from a rank's caches,
    against the one-device JAX step: a rank caches every KV head where M
    does not divide H (the kernel reads whole heads, every query head on
    every rank), and a window of two of H 12 / KV 3's three at M = 4."""
    ranks, world = _ranks(ranks4, ranks8, name)
    assert_ranks_agree(ranks, f"decode_{name}", world, skip=("model",))
    got = ranks[f"decode_{name}.r0"]
    cfg = dataclasses.replace(get_smoke(HEADS[name][1]), **HEADS[name][2])
    heads = 2 if name == "h12" else cfg.n_kv_heads
    assert got["cache_shape"][-2] == heads
    close_decode(got["logits"], jax_ref[f"decode_{name}"]["logits"])


@pytest.mark.parametrize("name", list(HEADS))
def test_head_layouts_round_trip_bit_for_bit(ranks4, ranks8, jax_ref,
                                             name):
    """`gather_params(shard_params(p))` is p bit for bit for each HEADS
    case, and a rank's shards drawn leaf by leaf are those of the whole
    draw; a rank holds 1/M of each split leaf."""
    ranks, world = _ranks(ranks4, ranks8, name)
    cfg = dataclasses.replace(get_smoke(HEADS[name][1]), **HEADS[name][2])
    full = TT.params_from_jax(jax_ref[name]["params0"], "cpu")
    m = HEADS[name][0][1]
    specs = tree_leaves(param_specs(cfg, m))
    for r in range(world):
        got = ranks[f"layout_{name}.r{r}"]
        assert_trees_equal(got["round_trip"], full)
        assert_trees_equal(got["drawn"], got["sliced"])
        for loc, f, d in zip(got["local_shapes"], tree_leaves(full), specs):
            assert loc == tuple(n // m if i == d else n
                                for i, n in enumerate(f.shape))


def test_batch_only_route_where_m_does_not_divide_the_heads(ranks4,
                                                            jax_ref):
    """sc6 (every head on every rank) on "batch_only", the residual
    replicated over "model": its train step and prefill against the
    reference's, which split the sequence; the "sequence" jobs took their
    route."""
    assert ranks4["prefill_sc6.r0"]["constrain"] == "sequence"
    check_batch_only(ranks4, jax_ref, 4, "sc6", TRAIN_CASES)
    got = ranks4["prefill_sc6_batch_only.r0"]
    assert got["constrain"] == "batch_only"
    want = jax_ref["prefill_sc6"]["logits"]
    close(got["logits"], want, atol=RTOL * float(np.abs(want).max()))


def test_remat_blocks_save_the_ranks_rows(ranks4):
    """Under remat on (1, 4) (U = 1, B = 8, S = 16) every tensor of the
    residual's width the train step saves for its backward is a rank's
    rows [8, 4, d] or a CE chunk [8, 8, d] on "sequence": each recomputed
    block keeps [B, S / 4, d], one a block at least, and nothing keeps
    [B, S, d]; on "batch_only" each block keeps [8, 16, d]."""
    cfg = get_smoke("qwen3-4b")
    b, d, blocks = 8, cfg.d_model, cfg.n_layers
    for r in range(4):
        got = ranks4[f"saved.r{r}"]
        seq, rep = got["sequence"], got["batch_only"]
        assert (seq["route"], rep["route"]) == ("sequence", "batch_only")
        assert seq["shapes"].count((b, SEQ // 4, d)) >= blocks
        assert set(seq["shapes"]) <= {(b, SEQ // 4, d), (b, SEQ // 2, d)}
        assert rep["shapes"].count((b, SEQ, d)) >= blocks
        assert (b, SEQ // 4, d) not in rep["shapes"]


def test_prefill_where_m_does_not_divide_the_sequence(ranks4, jax_ref):
    """22 positions on (1, 4): the prefill runs "batch_only" (the
    reference's values come out of its replicated route too) and says so
    in meta; its logits are the one-process prefill's."""
    assert_ranks_agree(ranks4, "prefill_odd", 4, skip=("model",))
    got = ranks4["prefill_odd.r0"]
    assert got["constrain"] == "batch_only"
    assert ranks4["prefill.r0"]["constrain"] == "sequence"
    pf = jax_ref["prefill"]
    step, meta = TSTEPS.make_prefill_step(get_smoke("qwen3-4b"))
    one = step(TT.params_from_jax(pf["params0"], "cpu"),
               {"tokens": torch.as_tensor(pf["tokens"][:, :ODD])})
    assert meta["constrain"] == "sequence"
    close(got["logits"], one.numpy(),
          atol=RTOL * float(one.abs().max()))


def _leaf_paths(tree, prefix=""):
    return {k: _leaf_paths(v, f"{prefix}/{k}") if isinstance(v, dict)
            else f"{prefix}/{k}" for k, v in tree.items()}


@pytest.mark.parametrize("arch,m,ffn", [
    ("qwen3-4b", 4, False), ("qwen3-4b", 3, True),
    ("deepseek-v2-236b", 3, False), ("seamless-m4t-large-v2", 2, False),
    ("recurrentgemma-9b", 3, True)])
def test_row_leaves_are_the_norms_and_a_replicated_ffn(arch, m, ffn):
    """The leaves whose gradient the train step sums over "model" under
    the sequence split: every norm's scale, and the dense SwiGLU's leaves
    exactly where m does not divide d_ff (never a MoE's); none at m = 1."""
    from repro_torch.launch.sharding import ROW_NORMS, init_params, row_leaves
    cfg = get_smoke(arch)
    paths = tree_leaves(_leaf_paths(init_params(cfg, None, "meta")))
    got = {paths[i] for i in row_leaves(cfg, m)}
    norms = {p for p in paths if p.rsplit("/", 1)[1] in ROW_NORMS}
    dense = {p for p in paths if p.rsplit("/", 2)[1] == "ffn"
             and p.rsplit("/", 1)[1] in ("wi", "wg", "wo")}
    assert norms and norms <= got
    assert got - norms == (dense if ffn else set())
    assert row_leaves(cfg, 1) == []

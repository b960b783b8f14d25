"""FSDP storage over "data" on gloo CPU ranks, against the port's own
unsharded run and the JAX package, and the dry run's counts against a
real run: one spawn of 2 ranks and one of 4 (tests/torch_dist_driver.py).

With `launch.sharding.FSDP_MIN_SIZE` lowered to MIN (the jobs'
"fsdp_min_size"), the smoke configs' matrices shard over "data" (every
stacked weight on a dim past the layer dim, the embedding, the head,
enc_in), so every gather and reduce_scatter of the layout runs:

- the f32 FLOA train step of qwen3-4b on (2, 1) and (2, 2), BEV, 3 steps
  with the reference's replayed draws: params and stats within rtol 1e-5
  of the JAX step on the same mesh and of the port's run without FSDP;
  each rank stores the slices of both dims, its `stored_bytes` their sum;
- prefill on (2, 1) of qwen3-4b, moonshot-v1-16b-a3b (MoE) and
  seamless-m4t-large-v2 (frames), and decode of the three (seamless's
  against its cross K / V): logits bitwise equal to the unsharded run's
  and within the existing tolerances of the JAX package's;
- remat under FSDP on (2, 1) and (2, 2): qwen3-4b's step with remat=True
  bitwise the remat-free one on every rank, and moonshot-v1-16b-a3b's
  steps on (2, 1) run
  twice from the same weights, remat off recording the experts in a
  `RoutingTape`, remat on replaying them: bitwise, and the recompute
  (which gathers each layer again and repeats the aux's all_reduce)
  moves no cursor and flips nothing;
- `launch.dryrun.trace_step` of the smoke qwen3-4b's train, prefill and
  decode steps on a fake (2, 2) group in this process against the same
  step run for real on rank 0 of the 4 gloo ranks: the operations
  (FlopCounterMode), the argument bytes and the collectives issued, by
  kind, equal.
"""
import math

import numpy as np
import pytest
import torch

from torch_lm_ranks import (AXES, ROUTES, RTOL, assert_train_matches,
                            close, close_decode, jax_reference, train_jobs)
from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.tree import tree_leaves

MIN = 2048
QWEN, MOE, AUDIO = "qwen3-4b", "moonshot-v1-16b-a3b", "seamless-m4t-large-v2"
ARCHS = (QWEN, MOE, AUDIO)
BEV = ROUTES[:1]
TRAIN = {"q21": ((2, 1), BEV, QWEN, None, 4),
         "q22": ((2, 2), BEV, QWEN, None, 4)}
PREFILL = {f"pf_{a}": ((2, 1), a, 4, 16, 3) for a in ARCHS}
DECODE = {f"decode_{a}": (a, 4, 10, 5) for a in ARCHS}
COUNT = {"train": dict(global_batch=4, seq_len=16, kind="train"),
         "prefill": dict(global_batch=4, seq_len=16, kind="prefill"),
         "decode": dict(global_batch=4, seq_len=16, kind="decode")}


def _twins(job):
    """The job with FSDP at MIN, and its unsharded twin (`_plain`)."""
    return [dict(job, fsdp_min_size=MIN),
            dict(job, name=job["name"] + "_plain", fsdp=False)]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference(tmp_path_factory, 4, train=TRAIN, prefill=PREFILL,
                         decode=DECODE)


@pytest.fixture(scope="module")
def ranks2(jax_ref, tmp_path_factory):
    jobs = [j for job in train_jobs(jax_ref, "q21", TRAIN)
            for j in _twins(job)]
    for a in ARCHS:
        ref = jax_ref[f"pf_{a}"]
        jobs += _twins(dict(name=f"pf_{a}", kind="prefill",
                            mesh=((2, 1), AXES), arch=a,
                            params0=ref["params0"], tokens=ref["tokens"],
                            extra=ref["extra"]))
        ref = jax_ref[f"decode_{a}"]
        jobs += _twins(dict(name=f"decode_{a}", kind="decode",
                            mesh=((2, 1), AXES), arch=a,
                            params0=ref["params0"], tokens=ref["tokens"],
                            frames=ref.get("frames")))
    jobs.append(dict(jobs[0], name=jobs[0]["name"] + "_remat", remat=True))
    rng = np.random.default_rng(11)
    jobs.append(dict(
        jobs[0], name="remat_moe", arch=MOE, replay=True, draws=None,
        params0=jax_ref[f"pf_{MOE}"]["params0"], tokens=[
            rng.integers(0, 512, (4, 17), dtype=np.int32)
            for _ in range(2)]))
    return run_ranks(jobs, 2, tmp_path_factory.mktemp("fsdp2"))


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    jobs = [j for job in train_jobs(jax_ref, "q22", TRAIN)
            for j in _twins(job)]
    jobs.append(dict(jobs[0], name=jobs[0]["name"] + "_remat", remat=True))
    jobs += [dict(name=f"count_{k}", kind="count", mesh=((2, 2), AXES),
                  arch=QWEN, shape_name="decode_32k", shape=shape,
                  fsdp_min_size=MIN) for k, shape in COUNT.items()]
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("fsdp4"))


def _local_shapes(arch, m, r):
    """Each leaf's shape on a rank of (r, m) under FSDP at MIN, and its
    itemsize."""
    cfg = get_smoke(arch)
    old, SH.FSDP_MIN_SIZE = SH.FSDP_MIN_SIZE, MIN
    try:
        dspecs = tree_leaves(SH.data_specs(cfg, m, r))
    finally:
        SH.FSDP_MIN_SIZE = old
    specs = tree_leaves(SH.param_specs(cfg, m))
    full = tree_leaves(SH.init_params(cfg, None, "meta"))
    return dspecs, [(tuple(n // (r if i == d else 1) // (m if i == dm else 1)
                           for i, n in enumerate(x.shape)), x.element_size())
                    for x, d, dm in zip(full, dspecs, specs)]


@pytest.mark.parametrize("name", ["q21", "q22"])
def test_fsdp_train_step_matches_jax_and_unsharded(ranks2, ranks4, jax_ref,
                                                   name):
    """The train step with the smoke leaves' storage over "data": every
    rank's gathered params and log bitwise equal, each rank's shards the
    slices of both dims, and the result within rtol 1e-5 of the JAX step
    on the same mesh and of the port's run without FSDP."""
    ranks = ranks2 if name == "q21" else ranks4
    shape = TRAIN[name][0]
    world = math.prod(shape)
    job = f"{name}_bev_True"
    assert_ranks_agree(ranks, job, world, skip=("worker", "model"))
    got, plain = ranks[f"{job}.r0"], ranks[f"{job}_plain.r0"]
    dspecs, local = _local_shapes(QWEN, shape[1], shape[0])
    assert sum(d is not None for d in dspecs) >= 9
    assert got["shapes"] == [s for s, _ in local]
    assert got["stored_bytes"] == sum(math.prod(s) * e for s, e in local)
    assert got["stored_bytes"] < plain["stored_bytes"]
    assert tree_leaves(got["meta"]["data_specs"]) == dspecs
    assert_train_matches(got, jax_ref[name][BEV[0]])
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(plain["params"])):
        close(g, w.numpy())
    for g, w in zip(got["log"], plain["log"]):
        for k in ("gbar", "eps2", "loss", "grad_scale"):
            close(g[k], w[k].numpy(), err_msg=k)


def test_fsdp_remat_step_bitwise_equals_no_remat(ranks2, ranks4):
    """Under FSDP (and a "model" axis on (2, 2)) the recomputed blocks
    re-enter the step's axes and gather their layers again inside the
    backward, on every rank in the same order: the remat step equals the
    remat-free one bitwise, and a tape's replay passes through the
    recompute without moving its cursor or counting a flip."""
    for ranks, name, world in ((ranks2, "q21", 2), (ranks4, "q22", 4)):
        job = f"{name}_bev_True"
        assert_ranks_agree(ranks, job + "_remat", world,
                           skip=("worker", "model"))
        for r in range(world):
            got, want = ranks[f"{job}_remat.r{r}"], ranks[f"{job}.r{r}"]
            assert_trees_equal(got["params"], want["params"])
            assert_trees_equal(got["log"], want["log"])
    assert_ranks_agree(ranks2, "remat_moe", 2, skip=("worker",))
    for r in range(2):
        moe = ranks2[f"remat_moe.r{r}"]
        assert_trees_equal(moe["params"], moe["recorded"]["params"])
        assert_trees_equal(moe["log"], moe["recorded"]["log"])
        layers = get_smoke(MOE).n_layers
        assert moe["tape"] == {"recorded": 2 * layers, "cursor": 2 * layers,
                               "decisions": 2 * layers * 2 * 16,
                               "flips": 0}
    assert any(d is not None for d in tree_leaves(
        ranks2["remat_moe.r0"]["meta"]["data_specs"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_prefill_and_decode_equal_unsharded(ranks2, jax_ref, arch):
    """Prefill and teacher-forced decode on (2, 1): the gathers are exact
    copies, so the logits equal the unsharded run's bit for bit, and the
    JAX package's within the existing tolerances."""
    for kind in ("pf", "decode"):
        job = f"{kind}_{arch}"
        assert_ranks_agree(ranks2, job, 2, skip=("model",))
        got = ranks2[f"{job}.r0"]
        assert torch.equal(got["logits"], ranks2[f"{job}_plain.r0"]["logits"])
        assert got["stored_bytes"] < ranks2[f"{job}_plain.r0"]["stored_bytes"]
        want = jax_ref[job]["logits"]
        if kind == "pf":   # the existing prefill tolerance
            close(got["logits"], want, atol=RTOL * float(np.abs(want).max()))
        else:
            close_decode(got["logits"], want)


@pytest.mark.parametrize("kind", list(COUNT))
def test_dry_run_counts_equal_a_real_run(ranks4, monkeypatch, kind):
    """The dry run's trace on a fake (2, 2) group (rank 0, fake CPU
    tensors, the CPU's route) against the same step run for real on rank
    0 of 4 gloo ranks: equal operations, argument bytes and collectives
    (bytes and calls by kind; all in one node: NVLink)."""
    monkeypatch.setattr(SH, "FSDP_MIN_SIZE", MIN)
    real = ranks4[f"count_{kind}.r0"]
    with DRY.fake_group(4):
        mesh = make_debug_mesh((2, 2), AXES)
        fake = DRY.trace_step(get_smoke(QWEN), "decode_32k", COUNT[kind],
                              mesh, route="cpu")
    assert fake["flops_per_device"] == real["flops_per_device"] > 0
    assert fake["memory"]["argument_size"] == \
        real["memory"]["argument_size"]
    assert fake["memory"]["param_bytes"] == real["memory"]["param_bytes"]
    assert fake["collectives"] == real["collectives"]
    assert fake["collectives"]["all_gather"] > 0
    assert fake["collectives"]["by_link"]["network"] == 0
    if kind == "train":
        assert fake["collectives"]["reduce_scatter"] > 0

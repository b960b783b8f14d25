"""The port's LM steps over a "model" axis against the JAX package (see
tests/test_torch_lm_tp.py): the layouts beyond the dense core.  The smoke
qwen3-4b on (1, 4), where KV 2 < M and wk / wv split d, its train step,
prefill and decode; on (4, 2) (U = 4 workers of two ranks, BEV with one
strongest attacker) and the same on (2, 2, 2) ("pod", "data", "model");
starcoder2-3b's decode on (4, 2), 72 steps past its 64-slot ring.

One JAX subprocess on 8 host devices (`torch_lm_ranks.JAX_REF`) runs the
reference on the same meshes (the qwen3 prefill on (1, 4), the decodes
on one device); then one spawn of 4 ranks and one of 8.  Train at rtol
1e-5 / atol 1e-6, prefill at rtol 1e-5, decode at rtol 1e-4 against the
one-device step.

Marked slow, as tests/test_torch_lm_mesh.py is.
"""
import numpy as np
import pytest

from torch_lm_ranks import (AXES, RTOL, check_train, close, close_decode,
                            jax_reference, train_jobs)
from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import WorkerAxes

pytestmark = pytest.mark.slow

TRAIN_CASES = {   # name: (mesh shape, routes, arch, moe impl, batch)
    "m42": ((4, 2), [("bev", True)], "qwen3-4b", None, 8),
    "m14": ((1, 4), [("bev", True)], "qwen3-4b", None, 8),
}
PREFILL = {"prefill": ((1, 4), "qwen3-4b", 4, 24, 9)}
DECODE = {"decode_qwen": ("qwen3-4b", 4, 12, 5),
          "decode_sc": ("starcoder2-3b", 8, 72, 3)}   # 64-slot ring + 8


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`torch_lm_ranks.JAX_REF`), once, in a
    subprocess with 8 host devices."""
    return jax_reference(tmp_path_factory, 8, train=TRAIN_CASES,
                         prefill=PREFILL, decode=DECODE)


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
                  tokens=dq["tokens"])]
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("tp4"))


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

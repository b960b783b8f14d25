"""The port's LM steps over the worker axes of a mesh against the JAX
package (see tests/test_torch_lm_mesh.py): the zoo on a (2, 1) mesh, U = 2,
each rank one FL worker on 2 of the 4 rows.

Two JAX subprocesses at once on 2 host devices (`torch_lm_ranks.JAX_REF`,
the cases dealt out between them) run the
reference: the BEV train step of the smoke moonshot (MoE),
deepseek-v2-236b (MLA), mamba2-1.3b (SSD) and recurrentgemma-9b (RG-LRU
+ local attention) on (2, 1), B = 4, 3 steps, the draws replayed; the
qwen3-4b prefill on (2, 1); recurrentgemma's decode on one device, 40
steps into its 32-slot local ring.  Then one spawn of 2 ranks:

- the train steps at rtol 1e-5 / atol 1e-6 (the MoE's aux term the
  global batch's), every rank's result bitwise equal;
- prefill at rtol 1e-5; recurrentgemma's decode at rtol 1e-4, each rank
  against its own rows' states and rings; greedy `serve` of qwen3-4b
  gives the one-process tokens.

Marked slow, as tests/test_distributed.py is.
"""
import numpy as np
import pytest
import torch

from torch_lm_ranks import (RTOL, assert_train_matches, close, close_decode,
                            jax_reference, train_job)
from torch_parity import assert_ranks_agree, run_ranks

from repro_torch.configs import get_smoke
from repro_torch.launch.serve import serve

pytestmark = pytest.mark.slow

MESH_21 = ((2, 1), ("data", "model"))
SERVE = dict(batch=4, prompt_len=8, gen=8, seed=3)
# the MLA, SSD and RG-LRU archs' train step on (2, 1)
MLA_SSM = ("deepseek-v2-236b", "mamba2-1.3b", "recurrentgemma-9b")
# recurrentgemma's decode on (2, 1): batch 4, 40 steps (its ring is 32)
RG_DECODE = dict(batch=4, n=40, seed=6)
BEV = [("bev", True)]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`torch_lm_ranks.JAX_REF`), once, in two
    subprocesses at once with 2 host devices each."""
    train = {"moe": ((2, 1), BEV, "moonshot-v1-16b-a3b", None, 4),
             **{arch: ((2, 1), BEV, arch, None, 4) for arch in MLA_SSM}}
    return jax_reference(
        tmp_path_factory, 2, train=train,
        prefill={"prefill": ((2, 1), "qwen3-4b", 4, 24, 9)},
        decode={"decode_rg": ("recurrentgemma-9b",
                              *RG_DECODE.values())}, procs=2)


@pytest.fixture(scope="module")
def ranks2(jax_ref, tmp_path_factory):
    """One spawn of 2 gloo ranks on (2, 1): the MoE, MLA, SSD and RG-LRU
    train steps, prefill, greedy serve and recurrentgemma's decode."""
    pf = jax_ref["prefill"]
    jobs = [train_job("moe", jax_ref["moe"], MESH_21, "bev", True,
                      "moonshot-v1-16b-a3b", 4),
            dict(name="prefill", kind="prefill", mesh=MESH_21,
                 arch="qwen3-4b", params0=pf["params0"], tokens=pf["tokens"]),
            dict(name="serve", kind="serve", mesh=MESH_21, arch="qwen3-4b",
                 **SERVE)]
    jobs += [train_job(arch, jax_ref[arch], MESH_21, "bev", True, arch, 4)
             for arch in MLA_SSM]
    rg = jax_ref["decode_rg"]
    jobs.append(dict(name="decode_rg", kind="decode", mesh=MESH_21,
                     arch="recurrentgemma-9b", params0=rg["params0"],
                     tokens=rg["tokens"]))
    return run_ranks(jobs, 2, tmp_path_factory.mktemp("ranks2"))


def test_moe_train_step_on_two_ranks_matches_jax(ranks2, jax_ref):
    """The smoke moonshot on (2, 1): the MoE aux term of the weighted loss
    is the global batch's (its counts and probability sums all_reduced),
    as in the reference."""
    assert_ranks_agree(ranks2, "moe", 2, skip=("worker",))
    assert_train_matches(ranks2["moe.r0"], jax_ref["moe"][("bev", True)])


@pytest.mark.parametrize("arch", MLA_SSM)
def test_mla_and_ssd_train_step_on_two_ranks_matches_jax(ranks2, jax_ref,
                                                         arch):
    """deepseek-v2-236b (MLA + MoE: the global aux), mamba2-1.3b (SSD)
    and recurrentgemma-9b (RG-LRU + local attention) on (2, 1), U = 2,
    each rank 2 of the 4 rows: the batch split and the gradients'
    all_reduce of the worker axes, no code of their own."""
    assert_ranks_agree(ranks2, arch, 2, skip=("worker",))
    assert [ranks2[f"{arch}.r{r}"]["worker"] for r in range(2)] == [
        (2, r, 1) for r in range(2)]
    assert_train_matches(ranks2[f"{arch}.r0"], jax_ref[arch][("bev", True)])


def test_prefill_on_two_ranks_matches_jax(ranks2, jax_ref):
    assert_ranks_agree(ranks2, "prefill", 2)
    got, want = ranks2["prefill.r0"]["logits"], jax_ref["prefill"]["logits"]
    assert got.shape == want.shape == (4, get_smoke("qwen3-4b").padded_vocab)
    close(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))


def test_rglru_hybrid_decode_on_two_ranks_matches_jax(ranks2, jax_ref):
    """recurrentgemma-9b on (2, 1), each rank decoding 2 of the 4 rows
    against its own RG-LRU states and local rings, 40 steps past the
    32-slot ring, against the JAX one-device step."""
    assert_ranks_agree(ranks2, "decode_rg", 2)
    got, want = ranks2["decode_rg.r0"], jax_ref["decode_rg"]["logits"]
    assert got["cache_batch"] == RG_DECODE["batch"] // 2
    close_decode(got["logits"], want)


def test_greedy_serve_on_two_ranks_equals_one_process(ranks2):
    assert_ranks_agree(ranks2, "serve", 2)
    cfg = get_smoke("qwen3-4b")
    one = serve(cfg, SERVE["batch"], SERVE["prompt_len"], SERVE["gen"],
                device="cpu", seed=SERVE["seed"])
    got = ranks2["serve.r0"]
    assert torch.equal(got["tokens"], one.tokens)
    close(got["logits"], one.logits.numpy(), rtol=RTOL,
           atol=RTOL * float(one.logits.abs().max()))

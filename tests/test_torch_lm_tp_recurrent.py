"""The port's LM steps over a "model" axis against the JAX package (see
tests/test_torch_lm_tp.py): the recurrent family.  mamba2-1.3b (SSD) and
recurrentgemma-9b (RG-LRU + local attention) on (1, 2) and (1, 4): their
train steps, and their decodes against the one-device step (mamba2 10
steps, recurrentgemma 40, past its 32-slot local ring).

Two JAX subprocesses at once on 4 host devices (`torch_lm_ranks.JAX_REF`,
the cases dealt out between them) run the
reference on the same meshes (B = 4, BEV, 3 steps, the draws replayed);
then one spawn of 2 ranks and one of 4.  Train at rtol 1e-5 / atol 1e-6,
decode at rtol 1e-4.  The steps run the default "sequence" route (the
residual stream split over "model" on the sequence; each scan gathers
the whole sequence); mb12 and rg14 also run "batch_only" (replicated)
against the same reference.

Marked slow, as tests/test_torch_lm_mesh.py is.
"""
import pytest

from torch_lm_ranks import (batch_only_jobs, check_batch_only, check_train,
                            close_decode, decode_jobs, jax_reference,
                            train_jobs)
from torch_parity import assert_ranks_agree, run_ranks

from repro_torch.configs import get_smoke

pytestmark = pytest.mark.slow

TRAIN_CASES = {   # name: (mesh shape, routes, arch, moe impl, batch)
    "mb12": ((1, 2), [("bev", True)], "mamba2-1.3b", None, 4),
    "mb14": ((1, 4), [("bev", True)], "mamba2-1.3b", None, 4),
    "rg12": ((1, 2), [("bev", True)], "recurrentgemma-9b", None, 4),
    "rg14": ((1, 4), [("bev", True)], "recurrentgemma-9b", None, 4),
}
SPAWNS = {2: ("mb12", "rg12"), 4: ("mb14", "rg14")}
# the one-device decode against the model-axis decodes: (arch, meshes)
DECODE_MESHES = {"mamba2-1.3b": ((1, 2), (1, 4)),
                 "recurrentgemma-9b": ((1, 2), (1, 4))}
# decode steps of each: recurrentgemma's run past its 32-slot ring
DECODE_STEPS = {"mamba2-1.3b": 10, "recurrentgemma-9b": 40}
ARCH_M = [("mamba2-1.3b", 2), ("mamba2-1.3b", 4)]
BATCH_ONLY = {2: ("mb12",), 4: ("rg14",)}   # also run on "batch_only"


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`torch_lm_ranks.JAX_REF`), once, in two
    subprocesses at once with 4 host devices each."""
    return jax_reference(tmp_path_factory, 4, train=TRAIN_CASES, decode={
        "decode_" + a: (a, 4, n, 5) for a, n in DECODE_STEPS.items()},
        procs=2)


@pytest.fixture(scope="module")
def ranks2(jax_ref, tmp_path_factory):
    """2 ranks: the train cases on (1, 2) and the decodes on (1, 2)."""
    jobs = [j for n in SPAWNS[2] for j in train_jobs(jax_ref, n,
                                                      TRAIN_CASES)]
    jobs += batch_only_jobs(jax_ref, BATCH_ONLY[2], TRAIN_CASES)
    return run_ranks(jobs + decode_jobs(jax_ref, 2, DECODE_MESHES), 2,
                     tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """4 ranks: the train cases on 4 ranks and the decodes on (1, 4)."""
    jobs = [j for n in SPAWNS[4] for j in train_jobs(jax_ref, n,
                                                      TRAIN_CASES)]
    jobs += batch_only_jobs(jax_ref, BATCH_ONLY[4], TRAIN_CASES)
    return run_ranks(jobs + decode_jobs(jax_ref, 4, DECODE_MESHES), 4,
                     tmp_path_factory.mktemp("tp4"))


@pytest.mark.parametrize("name", ["mb12", "mb14"])
def test_mla_and_ssd_on_model_meshes_match_jax(ranks2, ranks4, jax_ref,
                                               name):
    """mamba2-1.3b (the SSD mixer: in_proj's columns gathered, the heads
    split, the gated norm's mean square summed over the ranks) on (1, 2),
    and on (1, 4), where in_proj's 138-column shards cut across the z /
    xBC boundary at 256; against the reference on the same mesh, the
    gathered trees bitwise across ranks."""
    world = TRAIN_CASES[name][0][1]
    ranks = ranks2 if world == 2 else ranks4
    check_train(ranks, jax_ref, world, name, ("bev", True), TRAIN_CASES)
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


@pytest.mark.parametrize("arch,m", ARCH_M)
def test_mla_and_ssd_decode_on_model_meshes(ranks2, ranks4, jax_ref, arch,
                                            m):
    """Teacher-forced decode on (1, M) against the one-device JAX step: an
    SSD rank keeps the conv window of its x channels plus B and C."""
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
    close_decode(got["logits"], want)


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
    check_train(ranks, jax_ref, world, name, ("bev", True), TRAIN_CASES)
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
    close_decode(got["logits"], want)


@pytest.mark.parametrize("name", ["mb12", "rg14"])
def test_batch_only_route_matches_jax(ranks2, ranks4, jax_ref, name):
    """mamba2 (SSD) on (1, 2) and recurrentgemma (RG-LRU + local
    attention) on (1, 4) on "batch_only", the residual replicated over
    "model", against the same reference, which splits the sequence."""
    world = TRAIN_CASES[name][0][1]
    check_batch_only(ranks2 if world == 2 else ranks4, jax_ref, world, name,
                     TRAIN_CASES)

"""The port's LM steps over a "model" axis against the JAX package (see
tests/test_torch_lm_tp.py): the MoE and MLA family.  The smoke moonshot
(MoE) on (1, 2) and (2, 2), and with impl="capacity_gather" on (1, 2);
deepseek-v2-236b (MLA + MoE) on (1, 2), its train step and its decode
(10 steps) against the one-device step.

Two JAX subprocesses at once on 4 host devices (`torch_lm_ranks.JAX_REF`,
the cases dealt out between them) run the
reference on the same meshes (B = 4, BEV, 3 steps, the draws replayed);
then one spawn of 2 ranks and one of 4.  Train at rtol 1e-5 / atol 1e-6,
decode at rtol 1e-4.  The steps run the default "sequence" route (the
residual stream split over "model" on the sequence); moe12 and ds12 also
run "batch_only" (replicated) against the same reference.

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
    "moe12": ((1, 2), [("bev", True)], "moonshot-v1-16b-a3b", None, 4),
    "moe22": ((2, 2), [("bev", True)], "moonshot-v1-16b-a3b", None, 4),
    "cap12": ((1, 2), [("bev", True)], "moonshot-v1-16b-a3b",
              "capacity_gather", 4),
    "ds12": ((1, 2), [("bev", True)], "deepseek-v2-236b", None, 4),
}
SPAWNS = {2: ("moe12", "cap12", "ds12"), 4: ("moe22",)}
# the one-device decode against the model-axis decodes: (arch, meshes)
DECODE_MESHES = {"deepseek-v2-236b": ((1, 2),)}
DECODE_STEPS = {"deepseek-v2-236b": 10}
ARCH_M = [("deepseek-v2-236b", 2)]
BATCH_ONLY = ("moe12", "ds12")   # also run on "batch_only" (2 ranks)


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
    jobs += batch_only_jobs(jax_ref, BATCH_ONLY, TRAIN_CASES)
    return run_ranks(jobs + decode_jobs(jax_ref, 2, DECODE_MESHES), 2,
                     tmp_path_factory.mktemp("tp2"))


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """4 ranks: the train cases on 4 ranks and the decodes on (1, 4)."""
    jobs = [j for n in SPAWNS[4] for j in train_jobs(jax_ref, n,
                                                      TRAIN_CASES)]
    return run_ranks(jobs + decode_jobs(jax_ref, 4, DECODE_MESHES), 4,
                     tmp_path_factory.mktemp("tp4"))


@pytest.mark.parametrize("name", ["moe12", "moe22", "cap12"])
def test_moe_on_model_meshes_matches_jax(ranks2, ranks4, jax_ref, name):
    """The smoke moonshot: scan_dense with each expert's f split (and the
    shared experts'), one reduce a layer, on (1, 2) and (2, 2); the
    capacity_gather impl expert-parallel (2 of 4 experts a rank) on (1, 2).
    The replicated f32 router's gradient is whole on both ranks, so the
    gathered trees agree bitwise."""
    ranks, world = (ranks4, 4) if name == "moe22" else (ranks2, 2)
    check_train(ranks, jax_ref, world, name, ("bev", True), TRAIN_CASES)


@pytest.mark.parametrize("name", ["ds12"])
def test_mla_and_ssd_on_model_meshes_match_jax(ranks2, ranks4, jax_ref,
                                               name):
    """deepseek-v2-236b (MLA: wq_a's q_lora columns gathered, the heads
    split, the latent whole on every rank; the MoE's f split) on (1, 2),
    against the reference on the same mesh, the gathered trees bitwise
    across ranks."""
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
    MLA rank keeps the whole latent cache [L, B, S, kv_lora]."""
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


@pytest.mark.parametrize("name", BATCH_ONLY)
def test_batch_only_route_matches_jax(ranks2, jax_ref, name):
    """moonshot (MoE) and deepseek (MLA + MoE) on "batch_only", the
    residual replicated over "model", against the same reference, which
    splits the sequence: the router and the aux loss see the whole
    sequence on both routes."""
    check_batch_only(ranks2, jax_ref, 2, name, TRAIN_CASES)

"""The frontends' LM steps over ranks against the JAX package:
llava-next-mistral-7b (the VLM prefix) and seamless-m4t-large-v2 (the
encoder-decoder) at their smoke configs, on one spawn of 2 gloo CPU ranks
(tests/torch_dist_driver.py's LM-step jobs).

One JAX subprocess on 2 host devices runs the reference
(`torch_lm_ranks.JAX_REF`): the BEV train step of both on (1, 2)
("data", "model") at model_parallel = 2 and of seamless on (2, 1), B = 4,
3 steps, with a prefix of 16 positions or 12 frames a row; and the
one-device decode of both (llava 12 text steps, seamless 10 against the
cross K / V of 12 frames).  On (1, 2) each rank holds its shards: the
projector's w1 / w2 and enc_in split their columns (gathered into the
replicated stream), the self- and cross-attentions their heads, the
embedding, head and CE the vocab; on (2, 1) each rank is one FL worker
on 2 rows, frames and all.  Train at rtol 1e-5 / atol 1e-6, every rank's
gathered params bitwise equal; decode at rtol 1e-4 against the
one-device JAX step.
"""
import pytest

from torch_lm_ranks import (AXES, ROUTES, assert_train_matches,
                            check_train, close_decode, jax_reference,
                            train_jobs)
from torch_parity import assert_ranks_agree, run_ranks

from repro_torch.configs import get_smoke

pytestmark = pytest.mark.slow

VLM, AUDIO = "llava-next-mistral-7b", "seamless-m4t-large-v2"
BEV = ROUTES[:1]
TRAIN = {"lv12": ((1, 2), BEV, VLM, None, 4),
         "sm12": ((1, 2), BEV, AUDIO, None, 4),
         "sm21": ((2, 1), BEV, AUDIO, None, 4)}
DECODE = {"decode_" + VLM: (VLM, 4, 12, 5),
          "decode_" + AUDIO: (AUDIO, 4, 10, 5)}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return jax_reference(tmp_path_factory, 2, train=TRAIN, decode=DECODE)


@pytest.fixture(scope="module")
def ranks2(jax_ref, tmp_path_factory):
    """2 ranks: the three train cases, and both decodes on (1, 2)."""
    jobs = [j for name in TRAIN for j in train_jobs(jax_ref, name, TRAIN)]
    for name, (arch, *_) in DECODE.items():
        ref = jax_ref[name]
        jobs.append(dict(name=name, kind="decode", mesh=((1, 2), AXES),
                         arch=arch, params0=ref["params0"],
                         tokens=ref["tokens"], frames=ref.get("frames")))
    return run_ranks(jobs, 2, tmp_path_factory.mktemp("frontends2"))


@pytest.mark.parametrize("name", ["lv12", "sm12"])
def test_frontends_train_on_model_meshes_matches_jax(ranks2, jax_ref,
                                                     name):
    """(1, 2): llava's projector split on its columns, seamless's enc_in
    on its columns and its cross-attention on the heads; against the
    reference on the same mesh, the gathered trees bitwise across
    ranks."""
    check_train(ranks2, jax_ref, 2, name, BEV[0], TRAIN)
    specs = ranks2[f"{name}_bev_True.r0"]["meta"]["params_specs"]
    if name == "lv12":
        assert specs["projector"] == {"w1": 1, "b1": None, "w2": 1,
                                      "b2": None}
    else:
        assert specs["enc_in"] == 1 and specs["embed"] == 0
        assert {k: specs["dec_blocks"]["cross_attn"][k] for k in (
            "wq", "wk", "wv", "wo")} == {"wq": 2, "wk": 2, "wv": 2, "wo": 1}
        assert specs["enc_blocks"]["ffn"] == {"wi": 2, "wg": 2, "wo": 1}


def test_seamless_train_on_two_workers_matches_jax(ranks2, jax_ref):
    """(2, 1): U = 2, each rank the frames and tokens of its 2 rows; the
    batch split and the gradients' all_reduce, no code of their own."""
    job = "sm21_bev_True"
    assert_ranks_agree(ranks2, job, 2, skip=("worker",))
    assert [ranks2[f"{job}.r{r}"]["worker"] for r in range(2)] == [
        (2, r, 1) for r in range(2)]
    assert_train_matches(ranks2[f"{job}.r0"], jax_ref["sm21"][BEV[0]])


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_frontends_decode_on_model_meshes(ranks2, jax_ref, arch):
    """Teacher-forced decode on (1, 2) against the one-device JAX step: a
    rank's caches hold its KV heads (llava's the 64-slot ring's), its
    cross K / V the same heads of the encoder output."""
    name = "decode_" + arch
    assert_ranks_agree(ranks2, name, 2, skip=("model",))
    got = ranks2[f"{name}.r0"]
    cfg = get_smoke(arch)
    layers = cfg.encdec.n_dec_layers if cfg.encdec else cfg.n_layers
    assert got["cache_shape"] == (layers, 4, DECODE[name][2],
                                  cfg.n_kv_heads // 2, cfg.hd)
    close_decode(got["logits"], jax_ref[name]["logits"])

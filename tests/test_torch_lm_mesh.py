"""The port's LM steps over the worker axes of a mesh against the JAX
package: `launch.steps` with a `launch.mesh.SweepMesh` over gloo CPU ranks
(tests/torch_dist_driver.py's LM-step jobs), one rank a FL worker.  The
smoke qwen3-4b and starcoder2-3b; the other archs over the worker axes
are in tests/test_torch_lm_mesh_zoo.py (and the frontends' in
tests/test_torch_lm_tp_frontends.py).

One JAX subprocess on 4 host devices (`torch_lm_ranks.JAX_REF`) runs the
reference: the FLOA train step of the smoke qwen3-4b (f32) on a (4, 1)
("data", "model") debug mesh, B = 8, 3 steps, for BEV, CI and EF with
n_byzantine = 2 (one strongest attacker at U = 4) and for use_floa=False;
the smoke starcoder2-3b's decode step on one device, teacher-forced 72
steps into its 64-slot ring.  It also replays each train step's draws
(gains off PRNGKey(t)'s first key, leaf i's noise off fold_in(second
key, i)), which the port's ranks consume, from the JAX initial weights.
Then one spawn of 4 ranks:

- the train step on (4, 1): params, gbar, eps2 and the metrics at rtol
  1e-5 / atol 1e-6, every rank's result bitwise equal; the same BEV case
  on a (2, 2, 1) ("pod", "data", "model") mesh equals the (4, 1) run;
- decode on (4, 1) (a rank-local batch of 2 against rank-local ring
  caches) at rtol 1e-4, every rank's gathered logits equal;
- `combine_partials` over a 4-rank ("model",) mesh within 1e-5 of both
  decode_attention_refs;
- the refusals, the one-process twin, the chunked update, and the
  training entry point on 2 torchrun-style ranks.

Marked slow, as tests/test_distributed.py is.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.kernels.ref import decode_attention_ref as jdecode_ref

from torch_lm_ranks import (ALPHA, ROOT, ROUTES, assert_train_matches,
                            close_decode, jax_reference, train_job)
from torch_parity import assert_ranks_agree, assert_trees_equal, run_ranks

from repro_torch.configs import get_smoke
from repro_torch.kernels import ref as TREF
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import (Q_MODEL_AXIS, ModelAxis, WorkerAxes,
                                     make_debug_mesh, mesh_from_arg,
                                     worker_axes)
from repro_torch.models import attention as TATT
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

pytestmark = pytest.mark.slow

BATCH = 8
MESH_41 = ((4, 1), ("data", "model"))
MESH_221 = ((2, 2, 1), ("pod", "data", "model"))
# module 6's contract (tests/test_distributed.py:140-170)
SEQ_SHAPE = dict(b=2, h=8, kv=2, dh=32, s=256, pos=200)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results (`torch_lm_ranks.JAX_REF`), once, in a
    subprocess with 4 host devices."""
    return jax_reference(
        tmp_path_factory, 4,
        train={"train": ((4, 1), ROUTES, "qwen3-4b", None, BATCH)},
        decode={"decode": ("starcoder2-3b", 8, 72, 3)})   # 64-slot ring

def _seq_inputs():
    g = np.random.default_rng(0)
    b, h, kv, dh, s = (SEQ_SHAPE[k] for k in ("b", "h", "kv", "dh", "s"))
    return {"q": g.standard_normal((b, h, dh)).astype(np.float32),
            "k": g.standard_normal((b, s, kv, dh)).astype(np.float32),
            "v": g.standard_normal((b, s, kv, dh)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks4(jax_ref, tmp_path_factory):
    """One spawn of 4 gloo ranks: the train step on (4, 1) for every route
    and BEV on (2, 2, 1), decode on (4, 1), combine_partials over a
    ("model",) mesh of 4, the refusals."""
    tr, dec = jax_ref["train"], jax_ref["decode"]
    jobs = [train_job(f"train_{p}_{f}", tr, MESH_41, p, f, "qwen3-4b", BATCH)
            for p, f in ROUTES]
    jobs.append(train_job("train_bev_pod", tr, MESH_221, "bev", True,
                          "qwen3-4b", BATCH))
    jobs.append(dict(name="decode", kind="decode", mesh=MESH_41,
                     arch="starcoder2-3b", params0=dec["params0"],
                     tokens=dec["tokens"]))
    jobs.append(dict(name="seq", kind="seq_partial", mesh=((4,), ("model",)),
                     pos=SEQ_SHAPE["pos"], **_seq_inputs()))
    jobs.append(dict(name="refusals", kind="refusals"))
    return run_ranks(jobs, 4, tmp_path_factory.mktemp("ranks4"))


@pytest.mark.parametrize("policy,use_floa", ROUTES)
def test_train_step_on_four_ranks_matches_jax(ranks4, jax_ref, policy,
                                              use_floa):
    """U = 4 workers, one a rank: with FLOA one strongest attacker (worker
    0), and the port's ranks bitwise equal to each other."""
    name = f"train_{policy}_{use_floa}"
    assert_ranks_agree(ranks4, name, 4, skip=("worker",))
    got = ranks4[f"{name}.r0"]
    assert [ranks4[f"{name}.r{r}"]["worker"] for r in range(4)] == [
        (4, r, 1) for r in range(4)]
    assert_train_matches(got, jax_ref["train"][(policy, use_floa)])
    assert got["meta"]["num_workers"] == 4
    floa = TSTEPS.default_floa(WorkerAxes(4), got["meta"]["dim"])
    assert floa["attack"].byzantine_mask == (True, False, False, False)


def test_pod_data_mesh_orders_workers_row_major(ranks4):
    """On (2, 2, 1) ("pod", "data", "model") rank r is worker pod * 2 +
    data = r, holding rows [2r, 2r + 2): the same BEV run as on (4, 1),
    attacker and all, bit for bit."""
    assert [ranks4[f"train_bev_pod.r{r}"]["worker"] for r in range(4)] == [
        (4, r, 1) for r in range(4)]
    pod, flat = ranks4["train_bev_pod.r0"], ranks4["train_bev_True.r0"]
    assert_trees_equal(pod["params"], flat["params"], "params")
    assert_trees_equal(pod["log"], flat["log"], "log")


def test_moe_aux_loss_is_the_global_batch_s(monkeypatch):
    """Under `worker_batch` one row block's aux loss, its sums added to the
    other block's (a stand-in for the all_reduce of two ranks), equals the
    whole batch's aux, which the block's own aux does not; the gradient
    through the sums is the block's own share.  capacity_gather refuses
    the worker axes."""
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(12, 4, generator=g), dim=-1)
    idx = torch.topk(probs, 2, dim=-1).indices
    whole = TMOE.load_balance_loss(probs, idx, 4)
    first = TMOE.load_balance_loss(probs[:6], idx[:6], 4)
    assert not torch.allclose(first, whole)
    hot = torch.nn.functional.one_hot(idx[6:], 4).float().sum(dim=1)
    other = torch.cat([probs[6:].sum(0), hot.sum(0), torch.tensor([6.0])])
    monkeypatch.setattr(TMOE, "all_reduce_sum_local_grad",
                        lambda x, group: x + other)
    with TMOE.worker_batch(group="two ranks"):
        got = TMOE.load_balance_loss(probs[:6], idx[:6], 4)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)
    cfg = get_smoke("moonshot-v1-16b-a3b")
    p = TT.init_lm(torch.Generator().manual_seed(0), cfg)["blocks"]["b0"]
    expert = {k: v[0] for k, v in p["ffn"].items() if k != "shared"}
    with pytest.raises(NotImplementedError, match="capacity"):
        with TMOE.worker_batch(group="two ranks"):
            TMOE.moe_capacity_gather(expert, torch.zeros(4, cfg.d_model),
                                     cfg)


def test_decode_on_four_ranks_matches_jax(ranks4, jax_ref):
    """starcoder2-3b's 64-slot ring past its wrap, each rank decoding 2 of
    the 8 rows against its own caches; every rank returns all 8 rows."""
    assert_ranks_agree(ranks4, "decode", 4)
    got, want = ranks4["decode.r0"], jax_ref["decode"]["logits"]
    assert got["cache_batch"] == 2
    assert got["logits"].shape == want.shape
    close_decode(got["logits"], want)


def test_combine_partials_over_four_ranks(ranks4):
    """Module 6's contract: err < 1e-5 against decode_attention_ref, the
    port's and the JAX package's."""
    assert_ranks_agree(ranks4, "seq", 4)
    x = _seq_inputs()
    got = ranks4["seq.r0"]["out"]
    pos = SEQ_SHAPE["pos"]
    port = TREF.decode_attention_ref(*(torch.as_tensor(x[n]) for n in "qkv"),
                                     pos)
    jref = np.asarray(jdecode_ref(*(jnp.asarray(x[n]) for n in "qkv"),
                                  jnp.int32(pos)))
    assert float((got - port).abs().max()) < 1e-5
    assert float(np.abs(got.numpy() - jref).max()) < 1e-5


def test_mesh_refusals(ranks4):
    """Raised on 4 ranks: a (data, model) shape of 2 x 2, which names no
    ranks, a mesh of half the ranks and a batch of 6 over U = 4
    (ValueError)."""
    r = ranks4["refusals.r0"]
    assert r["model_axis"][0] == "ValueError" and "names no ranks" in \
        r["model_axis"][1]
    assert r["half_mesh"][0] == "ValueError" and "spans every rank" in \
        r["half_mesh"][1]
    assert r["batch"] == ("ValueError", "global batch 6 is not a multiple "
                                        "of U = 4 workers")
    assert_ranks_agree(ranks4, "refusals", 4)


def test_mesh_refusals_in_one_process():
    cfg = get_smoke("qwen3-4b")
    for spec, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError,
                           match=f"needs {ranks} ranks; the process group "
                                 f"has 1"):
            mesh_from_arg(spec)
    for spec in ("2x1", "4x2"):
        with pytest.raises(ValueError,
                           match="mesh_from_arg's docstring"):
            mesh_from_arg(spec)
    with pytest.raises(ValueError, match="names no ranks"):
        TSTEPS.make_prefill_step(cfg, (2, 2))
    # every GQA layout runs (the reference's `_wspec` fallback): at M = 4
    # every rank computes all 6 heads; at M = 2 a rank's 3 query heads read
    # a window of 2 of the 3 KV heads
    big = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    for m in (2, 4, 16):
        TATT.check_heads(big, m)
    assert TATT.local_heads(big, 4, 1) == (slice(0, 6), slice(0, 3))
    assert TATT.local_heads(big, 2, 1) == (slice(3, 6), slice(1, 3))
    # MLA heads the axis does not divide are still refused
    mla = dataclasses.replace(get_smoke("deepseek-v2-236b"), n_heads=3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8d"):
        TATT.check_heads(mla, 4)
    assert Q_MODEL_AXIS in str(pytest.raises(
        NotImplementedError, TATT.check_heads, mla, 2).value)
    with pytest.raises(ValueError, match="process group"):
        ModelAxis(2, 1, None)
    with pytest.raises(TypeError, match="is not a mesh"):
        TSTEPS.make_decode_step(cfg, mesh=ModelAxis())
    with pytest.raises(ValueError, match="names no ranks"):
        TSTEPS.make_decode_step(cfg, mesh=(2, 1))
    assert mesh_from_arg("1x1") is None
    assert worker_axes(make_debug_mesh((1, 1), ("data", "model"))) == \
        WorkerAxes(1)
    assert TSTEPS.batch_rows(None, 6) == slice(0, 6)


def test_one_process_twin_is_the_reference_layout():
    """`WorkerAxes.every(U)` holds all U workers in one process: the
    weighted loss over U row blocks, the same step the ranks take
    together; at U = 1 it is the mesh-free step bit for bit."""
    cfg = get_smoke("qwen3-4b")
    shape = dict(global_batch=4, seq_len=8, kind="train")
    params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (4, 9),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for name, mesh in (("none", None), ("every1", WorkerAxes.every(1)),
                       ("every4", WorkerAxes.every(4))):
        step, meta = TSTEPS.make_train_step(cfg, mesh, shape, alpha=ALPHA)
        runs[name] = step(params, TSTEPS.init_floa_state(),
                          {"tokens": tokens}, 5)
    assert_trees_equal(runs["every1"][0], runs["none"][0])
    assert_trees_equal(runs["every1"][1], runs["none"][1])
    assert meta["num_workers"] == 4
    assert not torch.equal(runs["every4"][0]["embed"],
                           runs["none"][0]["embed"])
    with pytest.raises(ValueError, match="not a multiple of U = 4"):
        step(params, TSTEPS.init_floa_state(), {"tokens": tokens[:3]}, 0)


def test_update_in_chunks_is_one_pass_bit_for_bit(monkeypatch):
    """The train step's per-leaf update (`_noisy_sgd`) cut into chunks of
    4097 elements gives the bits of one pass, bf16 and f32, with noise."""
    runs = []
    for chunk in (4097, 2 ** 26):
        monkeypatch.setattr(TSTEPS, "UPDATE_CHUNK", chunk)
        out = []
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(get_smoke("qwen3-4b"), dtype=dtype)
            step, _ = TSTEPS.make_train_step(
                cfg, None, dict(global_batch=2, seq_len=8, kind="train"),
                alpha=ALPHA)
            params = TT.init_lm(torch.Generator().manual_seed(0), cfg)
            tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                                   generator=torch.Generator().manual_seed(1))
            out.append(step(params, TSTEPS.init_floa_state(),
                            {"tokens": tokens}, 3)[0])
        runs.append(out)
    assert_trees_equal(runs[0], runs[1], "params")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_entry_point_on_two_ranks(tmp_path):
    """`python -m repro_torch.launch.train --mesh 2x1 --device cpu` on two
    ranks started as torchrun starts them (WORLD_SIZE, RANK, MASTER_ADDR /
    MASTER_PORT on localhost): rank 0 prints one finite loss line a step
    and writes the checkpoint, rank 1 prints nothing."""
    port = _free_port()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-4b", "--smoke", "--device", "cpu", "--mesh", "2x1",
           "--steps", "2", "--batch", "4", "--seq", "8", "--byzantine",
           "2", "--ckpt", str(tmp_path)]
    procs = [subprocess.Popen(
        cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                            OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), WORLD_SIZE="2",
                            RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    outs = [out for out, _ in outs]
    lines = [x for x in outs[0].splitlines() if x.startswith("step")]
    assert len(lines) == 2 and "workers=2" in outs[0], outs[0]
    assert all(np.isfinite(float(x.split()[3])) for x in lines)
    assert outs[1].strip() == "", outs[1]
    assert (tmp_path / "ckpt_2.meta.json").exists()

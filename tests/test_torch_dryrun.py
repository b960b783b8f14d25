"""`python -m repro_torch.launch.dryrun`, the counterpart of
`repro/launch/dryrun.py`, in this process and its subprocesses (its rank
check against a real gloo run is in tests/test_torch_fsdp_ranks.py):

- each of the ten full archs at long_500k on the 16 x 16 mesh: "skip" for
  seamless-m4t-large-v2 (its skip_shapes), "ok" for the rest, starcoder2-3b
  and llama4 included (their 24 and 40 heads over 16 "model" ranks: the
  reference's `_wspec` fallback, every head on every rank), with a rank's
  parameter bytes the reference's spec arithmetic under `fsdp_augment`
  and the argument bytes those plus its caches, tokens and position;
- a trace on fake tensors against the same step run for real on CPU
  zeros (one device): equal operations, argument bytes and peak;
- the card route traces the decode kernel by its fake rule and cost;
- `--all` resumes, and records a failing combo as "fail";
- the records carry the route of the residual stream (`constrain`):
  "sequence" by default, "batch_only" where asked for or where the
  "model" axis does not divide the sequence (a VLM's prefix plus its
  tokens, an encoder-decoder's frames), none for decode.
"""
import dataclasses
import json
import math
import warnings

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

with warnings.catch_warnings():
    # jax 0.9 deprecates jax.experimental.shard_map, which the reference
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as jget_config
    from repro.launch import steps as JSTEPS
    from repro.launch.sharding import fsdp_augment as jfsdp_augment

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import steps as TSTEPS
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

class StandIn:
    shape = {"data": 16, "model": 16}


def _reference_param_bytes(arch):
    """A rank's parameter bytes on the reference's 16 x 16 mesh: each leaf
    over the sizes of the axes its `fsdp_augment`ed spec names."""
    jcfg = dataclasses.replace(jget_config(arch), model_parallel=16)
    shapes, specs = JSTEPS.init_model(jcfg, jax.random.PRNGKey(0),
                                      shape_only=True)
    specs = jfsdp_augment(specs, shapes, StandIn())
    return sum(math.prod(x.shape) * x.dtype.itemsize
               // (16 if "data" in s else 1) // (16 if "model" in s else 1)
               for x, s in zip(jax.tree_util.tree_leaves(shapes),
                               jax.tree_util.tree_leaves(
                                   specs, is_leaf=lambda z:
                                   isinstance(z, P))))


def test_every_arch_at_long_500k_on_single(tmp_path):
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        rec = DRY.run_one(arch, "long_500k", "single", str(tmp_path))
        on_disk = json.loads((tmp_path / f"{arch}__long_500k__single.json")
                             .read_text())
        assert on_disk["status"] == rec["status"]
        if arch == "seamless-m4t-large-v2":
            assert rec["status"] == "skip"
            continue
        assert rec["status"] == "ok", arch
        mem = rec["memory"]
        assert mem["param_bytes"] == _reference_param_bytes(arch), arch
        cfg = get_config(arch)
        caches = TT.init_caches(cfg, 1, 524288, device="meta",
                                window=rec["meta"]["window"],
                                model_parallel=16)
        assert mem["argument_size"] == mem["param_bytes"] + sum(
            x.numel() * x.element_size() for x in tree_leaves(caches)) \
            + 4 + 4, arch
        assert rec["chips"] == 256 and rec["workers"] == 16
        assert rec["collectives"]["by_link"]["nvlink"] == 0
        assert rec["collectives"]["all_gather"] > 0
        assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert 0 < rec["useful_ratio"] and mem["peak"] >= \
            mem["argument_size"]
        assert rec["largest_drawn_part"]["bytes"] > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_equals_a_real_run(kind):
    """One device, the CPU's route: the trace on fake tensors and the same
    step on CPU zeros count the same operations, bytes moved and argument
    bytes, and hold the same peak."""
    cfg = get_smoke("qwen3-4b")
    shape = dict(global_batch=4, seq_len=16, kind=kind)
    fake = DRY.trace_step(cfg, "decode_32k", shape, None, route="cpu")
    real = DRY.trace_step(cfg, "decode_32k", shape, None, route="cpu",
                          fake=False)
    for k in ("flops_per_device", "bytes_per_device", "collectives"):
        assert fake[k] == real[k], k
    for k in ("argument_size", "output_size", "peak", "param_bytes"):
        assert fake["memory"][k] == real["memory"][k], k
    assert fake["collectives"]["total"] == 0


def test_card_route_traces_the_decode_kernel_by_its_fake_rule():
    """Route "cuda": each layer's decode attention is the card op, counted
    at `bytes_flops`, in place of the plain version's products."""
    cfg = get_smoke("qwen3-4b")
    shape = dict(global_batch=4, seq_len=16, kind="decode")
    card = DRY.trace_step(cfg, "decode_32k", shape, None, route="cuda")
    cpu = DRY.trace_step(cfg, "decode_32k", shape, None, route="cpu")
    b, h, kv, dh, s = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 16
    with FakeTensorMode():
        q = torch.zeros(b, h, dh)
        k = torch.zeros(b, s, kv, dh)
        with FlopCounterMode(display=False) as fc:
            ref.decode_attention_ref(q, k, k, s - 1)
        out, ws = DA._card_route(q, k, k, torch.tensor([s - 1],
                                                       dtype=torch.int32))
    assert out.shape == q.shape
    assert ws.numel() == DA.split_plan(
        b, h, kv, s, dh, q.dtype,
        DA.H100_SMS * DA.H100_OCCUPANCY[(dh, q.dtype)])[1]
    kernel_flops = DA.bytes_flops(b, h, kv, dh, s, 4)[1]
    assert card["flops_per_device"] == cpu["flops_per_device"] + \
        cfg.n_layers * (kernel_flops - fc.get_total_flops())


def test_all_resumes_and_records_failures(tmp_path):
    """--all runs only the combos with no record (one subprocess each),
    and a combo that raises leaves a "fail" record."""
    done = tmp_path / "qwen3-4b__long_500k__single.json"
    done.write_text(json.dumps({"status": "ok", "kept": True}))
    fails = DRY.orchestrate(str(tmp_path), ["single"],
                            ["qwen3-4b", "seamless-m4t-large-v2"],
                            ["long_500k"], timeout=300)
    assert fails == 0
    assert json.loads(done.read_text()) == {"status": "ok", "kept": True}
    assert json.loads((tmp_path / "seamless-m4t-large-v2__long_500k__single"
                       ".json").read_text())["status"] == "skip"
    assert DRY.orchestrate(str(tmp_path), ["single"], ["no-such-arch"],
                           ["decode_32k"], timeout=300) == 1
    rec = json.loads((tmp_path / "no-such-arch__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "fail" and "unknown arch" in rec["error"]


@pytest.mark.parametrize("arch,seq,asked,want", [
    ("qwen3-4b", 16, "sequence", "sequence"),
    ("qwen3-4b", 16, "batch_only", "batch_only"),
    ("llava-next-mistral-7b", 31, "sequence", "batch_only"),  # 16 + 15
    ("llava-next-mistral-7b", 32, "sequence", "sequence"),
    ("seamless-m4t-large-v2", 18, "sequence", "batch_only"),  # 18 frames
])
def test_trace_records_the_residual_route(arch, seq, asked, want):
    """A smoke train and prefill step on (1, 4) of a fake group, traced:
    meta["constrain"] is the route taken, "batch_only" where 4 does not
    divide a stream (`steps.residual_route`); decode records none."""
    cfg = get_smoke(arch)
    with DRY.fake_group(4):
        mesh = make_debug_mesh((1, 4), ("data", "model"))
        for kind in ("train", "prefill"):
            shape = dict(global_batch=4, seq_len=seq, kind=kind)
            got = DRY.trace_step(cfg, "train_4k", shape, mesh,
                                 constrain=asked)
            assert got["meta"]["constrain"] == want, kind
        if arch == "qwen3-4b":
            dec = DRY.trace_step(cfg, "decode_32k", dict(
                global_batch=4, seq_len=seq, kind="decode"), mesh)
            assert "constrain" not in dec["meta"]
    assert not torch.distributed.is_initialized()


def test_constrain_is_checked_and_named_in_the_record(tmp_path):
    """An unknown constrain raises ValueError at the step's build; a
    combo run with --constrain batch_only writes its record beside the
    default's, under its own name."""
    cfg = get_smoke("qwen3-4b")
    for make in (TSTEPS.make_train_step, TSTEPS.make_prefill_step):
        with pytest.raises(ValueError, match="constrain"):
            make(cfg, None, dict(global_batch=4, seq_len=16),
                 constrain="model")
    rec = DRY.run_one("seamless-m4t-large-v2", "long_500k", "single",
                      str(tmp_path), "batch_only")
    assert rec["status"] == "skip" and rec["asked"] == "batch_only"
    assert (tmp_path / "seamless-m4t-large-v2__long_500k__single__"
            "batch_only.json").exists()

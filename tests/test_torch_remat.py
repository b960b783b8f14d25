"""Rematerialization in the port (`ModelConfig.remat`,
`models.common.recompute`), at the smoke configs on the CPU.

- One BEV train step with remat=True against remat=False, bitwise (new
  params, stale stats, metrics), for every arch family: dense qwen3-4b,
  moonshot (MoE), deepseek (MLA + MoE), mamba2 (SSD), recurrentgemma
  (RG-LRU + local_attn), llava (the projected prefix) and seamless (the
  encoder-decoder); remat recomputes each block once more than the
  remat-free step, whose CE chunks and expert chunks are recomputed too.
- qwen3-4b and seamless with remat=True on both sides against the JAX
  `make_train_step`, its draws replayed, at rtol 1e-5
  (`torch_arch_parity.check_train_step`).
- `moe_scan_dense` at a lowered EXPERT_CHUNK_BYTES: several expert chunks
  against one (rtol 1e-6: the sum's order) and against the JAX
  `moe_scan_dense` (rtol 1e-5), values and gradients; the serve, decode
  and smoke shapes take one chunk.
- A `RoutingTape` replay through a remat step: the recompute takes the
  forward's experts, records nothing, moves no cursor, counts no flip.
- The dry run's trace of a longer smoke sequence: a lower peak and more
  operations with remat.
- Inside `torch.func` (the sweep's per-worker `vmap(grad)`) a remat=True
  config runs without recompute, bitwise the remat=False one.
"""
import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.models import moe as JMOE

import torch_arch_parity as AP
from test_torch_moe import _cfgs, _params

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.aggregation import per_worker_grads
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import common as TC
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["qwen3-4b", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
         "mamba2-1.3b", "recurrentgemma-9b", "llava-next-mistral-7b",
         "seamless-m4t-large-v2"]
SHAPE = dict(global_batch=4, seq_len=24, kind="train")
ALPHA = 0.02
CHUNK_RTOL, RTOL = 1e-6, 1e-5


def _batch(cfg, seed, shape=SHAPE):
    """A train batch of cfg at `shape` (`steps.batch_shapes`): tokens from
    the vocab, the prefix or frames standard normal, from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, dt) in TSTEPS.batch_shapes(cfg, shape, "train").items():
        if k == "tokens":
            out[k] = torch.as_tensor(rng.integers(0, cfg.vocab_size, s),
                                     dtype=dt)
        else:
            out[k] = torch.as_tensor(rng.standard_normal(s, np.float32)
                                     ).to(dt)
    return out


def _weights(cfg, seed):
    """Random weights of cfg's tree, normal times 0.05 (the bitwise checks
    need any finite weights, not `ParamInit`'s truncated draws)."""
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda x: (torch.randn(x.shape, generator=g) * 0.05)
                    .to(x.dtype), TSTEPS.init_model(cfg, None, "meta"))


def _n_blocks(cfg):
    """The regions remat recomputes: super-blocks and tail blocks, or the
    encoder's and decoder's blocks."""
    if cfg.encdec is not None:
        return cfg.encdec.n_enc_layers + cfg.encdec.n_dec_layers
    return sum(TT.layer_counts(cfg))


def _step(cfg, params, batch, remat, monkeypatch, tape=None):
    """One seeded BEV step of cfg with `remat`, and the recomputes it made
    (`common._Reentered` entries)."""
    step, _ = TSTEPS.make_train_step(dataclasses.replace(cfg, remat=remat),
                                     None, SHAPE, alpha=ALPHA)
    entered = []
    enter = TC._Reentered.__enter__

    def counted(self):
        entered.append(1)
        return enter(self)

    monkeypatch.setattr(TC._Reentered, "__enter__", counted)
    with TMOE.routing(tape) if tape is not None else \
            contextlib.nullcontext():
        out = step(params, TSTEPS.init_floa_state(), batch, 3)
    monkeypatch.setattr(TC._Reentered, "__enter__", enter)
    return out, len(entered)


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)
    for i in (1, 2):
        assert a[i].keys() == b[i].keys()
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_bitwise_equals_no_remat(arch, monkeypatch):
    cfg = get_smoke(arch)
    assert cfg.remat is False and get_config(arch).remat is True
    params = _weights(cfg, 0)
    batch = _batch(cfg, 1)
    plain, n_plain = _step(cfg, params, batch, False, monkeypatch)
    remat, n_remat = _step(cfg, params, batch, True, monkeypatch)
    _assert_equal(remat, plain)
    assert torch.isfinite(remat[2]["loss"])
    # the CE chunks (and the expert chunks) are recomputed either way;
    # remat adds each block once
    assert n_plain >= 1
    assert n_remat - n_plain == _n_blocks(cfg)


@pytest.mark.parametrize("arch,extra", [
    ("qwen3-4b", None), ("seamless-m4t-large-v2", "frames")])
def test_remat_step_matches_jax_remat(arch, extra):
    """The port's remat step against the reference's, both remat=True."""
    more = None
    if extra:
        more = {"frames": np.random.default_rng(8).standard_normal(
            (2, 20, get_smoke(arch).frontend.feature_dim), np.float32)}
    AP.check_train_step(arch, batch=2, seq=16, seed=8, extra=more,
                        remat=True)


def _moe_grads(fn, p, x, r):
    """fn's output and the gradients of sum(out * r) over x and p."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = fn(leaves, xt)
    g = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                            [xt] + [leaves[k] for k in sorted(leaves)])
    return y.detach(), aux.detach(), g


def test_expert_chunks_match_one_chunk_and_jax(monkeypatch):
    e, t, d, f = 8, 48, 32, 16
    jcfg, tcfg = _cfgs(e=e, k=2, f=f, impl="scan_dense")
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((t, d), np.float32)
    r = rng.standard_normal((t, d), np.float32)

    def fn(p, xt):
        return TMOE.moe_scan_dense(p, xt, tcfg)

    assert TMOE.expert_chunk(e, t, d, f, 4) == e
    one = _moe_grads(fn, tp, x, r)
    per_expert = t * 3 * (f + d) * 4
    monkeypatch.setattr(TMOE, "EXPERT_CHUNK_BYTES", 3 * per_expert)
    assert TMOE.expert_chunk(e, t, d, f, 4) == 3        # chunks 3, 3, 2
    chunks = _moe_grads(fn, tp, x, r)
    for got, want in zip(chunks[:2] + chunks[2], one[:2] + one[2]):
        AP.close(got, want.numpy(), CHUNK_RTOL)

    def jloss(p, xj):
        y, aux = JMOE.moe_scan_dense(p, xj, jcfg)
        return (y * r).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    AP.close(chunks[0], jy, RTOL)
    AP.close(chunks[1], jaux, RTOL)
    for got, want in zip(chunks[2], [jgx] + [jgp[k] for k in sorted(jgp)]):
        AP.close(got, want, RTOL)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_decode_and_smoke_shapes_take_one_chunk(arch):
    """The full config's decode and serve calls (batch 8, one token) and
    the smoke config's train step keep every expert in one chunk, so their
    bits and launches are the unchunked ones."""
    for cfg, tokens in ((get_config(arch), 8),
                        (get_smoke(arch), SHAPE["global_batch"]
                         * SHAPE["seq_len"])):
        m = cfg.moe
        assert TMOE.expert_chunk(m.num_experts, tokens, cfg.d_model,
                                 m.d_expert, cfg.dtype.itemsize) \
            == m.num_experts


def test_routing_tape_replays_through_the_recompute(monkeypatch):
    """A tape recorded by the remat-free step and replayed by the remat
    step: the recompute takes the forward's experts from it without moving
    its cursor or counting a flip, and the step equals the recorded one
    bitwise."""
    cfg = get_smoke("moonshot-v1-16b-a3b")
    params = _weights(cfg, 2)
    batch = _batch(cfg, 4)
    tape = TMOE.RoutingTape()
    plain, _ = _step(cfg, params, batch, False, monkeypatch, tape)
    recorded = len(tape.recorded)
    assert recorded == cfg.n_layers
    remat, n = _step(cfg, params, batch, True, monkeypatch, tape.replay())
    assert n > _n_blocks(cfg)
    assert len(tape.recorded) == recorded and tape.cursor == recorded
    assert tape.decisions == recorded * SHAPE["global_batch"] \
        * SHAPE["seq_len"]
    assert int(tape.flips) == 0
    _assert_equal(remat, plain)


def test_dry_run_trace_shows_the_recompute():
    """The smoke qwen3-4b's train step at 4 layers over 2 x 512 positions
    traced on fake tensors: remat lowers the peak and adds the recomputed
    forward's operations."""
    cfg = dataclasses.replace(get_smoke("qwen3-4b"), n_layers=4)
    shape = dict(global_batch=2, seq_len=512, kind="train")
    got = {r: DRY.trace_step(dataclasses.replace(cfg, remat=r), "train_4k",
                             shape, None) for r in (False, True)}
    assert got[True]["memory"]["peak"] < 0.8 * got[False]["memory"]["peak"]
    assert got[True]["flops_per_device"] > 1.2 * got[False][
        "flops_per_device"]
    assert got[True]["memory"]["argument_size"] == \
        got[False]["memory"]["argument_size"]


def test_torch_func_path_runs_without_recompute():
    """Per-worker gradients through `vmap(grad)`: saved-tensor hooks are
    refused there, so a remat=True config's blocks and chunks run as they
    are, and its gradients equal the remat=False config's bitwise."""
    cfg = get_smoke("qwen3-4b")
    params, batch = _weights(cfg, 3), _batch(cfg, 6)
    got = [per_worker_grads(
        lambda p, b, c=dataclasses.replace(cfg, remat=r): TT.lm_loss(p, b, c),
        params, batch, 2) for r in (False, True)]
    for a, b in zip(tree_leaves(got[0]), tree_leaves(got[1])):
        assert torch.equal(a, b)

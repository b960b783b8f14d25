"""The RG-LRU block and recurrentgemma-9b on the port against the JAX
package, at the reference's smoke config (f32, 5 layers: one (rglru,
rglru, local_attn) super-block and two RG-LRU tail blocks, d 128, W 128,
4 heads of 32 against 1 KV head, local window 32).

`rglru_full` (the doubling scan) at S = 16, 48 and 21 (off a power of
two), `rglru_decode_step` over a run of tokens, its state written in
place; the tanh GELU the reference's `jax.nn.gelu` default computes; and
the whole model through tests/torch_arch_parity.py: the tree, loss and
gradient, prefill, teacher-forced decode past the 32-slot local ring
(and decode against the forward in each package), one FLOA train step
with replayed draws and the greedy serve.  Then long_500k: the state's
size does not grow with the length, and a step at pos 524 287 from
filled caches equals the JAX step's.  rtol 1e-5, decode 1e-4.
Everything runs on the CPU.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.models import rglru as JRGL
    from repro.models import transformer as JT

import torch_arch_parity as AP

from repro_torch.configs import get_config
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import rglru as TRGL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map

ARCH = "recurrentgemma-9b"


def _layer(n=0):
    """Super-block 0's first RG-LRU mixer (n = 0) or tail n - 1's, (JAX,
    port), the zero-initialised biases and the unit lam replaced by seeded
    values so that every term of the block is exercised."""
    jcfg, tcfg, jparams, _ = AP.setup(ARCH)
    src = (jparams["blocks"]["b0"]["mixer"] if n == 0
           else jparams[f"tail{n - 1}"]["b0"]["mixer"])
    jp = {k: np.array(v[0] if n == 0 else v) for k, v in src.items()}
    g = np.random.default_rng(n)
    for k in ("conv_b", "b_a", "b_i", "lam"):
        jp[k] = (0.5 * g.standard_normal(jp[k].shape)).astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.from_numpy(v) for k, v in jp.items()})


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_param_tree_paths_and_order_equal_jax():
    want = AP.check_tree(ARCH)
    sub = {p.split("/", 2)[-1] for p, _, _ in want if "/b0/" in p}
    assert {"mixer/in_x", "mixer/in_gate", "mixer/conv_w", "mixer/conv_b",
            "mixer/w_a", "mixer/b_a", "mixer/w_i", "mixer/b_i", "mixer/lam",
            "mixer/out", "ln2", "ffn/wi"} <= sub
    assert [p for p, _, _ in want if p.startswith("blocks/b2/attn")] == [
        "blocks/b2/attn/wk", "blocks/b2/attn/wo", "blocks/b2/attn/wq",
        "blocks/b2/attn/wv"]
    assert {p.split("/")[0] for p, _, _ in want} == {
        "blocks", "embed", "final_norm", "lm_head", "tail0", "tail1"}


def test_gelu_is_the_tanh_form():
    """`jax.nn.gelu`'s default is the tanh approximation (0.841192 at 1);
    the port's matches it within 1e-6 (the two evaluate the formula in
    different orders), where the exact form stands 1.5e-4 off."""
    x = np.linspace(-4, 4, 81, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    _, tcfg, _, tp = _layer(1)
    u = torch.from_numpy(_rng(3, 1, 4, tcfg.d_model))
    gate = TRGL._local(tp, u)[0]
    torch.testing.assert_close(gate, F.gelu(u @ tp["in_gate"],
                                            approximate="tanh"))


@pytest.mark.parametrize("slen", [16, 48, 21], ids=["pow2", "three-x-16",
                                                    "odd"])
def test_rglru_full_matches_jax(slen):
    jcfg, tcfg, jp, tp = _layer(1)
    u = _rng(slen, 2, slen, tcfg.d_model)
    AP.close(TRGL.rglru_full(tp, torch.from_numpy(u), tcfg),
             JRGL.rglru_full(jp, jnp.asarray(u), jcfg))


@pytest.mark.parametrize("slen", [1, 7, 33])
def test_scan_is_the_sequential_recurrence(slen):
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step,
    and its gradient through autograd against the loop's."""
    g = np.random.default_rng(slen)
    a0 = torch.from_numpy(g.uniform(0.2, 1.0, (2, slen, 5))).float()
    b0 = torch.from_numpy(g.standard_normal((2, slen, 5))).float()
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    got = TRGL.scan(a, b)
    h, want = torch.zeros(2, 5), []
    al, bl = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    for t in range(slen):
        h = al[:, t] * h + bl[:, t]
        want.append(h)
    want = torch.stack(want, dim=1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    w = torch.from_numpy(g.standard_normal((2, slen, 5))).float()
    # at S = 1 h_0 = b_0: a takes no part (the loop's gradient is 0)
    ga = torch.autograd.grad((got * w).sum(), (a, b), allow_unused=True)
    wa = torch.autograd.grad((want * w).sum(), (al, bl))
    for x, y in zip(ga, wa):
        x = torch.zeros_like(y) if x is None else x
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_rglru_decode_step_over_a_run_of_tokens():
    """12 steps from a zero state: each output and the final state (conv
    window and h) against the JAX step's; the port's state written in
    place, h in f32; then the steps against rglru_full on the same
    inputs."""
    jcfg, tcfg, jp, tp = _layer(0)
    jstate = JRGL.init_rglru_state(jcfg, 2, jnp.float32)
    tstate = TRGL.init_rglru_state(tcfg, 2, torch.float32)
    assert tstate["conv"].shape == (2, 3, 128)
    assert tstate["h"].dtype == torch.float32
    u = _rng(30, 2, 12, tcfg.d_model)
    outs = []
    for i in range(12):
        u1 = u[:, i:i + 1]
        jy, jstate = JRGL.rglru_decode_step(jp, jnp.asarray(u1), jstate,
                                            jcfg)
        ty, got = TRGL.rglru_decode_step(tp, torch.from_numpy(u1), tstate,
                                         tcfg)
        assert got is tstate
        AP.close(ty, jy, AP.DECODE_RTOL, err_msg=f"step {i}")
        outs.append(ty)
    for k in ("conv", "h"):
        AP.close(tstate[k], jstate[k], AP.DECODE_RTOL, err_msg=k)
    AP.close(torch.cat(outs, dim=1), TRGL.rglru_full(
        tp, torch.from_numpy(u), tcfg), AP.DECODE_RTOL)


def test_loss_and_gradients_match_jax():
    AP.check_loss_and_grads(ARCH, batch=2, seq=20, seed=3)


def test_prefill_matches_jax():
    AP.check_prefill(ARCH, batch=2, seq=40, seed=4)


def test_decode_matches_jax_and_the_forward_past_the_ring():
    """40 steps into the 32-slot local ring: the attention wraps at step
    32, the recurrent state keeps going."""
    AP.check_decode(ARCH, batch=2, steps=40, seed=5)


def test_floa_train_step_matches_jax():
    AP.check_train_step(ARCH, batch=2, seq=20, seed=6)


def test_greedy_serve_matches_jax_loop():
    """20 + 16 tokens: the generation runs past the 32-slot ring."""
    AP.check_serve(ARCH, batch=2, prompt_len=20, gen=16)


def test_long_500k_state_does_not_grow():
    """long_500k on the hybrid: no window override (the local rings hold
    cfg.local_window slots, the RG-LRU state is [B, W] a layer), so the
    full config's caches at 524 288 positions take the bytes they take at
    2048 (on "meta"); at smoke size a step at pos 524 287 from filled
    caches equals the JAX step at the same pos from the same caches."""
    full = get_config(ARCH)
    _, meta = TSTEPS.make_decode_step(full, "long_500k")
    assert meta["window"] is None

    def nbytes(n):
        c = TT.init_caches(full, 1, n, device="meta")
        return sum(x.numel() * x.element_size() for x in tree_leaves(c))

    assert nbytes(524288) == nbytes(2048) < nbytes(4096) + 1
    c = TT.init_caches(full, 1, 524288, device="meta")
    assert c["blocks"]["b2"]["k"].shape == (12, 1, 2048, 1, 256)
    assert c["blocks"]["b0"]["h"].shape == (12, 1, 4096)
    assert c["tail1"]["b0"]["conv"].shape == (1, 3, 4096)
    jcfg, tcfg, jparams, tparams = AP.setup(ARCH)
    step, _ = TSTEPS.make_decode_step(tcfg, "long_500k")
    tcaches = TT.init_caches(tcfg, 1, 524288, device="cpu")
    for i, x in enumerate(tree_leaves(tcaches)):
        x.copy_(torch.from_numpy(_rng(i, *x.shape)))
    jcaches = tree_map(lambda x: jnp.asarray(x.numpy().copy()), tcaches)
    got, _ = step(tparams, tcaches, torch.tensor([[3]]), 524287)
    want, _ = jax.jit(functools.partial(JT.decode_step, cfg=jcfg))(
        jparams, jcaches, jnp.asarray([[3]]), jnp.int32(524287))
    AP.close(got, want, AP.DECODE_RTOL)
    assert tcaches["blocks"]["b2"]["k"].shape[2] == tcfg.local_window == 32

"""The Mamba-2 SSD block and mamba2-1.3b on the port against the JAX
package, at the reference's smoke config (f32, 2 layers, d_inner 256, 8
heads of 32, d_state 16, chunk 16).

`ssd_full` (the chunked dual form) at one chunk, at several and at a
length off the chunk grid (the right-pad); `ssd_decode_step` (the
recurrent form) over a run of tokens, its state written in place; and the
whole model through tests/torch_arch_parity.py: the tree, loss and
gradient, prefill, teacher-forced decode (and the recurrent decode against
the chunked forward in each package: the duality itself), one FLOA train
step with replayed draws and the greedy serve.  Then the segments masked
before their exp, which keeps the gradient finite where the reference's
`where(tril, exp(seg), 0)` overflows, and long_500k's constant state.
rtol 1e-5, decode and the gradient 1e-4.  Everything runs on the CPU.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.models import ssm as JSSM

import torch_arch_parity as AP

from repro_torch.configs import get_config
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT

ARCH = "mamba2-1.3b"


def _layer(n=0):
    """Layer n's SSD mixer weights, (JAX, port), the zero-initialised
    A_log / D / dt_bias / norm / conv_b replaced by seeded values so that
    every term of the block is exercised."""
    jcfg, tcfg, jparams, _ = AP.setup(ARCH)
    jp = {k: np.array(v[n]) for k, v in
          jparams["blocks"]["b0"]["mixer"].items()}
    g = np.random.default_rng(n)
    for k in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        jp[k] = (0.3 * g.standard_normal(jp[k].shape)).astype(np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in jp.items()},
            {k: torch.from_numpy(v) for k, v in jp.items()})


def _rng(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_param_tree_paths_and_order_equal_jax():
    want = AP.check_tree(ARCH)
    assert {p.split("/", 2)[-1] for p, _, _ in want if "/b0/" in p} == {
        "ln1", "mixer/in_proj", "mixer/conv_w", "mixer/conv_b",
        "mixer/A_log", "mixer/D", "mixer/dt_bias", "mixer/norm",
        "mixer/out_proj"}


@pytest.mark.parametrize("slen", [16, 48, 21], ids=["one-chunk",
                                                     "three-chunks",
                                                     "padded"])
def test_ssd_full_matches_jax(slen):
    jcfg, tcfg, jp, tp = _layer(1)
    u = _rng(slen, 2, slen, tcfg.d_model)
    AP.close(TSSM.ssd_full(tp, torch.from_numpy(u), tcfg),
             JSSM.ssd_full(jp, jnp.asarray(u), jcfg))


def test_ssd_decode_step_over_a_run_of_tokens():
    """12 recurrent steps from a zero state: each output and the final
    state (conv window and ssm state) against the JAX step's; the port's
    state written in place."""
    jcfg, tcfg, jp, tp = _layer(0)
    jstate = JSSM.init_ssm_state(jcfg, 2, jnp.float32)
    tstate = TSSM.init_ssm_state(tcfg, 2, torch.float32)
    assert tstate["ssm"].dtype == torch.float32
    for i in range(12):
        u1 = _rng(30 + i, 2, 1, tcfg.d_model)
        jy, jstate = JSSM.ssd_decode_step(jp, jnp.asarray(u1), jstate, jcfg)
        ty, got = TSSM.ssd_decode_step(tp, torch.from_numpy(u1), tstate,
                                       tcfg)
        assert got is tstate
        AP.close(ty, jy, AP.DECODE_RTOL, err_msg=f"step {i}")
    for k in ("conv", "ssm"):
        AP.close(tstate[k], jstate[k], AP.DECODE_RTOL, err_msg=k)


def test_loss_and_gradients_match_jax():
    """The gradient at rtol 1e-4, as tests/test_torch_lm_model.py holds
    the GQA model's: through the cumsum / exp segments each f32 package is
    1e-5 to 1.8e-5 (relative to a leaf's largest entry) from a float64
    run of the port, so two f32 runs differ by up to twice that."""
    AP.check_loss_and_grads(ARCH, batch=2, seq=20, seed=3, grad_rtol=1e-4)


def test_prefill_matches_jax():
    AP.check_prefill(ARCH, batch=2, seq=40, seed=4)


def test_decode_matches_jax_and_the_forward():
    AP.check_decode(ARCH, batch=2, steps=20, seed=5)


def test_floa_train_step_matches_jax():
    AP.check_train_step(ARCH, batch=2, seq=20, seed=6)


def test_greedy_serve_matches_jax_loop():
    AP.check_serve(ARCH, batch=2, prompt_len=6, gen=6)


def test_masked_segments_keep_the_gradient_finite():
    """With A = -e^3 over a chunk of 16 the segments above the diagonal
    reach e^3 * 15 * dt, past f32's exp range: the reference's gradient of
    `where(tril, exp(seg), 0)` is NaN there (0 * inf), the port's, which
    masks before the exp, is finite; both forwards agree."""
    jcfg, tcfg, jp, tp = _layer(1)
    jp = dict(jp, A_log=jnp.full_like(jp["A_log"], 3.0),
              dt_bias=jnp.full_like(jp["dt_bias"], 5.0))
    tp = dict(tp, A_log=torch.full_like(tp["A_log"], 3.0),
              dt_bias=torch.full_like(tp["dt_bias"], 5.0))
    u = _rng(7, 1, 16, tcfg.d_model)
    # the reference's forward and gradient in one program
    jy, gj = jax.jit(lambda p: (
        JSSM.ssd_full(p, jnp.asarray(u), jcfg),
        jax.grad(lambda q: JSSM.ssd_full(q, jnp.asarray(u), jcfg).sum())(
            p)))(jp)
    AP.close(TSSM.ssd_full(tp, torch.from_numpy(u), tcfg), jy)
    assert np.isnan(np.asarray(gj["A_log"])).any()
    gt = torch.func.grad(lambda p: TSSM.ssd_full(p, torch.from_numpy(u),
                                                 tcfg).sum())(tp)
    assert all(torch.isfinite(g).all() for g in gt.values())


def test_long_500k_state_does_not_grow():
    """long_500k on the SSD model: no window, one [B, H, N, P] state a
    layer whatever the length (the full config on "meta": 48 x 2 MB in
    f32 at batch 1), and a step at pos 524 287 is the step at pos 40 from
    the same state, bit for bit (the recurrence ignores pos)."""
    full = get_config(ARCH)
    step, meta = TSTEPS.make_decode_step(full, "long_500k")
    assert meta["window"] is None
    c = TT.init_caches(full, 1, 524288, device="meta")["blocks"]["b0"]
    assert c["ssm"].shape == (48, 1, 64, 128, 64)
    assert c["conv"].shape == (48, 1, 3, 4096 + 256)
    _, tcfg, _, tparams = AP.setup(ARCH)
    step, _ = TSTEPS.make_decode_step(tcfg, "long_500k")
    runs = []
    for pos in (40, 524287):
        caches = TT.init_caches(tcfg, 1, 524288, device="cpu")
        for i, x in enumerate(caches["blocks"]["b0"].values()):
            x.copy_(torch.from_numpy(_rng(i, *x.shape)))
        runs.append((step(tparams, caches, torch.tensor([[3]]), pos)[0],
                     caches))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1]["blocks"]["b0"].values(),
                    runs[1][1]["blocks"]["b0"].values()):
        assert torch.equal(a, b)
    assert dataclasses.asdict(tcfg.ssm)["chunk"] == 16

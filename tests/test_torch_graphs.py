"""Compiled execution (`repro_torch.graphs`) on the CPU, and the train
step's seed on the device.

On the CPU a `StepGraph` runs its copy-in / call / copy-out path without a
capture, so everything but the capture itself is held here: the static
buffers against a direct call, the refusals, `disable_graphs()`, the
launch counts' bookkeeping (a capture's counts taken back and added at
every replay), the train step with a tensor seed bitwise the same seed as
an int, the gains' known answers through the plain Philox at purpose
GAINS and their Rayleigh law at the 1 % level over 2^20 draws, the plain
`noisy_sgd` with a key tensor bitwise the host key's bits, the sweep's
static-buffer loop against the JAX `SweepEngine` under replayed draws and
bitwise against the eager loop (seeded, resumed), and the serve and the
train loop graphed against eager.  `tests/test_torch_gpu.py` holds the
captured routes against eager on the card.
"""
import dataclasses
import math
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 -- one intra-op thread a test worker

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.fl as JFL
    from sweep_testlib import tiny_problem

from repro_torch import graphs
from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs import get_smoke
from repro_torch.fl import sweep as TS
from repro_torch.fl.plan import ExecutionPlan
from repro_torch.kernels import ops
from repro_torch.kernels import philox as P
from repro_torch.kernels.noisy_update import noisy_sgd_ref
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TTRAIN
from repro_torch.tree import tree_leaves
from test_torch_draws import KS_1PCT, Z_1PCT, _ks, _philox_py
from torch_parity import (assert_sweeps_match, jax_case, replay_sweep_draws,
                          tiny_torch_loss, torch_params)
from torch_parity import axis_grids as _grids

ROUNDS = 5
N_STATS = 2 ** 20
# a one-layer qwen3-shaped LM, a step of a few hundred ms on the CPU
TINY_LM = dataclasses.replace(get_smoke("qwen3-4b"), n_layers=1, d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                              vocab_size=256)


def _assert_equal(a, b) -> None:
    """Two trees (dicts, lists, tuples) of tensors equal bit for bit."""
    la, lb = [], []
    graphs._flatten(a, la)
    graphs._flatten(b, lb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ the helper

def _held_and_copied(w, x, cfg):
    """w is written in place (held), x copied in; cfg a baked constant."""
    y = {"sum": (w * x["a"]).sum() + cfg, "b": x["b"] * 2}
    w.add_(x["a"])
    return w, y


def _pure(x, n):
    return [x * n, (x.sum(), None)]


CASES = {
    "held_and_copied": (_held_and_copied, (0,), lambda t: (
        torch.zeros(3), {"a": torch.full((3,), float(t + 1)),
                         "b": torch.arange(t, t + 2.0)}, 0.5)),
    "copied_only": (_pure, (), lambda t: (torch.arange(4.0) + t, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_graph_plain_path_matches_a_direct_call(case):
    """Four calls through a StepGraph on the CPU give a direct call's
    values; a held argument is the buffer itself (written in place), a
    copied one is not; the outputs are static buffers the next call
    overwrites, except a held input passed through."""
    fn, static, args_at = CASES[case]
    g = graphs.StepGraph(fn, static=static)
    held = args_at(0)[0] if static else None
    want_w = None if held is None else held.clone()
    first = None
    for t in range(4):
        args = args_at(t)
        if static:
            args = (held,) + args[1:]
        direct_args = ((want_w,) + args_at(t)[1:]) if static else args_at(t)
        want = fn(*direct_args)
        got = g(*args)
        _assert_equal(got, want)
        if static:
            assert got[0] is held
        if first is None:
            first = got
        else:   # the same static outputs, overwritten
            la, lb = [], []
            graphs._flatten(first, la)
            graphs._flatten(got, lb)
            assert all(x is y for x, y in zip(la, lb))
    if not static:
        assert args_at(0)[0].data_ptr() != g._buffers[0].data_ptr()


@pytest.mark.parametrize("change", ["held_tensor", "structure", "constant",
                                    "shape"])
def test_step_graph_refuses_other_arguments(change):
    """A held argument passed as another tensor, another structure, another
    baked constant or another shape raises: the graph would replay the
    first call's."""
    g = graphs.StepGraph(_held_and_copied, static=(0,))
    w, x = torch.zeros(3), {"a": torch.ones(3), "b": torch.ones(2)}
    g(w, x, 0.5)
    bad = {"held_tensor": (torch.zeros(3), x, 0.5),
           "structure": (w, {"a": torch.ones(3)}, 0.5),
           "constant": (w, x, 0.25),
           "shape": (w, {"a": torch.ones(3), "b": torch.ones(5)}, 0.5)}
    with pytest.raises(ValueError, match="StepGraph"):
        g(*bad[change])


def test_disable_graphs_runs_the_function_on_the_callers_arguments():
    """Inside disable_graphs() a StepGraph calls its function on the
    caller's arguments (no buffers bound, the output its own), and the
    flag is restored after."""
    calls = []
    g = graphs.StepGraph(lambda x: calls.append(x) or x + 1)
    x = torch.ones(2)
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        first, second = g(x), g(x)
        assert torch.equal(first, x + 1) and first is not second
    assert graphs.graphs_enabled() and calls == [x, x] and not g._buffers
    assert calls[0] is x
    assert torch.equal(g(x), x + 1) and calls[2] is not x


def _fake_launch(name, shape, n=1):
    fn = ops.KERNELS[name]
    fn.launches += n
    if hasattr(fn, "shapes"):
        fn.shapes[shape] += n


def test_capture_counts_are_taken_back_and_added_per_replay():
    """The bookkeeping a capture uses: the wrappers' counts made during a
    capture are taken back, and each replay adds them again, so after
    one capture and N replays `launch_counts()` and `launch_shapes()`
    equal N eager calls' (here wrappers' counters bumped by hand: the CPU
    routes count nothing)."""
    def launches():
        _fake_launch("grad_stats", (40, 7))
        _fake_launch("floa_step_batched", (4, 10, 7))
        _fake_launch("noisy_sgd", None, 3)

    ops.reset_launches()
    try:
        for _ in range(3):
            launches()
        want = ops.launch_counts(), ops.launch_shapes()
        ops.reset_launches()
        before = graphs._snapshot()
        launches()                      # the capture
        delta = graphs._delta(before, graphs._snapshot())
        graphs._restore(before)
        assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
        for _ in range(3):              # the replays
            graphs._add(delta)
        assert (ops.launch_counts(), ops.launch_shapes()) == want
        # a StepGraph on the CPU counts what its calls count
        ops.reset_launches()
        g = graphs.StepGraph(lambda x: (launches(), x + 1)[1])
        for _ in range(3):
            g(torch.ones(1))
        assert (ops.launch_counts(), ops.launch_shapes()) == want
    finally:
        ops.reset_launches()


# ---------------------------------------------- the train step's seed

def _tiny_train(seed_of, steps=2, policy="bev"):
    """`steps` train steps of TINY_LM from one init, step t's seed
    seed_of(t): (params, state, [metrics])."""
    step, _ = ST.make_train_step(TINY_LM, None, dict(global_batch=4,
                                                     seq_len=8),
                                 alpha=0.05, policy=ST.Policy(policy))
    params = ST.init_model(TINY_LM, torch.Generator().manual_seed(3), "cpu")
    state = ST.init_floa_state("cpu")
    logs = []
    for t in range(steps):
        batch = TTRAIN.make_batch(TINY_LM, 4, 8, t, "cpu")
        params, state, m = step(params, state, batch, seed_of(t))
        logs.append({k: v.clone() for k, v in m.items()})
    return params, state, logs


SEEDS = [0, 5, 2 ** 40 + 3, 2 ** 64 - 1, -7]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint32])
def test_train_step_tensor_seed_equals_int_seed(dtype):
    """The step with its seed a one-element tensor (int64, int32, uint32,
    as the reference's jnp.uint32(t)) gives the params, stale stats and
    metrics of the same seed as an int, bit for bit; two seeds differ."""
    base = [7, 11]
    want = _tiny_train(lambda t: base[t])
    got = _tiny_train(lambda t: torch.tensor(base[t], dtype=dtype))
    _assert_equal(got, want)
    other = _tiny_train(lambda t: base[t] + 1)
    assert not torch.equal(tree_leaves(other[0])[0],
                           tree_leaves(want[0])[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_tensor_holds_the_int_keys_words(seed):
    """`philox.seed_tensor` of an int (taken modulo 2^64) has key_of's two
    words, as the kernel reads them from the int64 in memory."""
    t = P.seed_tensor(seed, "cpu")
    assert t.dtype == torch.int64 and t.dim() == 0
    words = t.reshape(1).view(torch.int32).tolist()   # little endian
    assert [w & P.MASK for w in words] == list(P.key_of(seed))
    assert tuple(int(k) for k in P.key_of(t)) == P.key_of(seed)


def test_compile_step_matches_the_eager_steps():
    """`launch.train.compile_step` on the CPU (the StepGraph's plain path:
    params and state written in place into the held buffers, a device
    counter as the seed) gives the eager steps' params, state and losses
    bit for bit."""
    want = _tiny_train(lambda t: t, steps=3)
    step, _ = ST.make_train_step(TINY_LM, None, dict(global_batch=4,
                                                     seq_len=8),
                                 alpha=0.05, policy=ST.Policy("bev"))
    graph = TTRAIN.compile_step(step)
    params = ST.init_model(TINY_LM, torch.Generator().manual_seed(3), "cpu")
    state = ST.init_floa_state("cpu")
    held = tree_leaves(params)
    seed = torch.zeros((), dtype=torch.int64)
    for t in range(3):
        batch = TTRAIN.make_batch(TINY_LM, 4, 8, t, "cpu")
        params, state, m = graph(params, state, batch, seed)
        seed += 1
        assert float(m["loss"]) == float(want[2][t]["loss"])
    assert all(a is b for a, b in zip(tree_leaves(params), held))
    _assert_equal((params, state), want[:2])


# ------------------------------------------------------------ the gains

@pytest.mark.parametrize("seed", SEEDS)
def test_gains_known_answers(seed):
    """Worker u's gain is sigma_u sqrt(-2 ln u) of the uniform of lane
    u % 4 of Philox4x32-10 at counter (u // 4, 0, leaf 0, GAINS) under the
    seed's key: the words from the plain-Python Philox, the law in numpy
    f32 (rtol 1e-6: libm's log against torch's); int and tensor seeds
    alike."""
    sig = torch.tensor([1.0, 0.5, 2.0, 3.0, 1.0, 0.25, 1.5])
    key = P.key_of(seed)
    want = []
    for u in range(len(sig)):
        x = _philox_py((u // 4, 0, 0, P.GAINS), key)[u % 4]
        uni = np.float32(((x >> 9) + 0.5) * 2.0 ** -23)
        want.append(np.float32(sig[u]) * np.sqrt(
            np.float32(2.0) * -np.log(uni, dtype=np.float32),
            dtype=np.float32))
    got = P.rayleigh_gains(seed, sig)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-6)
    assert torch.equal(P.rayleigh_gains(P.seed_tensor(seed, "cpu"), sig),
                       got)


def test_gains_rayleigh_law_at_1pct():
    """2^20 gains at sigma 1.5: |h|^2 / (2 sigma^2) ~ Exp(1), its mean
    within 2.576 / sqrt(n) of 1 and its KS distance under the 1 % point;
    another seed's gains differ."""
    sig = torch.full((N_STATS,), 1.5)
    h = P.rayleigh_gains(42, sig).double().numpy()
    e = h ** 2 / (2 * 1.5 ** 2)
    n = len(e)
    assert abs(e.mean() - 1.0) < Z_1PCT / math.sqrt(n)
    d = _ks(e, lambda x: 1.0 - np.exp(-x))
    assert d < KS_1PCT / math.sqrt(n), d
    assert not torch.equal(P.rayleigh_gains(43, sig[:64]),
                           torch.from_numpy(h[:64]).float())


# ------------------------------------------------- the update's key

@pytest.mark.parametrize("seed", SEEDS)
def test_noisy_sgd_key_tensor_equals_host_key(seed):
    """The plain noisy_sgd with the seed a tensor gives the update of the
    seed as an int (the host key's bits) bit for bit, on a whole
    leaf and on a misaligned part of one; its z against the plain-Python
    Philox's words."""
    gen = torch.Generator().manual_seed(1)
    full = (6, 10)
    parts = [P.Part.whole(full), P.Part(full, (2, 3), (3, 5))]
    for part in parts:
        p = torch.randn(part.shape, generator=gen).to(torch.bfloat16)
        g = torch.randn(part.shape, generator=gen).to(torch.bfloat16)
        shift = torch.tensor(0.01, dtype=torch.bfloat16)
        scale = torch.tensor(0.5)
        want = noisy_sgd_ref(p, g, shift, scale, 0.1,
                             draw=P.Draw(seed, 4, part))
        got = noisy_sgd_ref(p, g, shift, scale, 0.1,
                            draw=P.Draw(P.seed_tensor(seed, "cpu"), 4, part))
        assert torch.equal(got, want)
    x = _philox_py((0, 0, 4, P.NOISE), P.key_of(seed))
    assert P.bits_at(P.seed_tensor(seed, "cpu"), 4, P.NOISE,
                     torch.zeros(1, dtype=torch.int64))[0].item() == x[0]


# ------------------------------------------------------------ the sweep

SWEEP_GRIDS = ["markov", "mixed", "partial_digital"]


@pytest.mark.parametrize("grid", SWEEP_GRIDS)
def test_sweep_graph_loop_matches_jax_and_the_eager_loop(grid):
    """The sweep's rounds through its StepGraph (state and Markov h held
    and written in place, the batch row and the round's replayed draws
    copied in; Markov's first round eager): against the JAX SweepEngine
    under replayed draws (rtol 1e-5), and bitwise against the eager loop
    under disable_graphs()."""
    loss, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    tcases = _grids(dim)[grid]
    jspec = JFL.SweepSpec.build([jax_case(c) for c in tcases])
    want = JFL.SweepEngine(loss, jspec).run(jp, batches)

    def run():
        return TS.SweepEngine(tiny_torch_loss, TS.SweepSpec.build(tcases),
                              device="cpu").run(
            torch_params(jp), batches,
            draws=replay_sweep_draws(jspec, ROUNDS, dim))

    got = run()
    assert_sweeps_match(got, want)
    with graphs.disable_graphs():
        eager = run()
    assert np.array_equal(got.loss, eager.loss)
    assert np.array_equal(got.grad_norm, eager.grad_norm)
    _assert_equal(got.params, eager.params)


def test_sweep_graph_seeded_resume_matches_the_eager_loop(tmp_path):
    """The seeded draws inside the round's StepGraph (every lane's
    generators drawn by the body) on the mixed grid, chunked with a
    checkpoint a chunk: the result, and every checkpoint's carry (state,
    Markov h, the generators' states), bitwise the eager loop's; a run
    resumed from the graphed run's second checkpoint equals both."""
    _, jp, dim, batches = tiny_problem(rounds=ROUNDS)
    spec = TS.SweepSpec.build(_grids(dim)["mixed"])

    def run(where, resume=False):
        plan = ExecutionPlan(chunk_rounds=2, checkpoint_dir=str(where))
        return TS.SweepEngine(tiny_torch_loss, spec, plan=plan,
                              device="cpu").run(torch_params(jp), batches,
                                                resume=resume)

    got = run(tmp_path / "graphed")
    with graphs.disable_graphs():
        eager = run(tmp_path / "eager")
    assert np.array_equal(got.loss, eager.loss)
    _assert_equal(got.params, eager.params)
    for step in (2, 4):
        a, _ = CKPT.restore_pytree(str(tmp_path / "graphed"), step)
        b, _ = CKPT.restore_pytree(str(tmp_path / "eager"), step)
        _assert_equal(a["carry"], b["carry"])
    # resume the graphed run from its checkpoint at round 2
    shutil.copytree(tmp_path / "graphed", tmp_path / "resumed")
    for f in (tmp_path / "resumed").glob("ckpt_4*"):
        f.unlink()
    assert CKPT.latest_step(str(tmp_path / "resumed")) == 2
    resumed = run(tmp_path / "resumed", resume=True)
    assert np.array_equal(resumed.loss, got.loss)
    _assert_equal(resumed.params, got.params)


# ------------------------------------------------------------ the serve

def test_serve_graph_matches_eager():
    """`serve` on the CPU through the decode step's StepGraph (weights and
    caches held, the token and the position copied in, the logits cloned
    each step) gives the eager loop's tokens and logits bit for bit,
    sampled with a temperature."""
    cfg = get_smoke("qwen3-4b")
    got = TSERVE.serve(cfg, 2, 6, 5, device="cpu", temperature=0.8)
    with graphs.disable_graphs():
        want = TSERVE.serve(cfg, 2, 6, 5, device="cpu", temperature=0.8)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)
    # every step's logits are its own, not the last step's
    assert not torch.equal(got.logits[0], got.logits[-1])


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))

"""The port's counter-based draws (`repro_torch.kernels.philox`) on the CPU:
the stream's known answers and statistics, its independence of the
layout, the train step's update with its noise drawn by part, and
`init_shards` and the dry run without any whole-leaf draw.

The reference draws with partitionable threefry, whose bits the port
cannot reproduce; parity with the JAX package goes through replayed draws
(the other test files).  Here the port's own stream is held to Random123's
known answers for Philox4x32-10, to a plain-Python Philox past the
counter's low word, to the normal and truncated-normal laws at the 1 %
level over 2^20 draws with a fixed seed, and to itself: every part of a
leaf, drawn alone, equals the whole draw's slice bit for bit.
"""
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_parity  # noqa: F401 -- one intra-op thread a test worker

from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels import philox as P
from repro_torch.kernels.noisy_update import noisy_sgd_ref
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.tree import tree_leaves

N_STATS = 2 ** 20
# two-sided 1 % points: the normal's 2.576 and Kolmogorov's 1.628 / sqrt(n)
Z_1PCT, KS_1PCT = 2.576, 1.628
# the law of N(0, 1) truncated to [-2, 2]: its variance and fourth moment
_PHI2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
_MASS = math.erf(2 / math.sqrt(2))
TN_VAR = 1 - 2 * 2 * _PHI2 / _MASS
TN_M4 = 3 - 2 * (2 ** 3 + 3 * 2) * _PHI2 / _MASS


class Ax(NamedTuple):
    """A stand-in for a mesh axis: this rank's index and the axis size."""
    index: int
    size: int


def _philox_py(ctr, key):
    """Philox4x32-10 in plain Python integers (Random123's rounds)."""
    c, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & P.MASK, (k1 + 0xBB67AE85) & P.MASK
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & P.MASK, (p0 >> 32) ^ c[3] ^ k1,
             p0 & P.MASK]
    return c


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((P.MASK,) * 4, (P.MASK,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10, through the
    int64 arithmetic of the plain version, and the Python reference."""
    got = P.philox4x32(*[torch.tensor([c], dtype=torch.int64) for c in ctr],
                       *key)
    assert [int(x) for x in got] == list(want)
    assert _philox_py(ctr, key) == list(want)


def test_counters_past_the_low_word_match_python():
    """Counters whose q needs the high word (leaf sizes past 2^34, such as
    llama4's wg at 1.29e11 elements), under a seed whose key needs both
    words: every word equals the plain-Python Philox's."""
    seed = (7 << 40) + 12345
    q = torch.tensor([0, 1, 2 ** 32 - 1, 2 ** 32, 3 * 2 ** 32 + 5,
                      (1.29e11 // 4) - 1], dtype=torch.int64)
    got = torch.stack(P.bits_at(seed, 9, P.NOISE, q), dim=1)
    k = P.key_of(seed)
    for row, qi in zip(got.tolist(), q.tolist()):
        assert row == _philox_py((qi & P.MASK, qi >> 32, 9, P.NOISE), k)


def test_exponent_uniform_equals_the_stream_uniform_bitwise():
    """csrc/philox.cuh::uniform forms u = ((x >> 9) + 0.5) 2^-23 as (1 + m
    2^-23) - (1 - 2^-24), m = x >> 9 placed under the exponent of 1: over
    all 2^23 m, in numpy f32, bit for bit `philox.uniform`'s convert, add
    and scale (the subtraction is exact by Sterbenz's lemma)."""
    m = np.arange(2 ** 23, dtype=np.uint32)
    one_plus = (np.uint32(0x3F800000) + m).view(np.float32)
    got = one_plus - np.float32(1.0 - 2.0 ** -24)
    assert got.dtype == np.float32
    assert np.float32(1.0 - 2.0 ** -24).view(np.uint32) == 0x3F7FFFFF
    want = P.uniform(torch.from_numpy(m.astype(np.int64) << 9)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() > 0 and got.max() < 1


def _ks(x: np.ndarray, cdf) -> float:
    x = np.sort(x.astype(np.float64))
    f = cdf(x)
    i = np.arange(1, len(x) + 1) / len(x)
    return float(max((i - f).max(), (f - (i - 1 / len(x))).max()))


def test_normals_mean_variance_and_ks_at_1pct():
    """2^20 normals of one leaf (seed 0): the mean within 2.576 / sqrt(n)
    of 0, the variance within 2.576 sqrt(2 / n) of 1, the KS distance to
    Phi under the 1 % point 1.628 / sqrt(n); two leaves' draws differ."""
    z = P.normal(P.Draw(0, 0, P.Part.whole((N_STATS,))), "cpu").numpy()
    n = len(z)
    assert abs(z.mean()) < Z_1PCT / math.sqrt(n)
    assert abs(z.var() - 1.0) < Z_1PCT * math.sqrt(2.0 / n)
    erf = np.vectorize(math.erf)
    d = _ks(z, lambda x: 0.5 * (1 + erf(x / math.sqrt(2))))
    assert d < KS_1PCT / math.sqrt(n), d
    other = P.normal(P.Draw(0, 1, P.Part.whole((64,))), "cpu").numpy()
    assert not np.array_equal(other, z[:64])


def test_trunc_normal_support_and_moments():
    """2^20 init draws (scale 1, f32): all in [-2, 2], the mean and the
    variance of N(0, 1) truncated to [-2, 2] within their 1 % points, and
    the bf16 fill the f32 fill rounded; the scale multiplies in f32."""
    part = P.Part.whole((N_STATS,))
    x = P.fill_trunc_normal_ref(torch.empty(N_STATS), 3, 2, part, 1.0)
    assert float(x.min()) >= -2.0 and float(x.max()) <= 2.0
    xs = x.double().numpy()
    n = len(xs)
    assert abs(xs.mean()) < Z_1PCT * math.sqrt(TN_VAR / n)
    assert abs(xs.var() - TN_VAR) < Z_1PCT * math.sqrt(
        (TN_M4 - TN_VAR ** 2) / n)
    bf = P.fill_trunc_normal_ref(torch.empty(N_STATS, dtype=torch.bfloat16),
                                 3, 2, part, 0.125)
    assert torch.equal(bf, (x * 0.125).to(torch.bfloat16))


# (M, R): the "model" and "data" sizes a leaf is split over
LAYOUTS = [(2, 1), (1, 2), (2, 2), (4, 4)]
# (whole shape, "model" dim, "data" dim): a stacked leaf whose split rows
# are misaligned with the counter's groups of 4 (20 / 4 = 5), and a matrix
LEAVES = [((3, 8, 20), 2, 1), ((16, 12), 0, 1)]


@pytest.mark.parametrize("m, r", LAYOUTS)
def test_every_part_equals_the_whole_draws_slice(m, r):
    """Each rank's part of a leaf at (M, R), drawn alone: its noise, its
    init fill and its noisy update equal the whole leaf's slice bit for
    bit (the plain route; any chunk)."""
    for full, dm, dd in LEAVES:
        whole = P.Part.whole(full)
        z = P.normal(P.Draw(11, 4, whole), "cpu")
        w = P.fill_trunc_normal_ref(torch.empty(full, dtype=torch.bfloat16),
                                    11, 4, whole, 0.3)
        gen = torch.Generator().manual_seed(0)
        p = torch.randn(full, generator=gen).to(torch.bfloat16)
        g = torch.randn(full, generator=gen).to(torch.bfloat16)
        shift = torch.tensor(0.01, dtype=torch.bfloat16)
        scale = torch.tensor(0.5)
        upd = noisy_sgd_ref(p, g, shift, scale, 0.1,
                            draw=P.Draw(11, 4, whole))
        for mi in range(m):
            for ri in range(r):
                part = P.split_part(full, ((dm, Ax(mi, m)), (dd, Ax(ri, r))))
                sl = part.slices
                assert torch.equal(P.normal(P.Draw(11, 4, part), "cpu",
                                            chunk=7), z[sl])
                got = P.fill_trunc_normal_ref(
                    torch.empty(part.shape, dtype=torch.bfloat16), 11, 4,
                    part, 0.3, chunk=5)
                assert torch.equal(got, w[sl])
                got = noisy_sgd_ref(p[sl].contiguous(), g[sl].contiguous(),
                                    shift, scale, 0.1,
                                    draw=P.Draw(11, 4, part), chunk=9)
                assert torch.equal(got, upd[sl])


def test_a_part_of_a_llama4_wg_leaf_past_2_32():
    """A part of a leaf of llama4's wg shape [24, 128, 5120, 8192] (1.29e11
    elements) near its end, indices past 2^32: its normals and its init
    fill equal the formula at the global indices computed by hand."""
    full = (24, 128, 5120, 8192)
    part = P.Part(full, (23, 100, 5000, 8000), (1, 2, 3, 37))
    strides = [128 * 5120 * 8192, 5120 * 8192, 8192, 1]
    j = torch.tensor([sum((o + i) * s for o, i, s in zip(
        part.offset, idx, strides)) for idx in np.ndindex(*part.shape)],
        dtype=torch.int64)
    assert int(j.min()) > 2 ** 36
    assert torch.equal(P.part_indices(part, 0, part.numel, "cpu"), j)
    seed = 2 ** 40 + 3
    got = P.normal(P.Draw(seed, 17, part), "cpu").reshape(-1)
    assert torch.equal(got, P.normal_at(seed, 17, j))
    fill = P.fill_trunc_normal_ref(torch.empty(part.shape), seed, 17, part,
                                   1.0).reshape(-1)
    assert torch.equal(fill, P.trunc_normal_at(seed, 17, j))
    # lane 0 of each group is Box-Muller's cosine of the counter's words
    q = j[j % 4 == 0] >> 2
    x = P.bits_at(seed, 17, P.NOISE, q)
    ua, ub = P.uniform(x[0]), P.uniform(x[1])
    cos = torch.sqrt(-2.0 * torch.log(ua)) * torch.cos(P.TWO_PI * ub)
    assert torch.equal(got[j % 4 == 0], cos)
    words = [_philox_py((qi & P.MASK, qi >> 32, 17, P.NOISE),
                        P.key_of(seed)) for qi in q.tolist()]
    assert torch.stack(x, 1).tolist() == words


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_noise_equals_the_whole_draw_given(dtype, monkeypatch):
    """The train step's update (`steps._noisy_sgd`) with the stream's noise
    equals the same update given the stream's whole draw as z, bit for
    bit, in f32 and bf16, at odd chunk sizes (UPDATE_CHUNK patched) and in
    one pass."""
    shape = (5, 7, 9)
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(shape, generator=gen).to(dtype)
    g = (torch.randn(shape, generator=gen) * 1e-2).to(dtype)
    shift = torch.tensor(-3e-3, dtype=dtype)
    scale = torch.tensor(0.25)
    draw = P.Draw(-5, 6, P.Part.whole(shape))
    z = P.normal(draw, "cpu")
    outs = []
    for chunk in (1, 7, 4097, 2 ** 26):
        monkeypatch.setattr(ST, "UPDATE_CHUNK", chunk)
        outs.append(ST._noisy_sgd(p, g, shift, scale, 0.02, draw=draw))
        assert torch.equal(outs[-1], ST._noisy_sgd(p, g, shift, scale, 0.02,
                                                   z=z))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert not torch.equal(outs[0], ST._noisy_sgd(p, g, shift, scale, 0.02))
    assert ops.launch_counts()["noisy_sgd"] == 0   # the CPU: plain route


class _Largest(CA.CostMode):
    """CostMode that also keeps the largest storage made while active."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def _hold(self, t):
        added = super()._hold(t)
        self.largest = max(self.largest, added)
        return added


def test_init_shards_draws_only_the_ranks_parts(monkeypatch):
    """deepseek-v2-236b at full width cut to 2 layers, rank 0 of the 256
    of the production "single" mesh (a fake group), fake tensors: the
    shards equal the parts `ParamInit` is asked for, and while drawing the
    init holds no storage larger than its largest part or one chunk of
    the plain draw's int64 indices, and at most its parts plus one chunk
    of transients (the largest whole leaf, 2.5 GB of bf16, never)."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2)
    monkeypatch.setattr(P, "stream_seed", lambda generator: 99)
    monkeypatch.setattr(P, "DRAW_CHUNK", 2 ** 20)
    with DRY.fake_group(256):
        mesh = make_production_mesh()
        whole = SH.init_params(cfg, None, "meta")
        shapes = [tuple(x.shape) for x in tree_leaves(
            SH.init_shards(cfg, None, "meta", mesh))]
        with FakeTensorMode():
            cost = _Largest()
            with cost:
                local = SH.init_shards(cfg, torch.Generator(), "cpu", mesh)
    parts = [x.numel() * x.element_size() for x in tree_leaves(local)]
    assert [tuple(x.shape) for x in tree_leaves(local)] == shapes
    biggest = max(x.numel() * x.element_size() for x in tree_leaves(whole))
    chunk = P.DRAW_CHUNK * 8
    assert cost.largest <= max(max(parts), chunk)
    assert cost.peak <= sum(parts) + 16 * chunk
    assert 16 * chunk + max(parts) < biggest / 10


def test_init_shards_equals_the_sliced_whole_init():
    """On a fake (2, 2) group, rank 0's shards of the smoke qwen3-4b with
    FSDP over "data" at a lowered size equal `shard_params` of the whole
    init bit for bit, and successive inits from one generator differ."""
    cfg = get_smoke("qwen3-4b")
    old = SH.FSDP_MIN_SIZE
    SH.FSDP_MIN_SIZE = 2048
    try:
        with DRY.fake_group(4):
            mesh = make_debug_mesh((2, 2), ("data", "model"))
            gen = torch.Generator().manual_seed(4)
            local = SH.init_shards(cfg, gen, "cpu", mesh)
            again = SH.init_shards(cfg, gen, "cpu", mesh)
            sliced = SH.shard_params(
                SH.init_params(cfg, torch.Generator().manual_seed(4), "cpu"),
                SH.param_specs(cfg, 2), mesh, SH.data_specs(cfg, 2, 2))
    finally:
        SH.FSDP_MIN_SIZE = old
    split = [a.shape != b.shape for a, b in zip(
        tree_leaves(local), tree_leaves(SH.init_params(cfg, None, "meta")))]
    assert sum(split) >= 5
    for a, b in zip(tree_leaves(local), tree_leaves(sliced)):
        assert torch.equal(a, b)
    assert not torch.equal(tree_leaves(local)[-1], tree_leaves(again)[-1])


def test_dry_run_deepseek_train_4k_below_its_full_shape_noise():
    """deepseek-v2-236b at full width cut to 8 layers, train_4k on the
    production "single" mesh (rank 0 of a fake group of 256), the card's
    route: the step's peak lies below its largest leaf's noise drawn at
    full shape in f32, which the step formed before the update drew by
    part; the update is the kernel's op, once a leaf."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=8)
    full = SH.init_params(cfg, None, "meta")
    noise = max(x.numel() for x in tree_leaves(full)) * 4
    calls = []
    real = DRY.NU.card_route

    def counted(*a, **k):
        calls.append(k.get("draw"))
        return real(*a, **k)

    with DRY.fake_group(256):
        mesh = make_production_mesh()
        DRY.NU.card_route = counted
        try:
            got = DRY.trace_step(cfg, "train_4k", INPUT_SHAPES["train_4k"],
                                 mesh)
        finally:
            DRY.NU.card_route = real
    assert got["memory"]["peak"] < noise, (got["memory"]["peak"], noise)
    assert len(calls) == len(tree_leaves(full))
    assert all(d is not None and d.leaf == i for i, d in enumerate(calls))

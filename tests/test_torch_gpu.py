"""The port's CUDA kernels on a card, against their plain PyTorch versions.

CUDA kernels have no CPU mode, so every test here carries the `gpu` marker
and skips without a card.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import figures as TF
from repro_torch.configs import PAPER_MLP
from repro_torch.core import defenses
from repro_torch.core.attacks import AttackType
from repro_torch.core.power_control import Policy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import _build, defense_sort, ops, ref

# tests/test_kernels.py: combine 1e-5 (f32) / 0.15 (bf16); stats 1e-4/1e-3.
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.15}
ROUNDS = 5
SMOKE = dataclasses.replace(PAPER_MLP.smoke(), d_hidden=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def _inputs(dev, seed, s, u, d, dtype):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    return (f(s, d).to(dev, dtype), f(s, u).to(dev), f(s, u, d).to(dev, dtype),
            f(s, d).to(dev, dtype), f(s).to(dev), f(s).to(dev),
            (torch.rand(s, generator=gen) * 0.2).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("s,u,d", [(4, 10, 50890), (1, 4, 512),
                                   (3, 32, 5000), (2, 8, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, s, u, d, dtype):
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, d, s, u, d, dtype)
    tol = TOL[dtype]
    ops.reset_launches()
    args = (w, c, g, z, bias, eps, alpha)
    for k, p in zip(ops.floa_step_batched(*args),
                    ops.floa_step_batched(*args, plain=True)):
        _close(k, p, tol)
    _close(ops.floa_aggregate_batched(c, g, z, bias, eps),
           ref.floa_aggregate_batched_ref(c, g, z, bias, eps), tol)
    _close(ops.floa_aggregate(c[0], g[0], z[0], bias[0], eps[0]),
           ref.floa_aggregate_ref(c[0], g[0], z[0], bias[0], eps[0]), tol)
    rows = g.reshape(s * u, d)
    np.testing.assert_allclose(ops.grad_stats(rows).cpu().numpy(),
                               ref.grad_stats_ref(rows).cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts == {k: int(k in ("floa_step_batched",
                                   "floa_aggregate_batched",
                                   "floa_aggregate", "grad_stats"))
                      for k in ops.KERNELS}


@pytest.mark.gpu
def test_cuda_wrappers_reject_mixed_devices(cuda_device):
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, 0, 2, 3, 64,
                                           torch.float32)
    with pytest.raises(ValueError, match="on cpu"):
        ops.floa_step_batched(w, c.cpu(), g, z, bias, eps, alpha)


LANES = {
    "fig1": [TF.Experiment(n, p, rounds=ROUNDS)
             for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                          ("BEV", Policy.BEV)]],
    "fig3": [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                           attacker_sigma=3.0, rounds=ROUNDS)
             for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                               ("BEV", Policy.BEV)]],
    "gaussian": [TF.Experiment("BEV-gauss", Policy.BEV, n_attackers=2,
                               attack=AttackType.GAUSSIAN, rounds=ROUNDS),
                 TF.Experiment("CI-strong", Policy.CI, n_attackers=1,
                               rounds=ROUNDS)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("fig", sorted(LANES))
def test_kernel_route_matches_plain_route(cuda_device, fig):
    """One sweep through the kernels and again through their plain
    versions, from the same seeded draws; each round launches the path's
    kernels once."""
    exps = LANES[fig]
    ops.reset_launches()
    rk = TF.run_figure(exps, eval_every=2, mc=SMOKE, device=cuda_device)
    counts = ops.launch_counts()
    rp = TF.run_figure(exps, eval_every=2, mc=SMOKE, device=cuda_device,
                       force_plain=True)
    assert ops.launch_counts() == counts
    fused = fig != "gaussian"
    assert counts["grad_stats"] == ROUNDS
    assert counts["floa_step_batched"] == (ROUNDS if fused else 0)
    assert counts["floa_aggregate_batched"] == (0 if fused else ROUNDS)
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    for k in rk.params:
        torch.testing.assert_close(rk.params[k], rp.params[k], rtol=1e-4,
                                   atol=1e-6)


def _normal(dev, seed, *shape, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev, dtype)


def _sorts_exactly(kernel, x):
    """The kernel's output equals the plain sort bit for bit (finite
    inputs), on the [S, U, D] form and, for one lane, the [U, D] form."""
    got = kernel(x)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, ref.sort_columns_batched_ref(x))
    assert torch.equal(kernel(x[0]), ref.sort_columns_ref(x[0]))


# The redesigned FLOA combine and grad_stats: every plan, alignment and
# main-path shape against the plain versions.  The f32 combine's atol grows
# with U beyond 10 workers, as in chip_smoke.py: the plain version (cuBLAS)
# sums the U unit-size terms in another order, and the rounding of such a
# running sum grows about linearly in U.
def _combine_tol(dtype, u):
    return 1e-5 * max(1.0, u / 10) if dtype == torch.float32 else TOL[dtype]


STATS_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def _offset_view(dev, seed, shape, offset, dtype):
    """A contiguous view of `shape` at storage offset `offset` (its base
    `offset` elements past an allocation's aligned start)."""
    n = int(np.prod(shape))
    return _normal(dev, seed, n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("s,u,d", [(1, 10, 50890), (1, 1000, 50890),
                                   (3, 10, 50890), (1, 1, 4097),
                                   (2, 7, 4093), (1, 33, 4094),
                                   (3, 5, 4095), (1, 3, 1), (1, 1000, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_matches_plain_at_main_and_ragged_shapes(cuda_device, s, u,
                                                         d, dtype):
    """The fused step, the combine and the S = 1 entry point against their
    plain versions: the main path's S = 1 lanes (U = 10, 1000), D off every
    vector grid (D % 4 in {1, 2, 3}, D = 1) and U = 1."""
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, d + u, s, u, d, dtype)
    tol = _combine_tol(dtype, u)
    args = (w, c, g, z, bias, eps, alpha)
    for k, p in zip(ops.floa_step_batched(*args),
                    ops.floa_step_batched(*args, plain=True)):
        _close(k, p, tol)
    _close(ops.floa_aggregate_batched(c, g, z, bias, eps),
           ref.floa_aggregate_batched_ref(c, g, z, bias, eps), tol)
    _close(ops.floa_aggregate(c[0], g[0], z[0], bias[0], eps[0]),
           ref.floa_aggregate_ref(c[0], g[0], z[0], bias[0], eps[0]), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4096, 50890])
def test_combine_at_a_misaligned_base(cuda_device, dtype, d):
    """G, noise and w as contiguous views at storage offset 1: the plan
    narrows its vectors to what the pointers allow, and the results hold."""
    s, u = 1, 10
    w, c, _, _, bias, eps, alpha = _inputs(cuda_device, 7, s, u, d, dtype)
    g = _offset_view(cuda_device, 8, (s, u, d), 1, dtype)
    z = _offset_view(cuda_device, 9, (s, d), 1, dtype)
    w = _offset_view(cuda_device, 10, (s, d), 1, dtype)
    from repro_torch.kernels import floa_aggregate as FA
    align = FA._align(g.data_ptr(), z.data_ptr(), w.data_ptr())
    vec, _ = FA._plan(cuda_device.index, s, u, d, dtype, dtype, align)
    assert vec * g.element_size() <= align
    tol = _combine_tol(dtype, u)
    for k, p in zip(ops.floa_step_batched(w, c, g, z, bias, eps, alpha),
                    ref.floa_step_batched_ref(w, c, g, z, bias, eps, alpha)):
        _close(k, p, tol)
    _close(ops.floa_aggregate(c[0], g[0], z[0], bias[0], eps[0]),
           ref.floa_aggregate_ref(c[0], g[0], z[0], bias[0], eps[0]), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("s,u,d", [(1, 10, 50890), (1, 1000, 50890),
                                   (4, 10, 50890), (2, 33, 4097)])
def test_combine_is_deterministic_and_graph_replays_it(cuda_device, s, u, d):
    """Two calls give the same bits, and so does a CUDA-graph replay of
    the call (the plan, and with it every sum's order, is fixed)."""
    args = _inputs(cuda_device, 3, s, u, d, torch.float32)
    first = ops.floa_step_batched(*args)
    again = ops.floa_step_batched(*args)
    agg = ops.floa_aggregate_batched(*args[1:6])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.floa_step_batched(*args)
        replayed_agg = ops.floa_aggregate_batched(*args[1:6])
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, replayed))
    assert torch.equal(agg, replayed_agg)


@pytest.mark.gpu
@pytest.mark.parametrize("vec,ku", [(1, 1), (2, 1), (1, 2), (2, 4),
                                    (2, 8), (1, 8)])
def test_combine_every_plan_matches_plain(cuda_device, vec, ku):
    """Each (V, KU) the kernel takes, through its C entry point, at the
    S = 1, U = 10 main-path shape."""
    s, u, d = 1, 10, 50890
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, 4, s, u, d,
                                           torch.float32)
    w_out, g_out = torch.empty_like(w), torch.empty_like(z)
    lib = _build.library("floa_aggregate")
    assert lib.floa_step_batched(
        w.data_ptr(), c.data_ptr(), g.data_ptr(), z.data_ptr(),
        bias.data_ptr(), eps.data_ptr(), alpha.data_ptr(), w_out.data_ptr(),
        g_out.data_ptr(), s, u, d, 0, 0, vec, ku,
        torch.cuda.current_stream(cuda_device).cuda_stream) == 0
    want_w, want_g = ref.floa_step_batched_ref(w, c, g, z, bias, eps, alpha)
    _close(w_out, want_w, TOL[torch.float32])
    _close(g_out, want_g, TOL[torch.float32])


@pytest.mark.gpu
def test_combine_entry_refuses_a_plan_the_shape_does_not_allow(cuda_device):
    """V must divide D and fit every pointer; KU must be 1, 2, 4 or 8."""
    s, u, d = 1, 10, 50890
    _, c, g, z, bias, eps, _ = _inputs(cuda_device, 5, s, u, d,
                                       torch.float32)
    out = torch.empty_like(z)
    lib = _build.library("floa_aggregate")
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    g_odd = _offset_view(cuda_device, 6, (s, u, d), 1, torch.float32)

    def launch(grads, vec, ku):
        return lib.floa_aggregate_batched(
            c.data_ptr(), grads.data_ptr(), z.data_ptr(), bias.data_ptr(),
            eps.data_ptr(), out.data_ptr(), s, u, d, 0, vec, ku, stream)
    assert launch(g, 2, 1) == 0
    assert launch(g, 4, 1) != 0          # 4 does not divide 50 890
    assert launch(g_odd, 2, 1) != 0      # a 4-byte-aligned base
    assert launch(g, 2, 3) != 0
    assert launch(g, 16, 1) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("r,d", [(10, 50890), (40, 50890), (1000, 50890),
                                 (7, 4097), (3, 4093), (5, 4094), (2, 4095),
                                 (4, 1), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_grad_stats_matches_plain_at_any_alignment(cuda_device, r, d, dtype,
                                                   offset):
    """Rows at the main path's counts (10, 40, 1000), D off the vector grid
    and D = 1, from an aligned base and from a view at storage offset 1:
    each row peels its own head and tail."""
    rows = _offset_view(cuda_device, r + d, (r, d), offset, dtype)
    rtol, atol = STATS_TOL[dtype]
    np.testing.assert_allclose(ops.grad_stats(rows).cpu().numpy(),
                               ref.grad_stats_ref(rows).cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [10, 40, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_stats_is_deterministic_and_graph_replays_it(cuda_device, r,
                                                          dtype):
    rows = _normal(cuda_device, 11, r, 50890, dtype=dtype)
    first, again = ops.grad_stats(rows), ops.grad_stats(rows)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.grad_stats(rows)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, replayed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_stats_splits_rows_over_a_cluster(cuda_device, dtype):
    """At the defense grid's 10 rows the plan splits each row over C > 1
    blocks of a cluster; every C the card runs gives the plain sums, and a
    C the kernel does not take is refused."""
    from repro_torch.kernels import grad_stats as GS
    r, d = 10, 50890
    rows = _offset_view(cuda_device, 12, (r, d), 1, dtype)
    code = _build.DTYPE_CODES[dtype]
    assert GS._plan(cuda_device.index, r, d, dtype) > 1
    lib = _build.library("grad_stats")
    max_c = lib.grad_stats_max_cluster(code)
    assert max_c >= 8                     # portable cluster sizes on sm_90
    rtol, atol = STATS_TOL[dtype]
    want = ref.grad_stats_ref(rows).cpu().numpy()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for c in [c for c in GS.CLUSTER_SIZES if c <= max_c]:
        out = torch.empty((r, 2), device=cuda_device)
        assert lib.grad_stats(rows.data_ptr(), out.data_ptr(), r, d, code, c,
                              stream) == 0
        np.testing.assert_allclose(out.cpu().numpy(), want, rtol=rtol,
                                   atol=atol)
    out = torch.empty((r, 2), device=cuda_device)
    assert lib.grad_stats(rows.data_ptr(), out.data_ptr(), r, d, code, 3,
                          stream) != 0


@pytest.mark.gpu
def test_main_path_counts_launches_by_shape(cuda_device):
    """The FLOA wrappers count launches by (S, U, D), grad_stats by
    (R, D), its fixed-order route by (R, leaf sizes) (`grad_stats_fixed`
    as the one-segment case), the sorts by input shape, decode attention
    by (B, S, H, KV, dh); `reset_launches` clears them."""
    ops.reset_launches()
    args = _inputs(cuda_device, 13, 2, 3, 64, torch.float32)
    kv = torch.zeros(2, 16, 2, 32, device=cuda_device)
    ops.decode_attention(torch.zeros(2, 4, 32, device=cuda_device), kv, kv, 5)
    ops.floa_step_batched(*args)
    ops.floa_step_batched(*args)
    ops.grad_stats(args[2].reshape(6, 64))
    ops.grad_stats_fixed(args[2].reshape(6, 64)[:, 10:30])
    ops.grad_stats_segments(args[2].reshape(6, 64), (10, 20, 34))
    ops.sort_columns(args[2])
    ops.sort_columns(args[2][0])
    ops.sort_columns_bitonic(torch.zeros(40, 8, device=cuda_device))
    assert ops.launch_shapes() == {
        "floa_step_batched": {(2, 3, 64): 2}, "floa_aggregate_batched": {},
        "floa_aggregate": {}, "grad_stats": {(6, 64): 1},
        # two kernel launches a call (the parts and the fold kernel)
        "grad_stats_segments": {(6, (20,)): 2, (6, (10, 20, 34)): 2},
        "sort_columns": {(2, 3, 64): 1, (3, 64): 1},
        "sort_columns_bitonic": {(40, 8): 1},
        "decode_attention": {(2, 16, 4, 2, 32): 1}}
    ops.reset_launches()
    assert not any(ops.launch_shapes().values())


# tests/test_defense_sort.py's grids
@pytest.mark.gpu
@pytest.mark.parametrize("u", [1, 2, 7, 10, 16, 32])
@pytest.mark.parametrize("d", [128, 2048, 2049, 5000])
@pytest.mark.parametrize("s", [1, 3])
def test_sort_columns_equals_sort(cuda_device, s, u, d):
    ops.reset_launches()
    _sorts_exactly(ops.sort_columns, _normal(cuda_device, u * d + s, s, u, d))
    assert ops.launch_counts()["sort_columns"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("u", [33, 100, 1000, 4097,
                               defense_sort.BITONIC_MAX_U])
@pytest.mark.parametrize("d", [1, 130, 515])
def test_sort_columns_bitonic_equals_sort(cuda_device, u, d):
    ops.reset_launches()
    _sorts_exactly(ops.sort_columns_bitonic,
                   _normal(cuda_device, u * 1000 + d, 2, u, d))
    assert ops.launch_counts()["sort_columns_bitonic"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sort_columns", "sort_columns_bitonic"])
def test_sorts_bf16_duplicates_presorted(cuda_device, kernel):
    """bf16 sorts in f32 and casts back exactly; ties and already-sorted
    columns are fixed points of both networks."""
    fn = ops.KERNELS[kernel]
    u = 10 if kernel == "sort_columns" else 100
    _sorts_exactly(fn, _normal(cuda_device, 0, 2, u, 640,
                               dtype=torch.bfloat16))
    col = torch.tensor([2.0, 2.0, -1.0, 2.0] * (u // 4) + [0.5] * (u % 4))
    dup = col[None, :, None].expand(1, u, 257).contiguous().to(cuda_device)
    _sorts_exactly(fn, dup)
    srt = ref.sort_columns_batched_ref(_normal(cuda_device, 3, 1, u, 384))
    assert torch.equal(fn(srt), srt)


# U around each path boundary of the bitonic kernel: 64 (the smallest pad,
# two threads a column), 1024 (a warp a column, the last U_pad whose
# windows need no __syncthreads), 2048 (two warps a column); D off every
# column tile (128 / 8 / 4 columns a block there).
@pytest.mark.gpu
@pytest.mark.parametrize("u", [63, 64, 65, 1023, 1024, 1025, 2047, 2048,
                               2049])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sort_columns_bitonic_path_boundaries(cuda_device, u, dtype):
    """Random columns with +-inf and ties, and already-sorted columns, at
    each boundary of the register / warp / block paths: equal to
    torch.sort bit for bit."""
    x = _normal(cuda_device, u, 2, u, 129, dtype=dtype)
    x[0, : u // 3, ::3] = float("inf")
    x[1, u // 2:, 1::4] = -float("inf")
    x[:, ::5, 2::5] = 0.25
    x[:, :, 7] = 1.0
    ops.reset_launches()
    _sorts_exactly(ops.sort_columns_bitonic, x)
    srt = ref.sort_columns_batched_ref(x)
    assert torch.equal(ops.sort_columns_bitonic(srt), srt)
    assert ops.launch_counts()["sort_columns_bitonic"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("log_u_pad", range(6, 14))
def test_bitonic_plan_is_the_compiled_one(cuda_device, log_u_pad):
    """The launch takes its columns and shared memory from `bitonic_plan`;
    the kernel's entry point accepts that plan for its U_pad and refuses
    any other."""
    u = 1 << log_u_pad
    x = _normal(cuda_device, u, 1, u, 37)
    _sorts_exactly(ops.sort_columns_bitonic, x)
    plan = defense_sort.bitonic_plan(u)
    lib = _build.library("defense_sort")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for cols, smem in [(plan["columns_per_block"] * 2, plan["smem_bytes"]),
                       (plan["columns_per_block"], plan["smem_bytes"] + 4)]:
        assert lib.sort_columns_bitonic(
            x.data_ptr(), out.data_ptr(), 1, u, log_u_pad, cols, smem, 37,
            _build.DTYPE_CODES[x.dtype], stream) != 0


@pytest.mark.gpu
def test_sort_guards_raise_on_the_card(cuda_device):
    with pytest.raises(ValueError, match="U<=32"):
        ops.sort_columns(torch.zeros(33, 8, device=cuda_device))
    with pytest.raises(ValueError, match="BITONIC_MAX_U"):
        ops.sort_columns_bitonic(torch.zeros(
            defense_sort.BITONIC_MAX_U + 1, 2, device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sort_past_the_bitonic_cap_is_torch_sort(cuda_device, dtype,
                                                 monkeypatch, caplog):
    """U = 8193 pads past the bitonic cap: no kernel, the card sorts with
    torch.sort (the reference's jnp.sort route), logged once per process,
    and launches nothing."""
    monkeypatch.setattr(defenses, "_sort_fallback_logged", False)
    u = defense_sort.BITONIC_MAX_U + 1
    assert defenses.sort_route(u) is None
    x = _normal(cuda_device, 3, 2, u, 37, dtype=dtype)
    ops.reset_launches()
    with caplog.at_level("WARNING", logger=defenses.__name__):
        for _ in range(2):
            got = defenses.sorted_columns(x)
            assert torch.equal(got, torch.sort(x, dim=-2).values)
        assert torch.equal(defenses.sorted_columns(x[0]),
                           torch.sort(x[0], dim=0).values)
    assert not any(ops.launch_counts().values())
    notes = [r for r in caplog.records if "BITONIC_MAX_U" in r.getMessage()]
    assert len(notes) == 1 and "torch.sort" in notes[0].getMessage()


@pytest.mark.gpu
@pytest.mark.parametrize("name,u,d", [("sort_columns", 10, 50890),
                                      ("sort_columns", 7, 129),
                                      ("sort_columns_bitonic", 100, 515),
                                      ("sort_columns_bitonic", 1000, 130)])
def test_sorts_of_inf_padded_slabs(cuda_device, name, u, d):
    """The masked defenses' slabs: each lane's non-participating rows are
    +inf (lanes with none, some, all but one).  Both CUDA sorts equal
    torch.sort exactly; the masked median and trimmed mean equal their
    plain route."""
    s = 4
    x = _normal(cuda_device, u + d, s, u, d)
    mask = torch.ones(s, u, dtype=torch.bool, device=cuda_device)
    gen = torch.Generator().manual_seed(u)
    for lane, k in enumerate([u, max(1, (2 * u) // 3), u // 2 + 1, 1]):
        mask[lane, torch.randperm(u, generator=gen)[k:]] = False
    padded = torch.where(mask[..., None], x, torch.inf)
    ops.reset_launches()
    assert torch.equal(ops.KERNELS[name](padded),
                       torch.sort(padded, dim=1).values)
    assert ops.launch_counts()[name] == 1
    med = defenses.flat_masked_median(x, mask)
    assert torch.equal(med, defenses.flat_masked_median(x, mask, plain=True))
    trim = torch.zeros(s, dtype=torch.int32, device=cuda_device)
    tm = defenses.flat_masked_trimmed_mean(x, trim, mask)
    torch.testing.assert_close(
        tm, defenses.flat_masked_trimmed_mean(x, trim, mask, plain=True),
        rtol=0, atol=0)
    assert torch.isfinite(med).all() and torch.isfinite(tm).all()


DEFENSE_GRIDS = {
    # figures.run_defenses' lanes: U = 10, the odd-even sort
    "defenses": (lambda mc: TF.defense_cases(mc), SMOKE,
                 {"sort_columns": 2 * ROUNDS, "floa_step_batched": ROUNDS,
                  "grad_stats": ROUNDS}),
    # figures.worker_grid at U = 100: the bitonic sort, blocked Krum
    "worker_grid_u100": (
        lambda mc: TF.worker_grid(100, mc.dim),
        dataclasses.replace(SMOKE, num_workers=100, train_samples=800),
        {"sort_columns_bitonic": 2 * ROUNDS, "floa_step_batched": ROUNDS,
         "grad_stats": ROUNDS}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("grid", sorted(DEFENSE_GRIDS))
def test_grouped_defense_sweep_matches_plain_route(cuda_device, grid):
    """A grouped digital-defense sweep through the kernels and again through
    their plain versions, from the same seeded draws."""
    cases, mc, expect = DEFENSE_GRIDS[grid]
    runs = []
    for plain in (False, True):
        ops.reset_launches()
        engine, params, batches = TF.cases_engine(
            cases(mc), ROUNDS, eval_every=2, mc=mc, device=cuda_device,
            force_plain=plain)
        runs.append(engine.run(params, batches))
        counts = ops.launch_counts()
        assert counts == {k: 0 if plain else expect.get(k, 0)
                          for k in ops.KERNELS}
    rk, rp = runs
    assert np.isfinite(rk.loss).all()
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    np.testing.assert_allclose(rk.grad_norm, rp.grad_norm, rtol=1e-4)
    for k in rk.params:
        torch.testing.assert_close(rk.params[k], rp.params[k], rtol=1e-4,
                                   atol=1e-6)


# tests/test_kernels.py's decode-attention grid, plus head groups of 8 and 6
# query heads per KV head (two blocks per KV head), dh = 32 (the smoke
# config), a long cache cut into many splits, the zoo's groups (G = 12,
# 5 and 1), and head dim 256 (recurrentgemma-9b's MQA local attention:
# G = 16, two head groups a KV head; its ring, its serve, S off the tile,
# and a rank's 8 heads on (1, 2)); the frontends' shapes:
# seamless-m4t-large-v2's self-attention serve and its cross-attention
# over 512 encoder positions (dh 64, G = 1), llava-next-mistral-7b's
# 4096-slot long_500k ring.
DECODE_GRID = [(1, 4, 1, 64, 512),      # MQA
               (2, 8, 2, 64, 1024),     # GQA
               (2, 8, 8, 128, 777),     # MHA, ragged length
               (1, 16, 4, 128, 2048),
               (2, 32, 4, 128, 300),    # G = 8
               (1, 12, 2, 32, 513),     # G = 6, dh = 32
               (3, 8, 2, 32, 64),
               (2, 32, 8, 128, 32768),
               (2, 24, 2, 128, 600),    # G = 12: starcoder2-3b
               (2, 40, 8, 128, 600),    # G = 5: llama4
               (2, 16, 16, 128, 600),   # G = 1 at KV = 16: moonshot
               (1, 16, 1, 256, 2048),   # dh 256, G = 16: the ring
               (8, 16, 1, 256, 64),     # dh 256: the serve
               (2, 16, 1, 256, 777),    # dh 256, off the tile
               (2, 8, 1, 256, 300),     # dh 256, G = 8: a rank's heads
               (8, 16, 16, 64, 64),     # seamless: self-attention
               (8, 16, 16, 64, 512),    # seamless: cross-attention
               (1, 32, 8, 128, 4096)]   # llava: the long_500k ring
# The kernel against the plain version on the same inputs upcast to f32.
# f32: they differ only in summation order and expf (rtol = atol = 1e-5).
# bf16: the kernel accumulates in f32 and rounds once, at the output (2^-9
# relative): rtol 1e-2, atol 1e-2 of the mean |output|.  The outputs are
# about sqrt(e / S) in size, so a fixed atol would pass a zero output.
DECODE_REL_BF16 = 1e-2


def _decode_inputs(dev, seed, b, h, kv, dh, s, dtype):
    return (_normal(dev, seed, b, h, dh, dtype=dtype),
            _normal(dev, seed + 1, b, s, kv, dh, dtype=dtype),
            _normal(dev, seed + 2, b, s, kv, dh, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,dh,s", DECODE_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain(cuda_device, b, h, kv, dh, s, dtype):
    q, k, v = _decode_inputs(cuda_device, s + h, b, h, kv, dh, s, dtype)
    ops.reset_launches()
    for pos in sorted({0, 1, s // 2, s - 3, s - 1}):
        got = ops.decode_attention(q, k, v, pos)
        want = ops.decode_attention(q.float(), k.float(), v.float(), pos,
                                    plain=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (b, h, dh)
        if dtype == torch.float32:
            _close(got, want, 1e-5)
        else:
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.cpu().numpy(),
                rtol=DECODE_REL_BF16,
                atol=DECODE_REL_BF16 * float(want.abs().mean()))
    assert ops.launch_counts()["decode_attention"] == len({0, 1, s // 2,
                                                           s - 3, s - 1})


@pytest.mark.gpu
@pytest.mark.parametrize("s", [256, 777, 32768])
def test_decode_attention_ignores_the_future(cuda_device, s):
    """Keys and values beyond pos are never read: overwriting them leaves
    the output bit for bit unchanged; pos as a device tensor (int32 or
    int64) equals pos as an int."""
    q, k, v = _decode_inputs(cuda_device, 7, 2, 8, 2, 128, s,
                             torch.bfloat16)
    for pos in (0, s // 3, s - 2):
        out1 = ops.decode_attention(q, k, v, pos)
        k2, v2 = k.clone(), v.clone()
        k2[:, pos + 1:] = 99.0
        v2[:, pos + 1:] = float("nan")
        assert torch.equal(ops.decode_attention(q, k2, v2, pos), out1)
        for t in (torch.tensor(pos, dtype=torch.int32, device=cuda_device),
                  torch.tensor(pos, device=cuda_device)):
            assert torch.equal(ops.decode_attention(q, k, v, t), out1)


def _holds_plain(got, q, k, v, pos):
    """The kernel's bf16 output against the plain version in f32, at the
    tolerance of test_decode_attention_matches_plain."""
    want = ops.decode_attention(q.float(), k.float(), v.float(), pos,
                                plain=True)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.cpu().numpy(), rtol=DECODE_REL_BF16,
        atol=DECODE_REL_BF16 * float(want.abs().mean()))


@pytest.mark.gpu
def test_decode_attention_tile_and_chunk_edges(cuda_device):
    """bf16 at pos + 1 on and off the 16-key warp slice and the 64-key ring
    stage, and on, one before and one past a chunk boundary of the split
    the card chooses (chunks of pos + 1 over n_split, in multiples of 16)."""
    b, s, h, kv, dh = 2, 4096, 32, 8, 128
    q, k, v = _decode_inputs(cuda_device, 11, b, h, kv, dh, s,
                             torch.bfloat16)
    n = DA._plan(cuda_device.index, b, h, kv, s, dh, torch.bfloat16)[0]
    assert n > 1
    edges = {15, 16, 17, 63, 64, 65, 127, 128}
    for m in (16, 64):
        edges |= {n * m - 2, n * m - 1, n * m}
    for pos in sorted(edges | {s - 1}):
        _holds_plain(ops.decode_attention(q, k, v, pos), q, k, v, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 5, 16, 63])
def test_decode_attention_cache_shorter_than_a_tile(cuda_device, s):
    q, k, v = _decode_inputs(cuda_device, s, 3, 8, 2, 64, s, torch.bfloat16)
    for pos in range(s):
        _holds_plain(ops.decode_attention(q, k, v, pos), q, k, v, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_decode_attention_eight_heads_in_one_block(cuda_device, dh):
    """G = 8 query heads per KV head: one bf16 block per (row, KV head,
    chunk), so K/V is read once."""
    b, h, kv, s = 2, 32, 4, 700
    assert DA.launch_plan(b, h, kv, s, torch.bfloat16, 264)[0] == b * kv
    q, k, v = _decode_inputs(cuda_device, dh, b, h, kv, dh, s,
                             torch.bfloat16)
    for pos in (0, 333, s - 1):
        _holds_plain(ops.decode_attention(q, k, v, pos), q, k, v, pos)


@pytest.mark.gpu
def test_decode_attention_serve_shape_every_pos(cuda_device):
    """The serve shape [8, 64] (qwen3-4b, 32 heads over 8 KV heads) is one
    pass at every pos."""
    b, s, h, kv, dh = 8, 64, 32, 8, 128
    assert DA._plan(cuda_device.index, b, h, kv, s, dh,
                    torch.bfloat16)[0] == 1
    q, k, v = _decode_inputs(cuda_device, 64, b, h, kv, dh, s,
                             torch.bfloat16)
    for pos in range(s):
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
        _holds_plain(ops.decode_attention(q, k, v, pos_t), q, k, v, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [64, 4096])
def test_decode_attention_graph_replay_matches_eager(cuda_device, s):
    """One call captured in a CUDA graph and replayed as pos advances on
    the device gives the eager call's bits (one pass at S = 64, split at
    S = 4096)."""
    q, k, v = _decode_inputs(cuda_device, 5, 2, 32, 8, 128, s,
                             torch.bfloat16)
    pos_t = torch.zeros((), dtype=torch.int32, device=cuda_device)
    ops.decode_attention(q, k, v, pos_t)   # build and plan outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos_t)
    for pos in sorted({0, 1, 17, s // 2, s - 1}):
        pos_t.fill_(pos)
        graph.replay()
        eager = ops.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.gpu
def test_decode_attention_guards_raise_on_the_card(cuda_device):
    q, k, v = _decode_inputs(cuda_device, 0, 1, 4, 1, 48, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, k, v, 3)
    q, k, v = _decode_inputs(cuda_device, 0, 1, 4, 1, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="on cpu"):
        ops.decode_attention(q, k.cpu(), v, 3)
    with pytest.raises(ValueError, match="aligned"):
        ops.decode_attention(q, k.flatten()[1:1 + k.numel() - 64]
                             .reshape(1, 63, 1, 64), v[:, :63].contiguous(), 3)
    with pytest.raises(ValueError, match="integer tensor"):
        ops.decode_attention(q, k, v, torch.tensor(3))    # pos on the CPU


@pytest.mark.gpu
def test_serve_kernel_route_matches_plain_route(cuda_device):
    """The smoke qwen3-4b (f32, 2 layers, dh = 32) served on the card through
    the kernel and through its plain version from the same seed: the same
    greedy tokens, logits at rtol 1e-4, one launch per layer per step."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve
    cfg = get_smoke("qwen3-4b")
    ops.reset_launches()
    rk = serve(cfg, 4, 8, 8, device=cuda_device)
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers * 16
    rp = serve(cfg, 4, 8, 8, device=cuda_device, plain=True)
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers * 16
    assert torch.equal(rk.tokens, rp.tokens)
    torch.testing.assert_close(rk.logits, rp.logits, rtol=1e-4, atol=1e-5)


def _trainer_runs(dev, mode, defense, flat):
    """The smoke-width fig3 BEV lane (one attacker, sigma 3) through
    `FLTrainer` on the card, by the kernel route and by the plain route from
    the same seeded draws: [(params, logs, launch counts)] * 2."""
    exp = TF.Experiment("BEV", Policy.BEV, n_attackers=1, alpha_hat=0.1,
                        attacker_sigma=3.0, rounds=ROUNDS)
    runs = []
    for plain in (False, True):
        tr, params, sampler = TF.experiment_trainer(
            exp, SMOKE, dev, mode=mode, defense=defense, force_plain=plain)
        ops.reset_launches()
        if flat:
            out = tr.run_scan(params, sampler.stack_rounds(ROUNDS), exp.seed,
                              eval_every=1, flat=True)
        else:
            out = tr.run(params, sampler, ROUNDS, exp.seed, eval_every=1)
        runs.append((*out, ops.launch_counts()))
    return runs


TRAINER_ROUTES = {
    "floa_loop": ("floa", "mean", False, {}),
    "floa_flat": ("floa", "mean", True, {"floa_step_batched": ROUNDS,
                                         "grad_stats": ROUNDS}),
    "median_loop": ("digital", "median", False, {"sort_columns": ROUNDS}),
    "trimmed_flat": ("digital", "trimmed_mean", True,
                     {"sort_columns": ROUNDS}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(TRAINER_ROUTES))
def test_trainer_kernel_route_matches_plain_route(cuda_device, route):
    mode, defense, flat, expect = TRAINER_ROUTES[route]
    (pk, lk, ck), (pp, lp, cp) = _trainer_runs(cuda_device, mode, defense,
                                               flat)
    assert ck == {k: expect.get(k, 0) for k in ops.KERNELS}
    assert not any(cp.values())
    loss_k = np.array([lg.loss for lg in lk])
    assert np.isfinite(loss_k).all()
    np.testing.assert_allclose(loss_k, [lg.loss for lg in lp], rtol=1e-4)
    np.testing.assert_allclose([lg.grad_norm for lg in lk],
                               [lg.grad_norm for lg in lp], rtol=1e-4)
    for k in pk:
        torch.testing.assert_close(pk[k], pp[k], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_showdown_kernel_route_matches_plain_route(cuda_device):
    """The 68-lane showdown at smoke width through the kernels and through
    their plain versions from the same seeded draws: the combine-only route
    for the 36 analog lanes (directional lanes in the spec), one sort per
    round for the median and trimmed-mean groups (+inf-padded K-of-U
    lanes among them)."""
    runs = []
    for plain in (False, True):
        ops.reset_launches()
        runs.append(TF.run_showdown(ROUNDS, mc=SMOKE, device=cuda_device,
                                    force_plain=plain))
        counts = ops.launch_counts()
        expect = {"floa_aggregate_batched": ROUNDS, "grad_stats": ROUNDS,
                  "sort_columns": 2 * ROUNDS}
        assert counts == {k: 0 if plain else expect.get(k, 0)
                          for k in ops.KERNELS}
        if not plain:
            d = SMOKE.dim
            assert ops.launch_shapes()["floa_aggregate_batched"] == {
                (36, 10, d): ROUNDS}
            assert ops.launch_shapes()["sort_columns"] == {
                (8, 10, d): 2 * ROUNDS}
    rk, rp = runs
    assert rk.loss.shape == (68, ROUNDS) and np.isfinite(rk.loss).all()
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    np.testing.assert_allclose(rk.grad_norm, rp.grad_norm, rtol=1e-4)
    for k in rk.params:
        torch.testing.assert_close(rk.params[k], rp.params[k], rtol=1e-4,
                                   atol=1e-6)


# The execution plan on the card: staging, checkpointed generator states,
# the strict route's fixed-order grad_stats and the switch dispatch's sort.


@pytest.mark.gpu
def test_async_staging_equals_sync_staging(cuda_device):
    """Blocks staged through the pinned buffers and the side stream equal
    the synchronous pageable copies bitwise, short last block and float64
    input included, while the compute stream is busy."""
    from repro_torch.launch.staging import BlockStager
    rng = np.random.default_rng(0)
    host = {"x": rng.standard_normal((7, 256, 784)),          # float64
            "y": rng.integers(0, 10, (7, 256))}
    blocks = [{k: v[i:i + 3] for k, v in host.items()} for i in (0, 3, 6)]
    sync = BlockStager(cuda_device, False)
    fast = BlockStager(cuda_device, True)
    busy = torch.randn(4096, 4096, device=cuda_device)
    staged = []
    for blk in blocks:
        for _ in range(4):   # keep the compute stream busy during copies
            busy = busy @ busy / 64.0
        staged.append(fast.stage(blk))
    for blk, st in zip(blocks, staged):
        got, want = st.ready(), sync.stage(blk).ready()
        for k in blk:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])
    assert fast._buffers[0]["x"].is_pinned()


@pytest.mark.gpu
def test_chunked_async_sweep_equals_monolithic_on_the_card(cuda_device):
    """Fig. 1's lanes at smoke width: chunked (C = 2, R = 5) with and
    without async staging equal the monolithic run bitwise on the card."""
    from repro_torch.fl.plan import ExecutionPlan
    exps = [TF.Experiment(n, p, rounds=ROUNDS)
            for n, p in [("EF", Policy.EF), ("CI", Policy.CI),
                         ("BEV", Policy.BEV)]]
    runs = []
    for plan in (ExecutionPlan(), ExecutionPlan(chunk_rounds=2),
                 ExecutionPlan(chunk_rounds=2, async_staging=True)):
        engine, params, batches = TF.figure_engine(
            exps, eval_every=2, mc=SMOKE, device=cuda_device, plan=plan)
        runs.append(engine.run(params, batches))
    for other in runs[1:]:
        np.testing.assert_array_equal(other.loss, runs[0].loss)
        np.testing.assert_array_equal(other.grad_norm, runs[0].grad_norm)
        for k in runs[0].params:
            assert torch.equal(other.params[k], runs[0].params[k])


@pytest.mark.gpu
def test_cuda_generator_states_survive_a_checkpoint(cuda_device, tmp_path):
    """A CUDA generator's state (seed and Philox offset) saved with
    save_pytree and set back continues the stream exactly."""
    from repro_torch import checkpoint as CK
    gens = [torch.Generator(cuda_device).manual_seed(s) for s in (1, 2)]
    for g in gens:
        torch.randn(1000, generator=g, device=cuda_device)
    CK.save_pytree(str(tmp_path), 1, {"rng": torch.stack(
        [g.get_state() for g in gens])})
    want = [torch.randn(50890, generator=g, device=cuda_device)
            for g in gens]
    saved, _ = CK.restore_pytree(str(tmp_path), 1)
    fresh = [torch.Generator(cuda_device).manual_seed(9) for _ in gens]
    for g, st in zip(fresh, saved["rng"]):
        g.set_state(st.clone())
    for g, w in zip(fresh, want):
        assert torch.equal(torch.randn(50890, generator=g,
                                       device=cuda_device), w)


@pytest.mark.gpu
def test_resumed_sweep_equals_uninterrupted_on_the_card(cuda_device,
                                                        tmp_path):
    """The showdown at smoke width, R = 4, chunks of 1 round, preempted
    after round 2: resumed == uninterrupted, bitwise, from the CUDA
    generators' saved states."""
    import os
    plain = TF.run_showdown(4, mc=SMOKE, device=cuda_device)
    ckpt = str(tmp_path / "ckpt")
    TF.run_showdown(4, mc=SMOKE, device=cuda_device, checkpoint_dir=ckpt)
    for f in os.listdir(ckpt):
        if int(f[len("ckpt_"):].split(".")[0]) > 2:
            os.remove(os.path.join(ckpt, f))
    resumed = TF.run_showdown(4, mc=SMOKE, device=cuda_device,
                              checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(resumed.loss, plain.loss)
    np.testing.assert_array_equal(resumed.metrics["accuracy"],
                                  plain.metrics["accuracy"])
    for k in plain.params:
        assert torch.equal(resumed.params[k], plain.params[k])


SEGMENTS = (64, 10, 50176, 640)   # the paper MLP's leaves: b1, b2, w1, w2


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [10, 40, 360])
def test_grad_stats_over_leaf_segments_matches_plain(cuda_device, rows):
    """The fixed-order route on each leaf segment (a row-strided view of
    the [R, D] slab) against the plain version, and its sums of a row do
    not depend on the slab the row sits in (R and the row's alignment)."""
    from repro_torch.core import standardize
    slab = _normal(cuda_device, rows, rows, sum(SEGMENTS))
    off = 0
    for n in SEGMENTS:
        seg = slab[:, off:off + n]
        got = ops.grad_stats_fixed(seg)
        want = ref.grad_stats_ref(seg)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-3)
        off += n
    whole = standardize.flat_scalar_stats(slab, SEGMENTS)
    part = standardize.flat_scalar_stats(slab[3:], SEGMENTS)
    for w, p in zip(whole, part):
        assert torch.equal(w[3:], p)
    plain = standardize.flat_scalar_stats(slab, SEGMENTS, plain=True)
    for w, p in zip(whole, plain):
        np.testing.assert_allclose(w.cpu().numpy(), p.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)


LM_SEGMENTS = (64, 64, 32768, 131072, 131072, 32768, 524288, 524288, 524288,
               512, 512, 524288, 256, 524288)   # lm_sweep's 14 leaves


def _segments_fold(rows, sizes):
    """One `grad_stats_fixed` call a segment, the pairs added in leaf order
    from 0 (the strict stats as a per-leaf loop)."""
    off, s1, s2 = 0, 0, 0
    for n in sizes:
        part = ops.grad_stats_fixed(rows[:, off:off + n])
        s1, s2 = s1 + part[:, 0], s2 + part[:, 1]
        off += n
    return torch.stack([s1, s2], dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,sizes", [(10, SEGMENTS), (40, SEGMENTS),
                                        (360, SEGMENTS), (1000, SEGMENTS),
                                        (16, LM_SEGMENTS)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_stats_segments_matches_plain(cuda_device, rows, sizes, dtype):
    """One call over every leaf segment against the plain version (rtol
    1e-4, atol 1e-3, grad_stats' tolerance; bf16 is widened exactly and
    summed in f32 by both); its sum column equals the numpy mirror of its
    add order bit for bit; and it equals the per-segment calls plus the
    leaf-order fold."""
    from fixed_order import fixed_order_sums
    slab = _normal(cuda_device, rows, rows, sum(sizes), dtype=dtype)
    ops.reset_launches()
    got = ops.grad_stats_segments(slab, sizes)
    assert ops.launch_shapes()["grad_stats_segments"] == {
        (rows, tuple(sizes)): 2}   # the parts and the fold kernel
    want = ops.grad_stats_segments(slab, sizes, plain=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    mirror = fixed_order_sums(slab.float().cpu().numpy(), sizes)
    assert np.array_equal(got[:, 0].cpu().numpy(), mirror)
    assert torch.equal(got, _segments_fold(slab, sizes))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [SEGMENTS, (7, 8193, 1, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_stats_segments_bits_depend_on_sizes_alone(cuda_device, sizes,
                                                        dtype):
    """A row's sums are the same bits in any slab: `slab` against
    `slab[3:]`, the rows copied into buffers of row stride D + 1, D + 2 and
    D + 3 (every element alignment), rows permuted; a CUDA-graph replay
    repeats the eager result."""
    d = sum(sizes)
    slab = _normal(cuda_device, 40, 40, d, dtype=dtype)
    whole = ops.grad_stats_segments(slab, sizes)
    assert torch.equal(ops.grad_stats_segments(slab[3:], sizes), whole[3:])
    for pad in (1, 2, 3):
        buf = torch.zeros(40, d + pad, device=cuda_device, dtype=dtype)
        buf[:, pad:] = slab
        view = buf[:, pad:]
        assert view.stride(0) == d + pad
        assert torch.equal(ops.grad_stats_segments(view, sizes), whole)
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ops.grad_stats_segments(slab[perm.to(cuda_device)],
                                               sizes), whole[perm])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.grad_stats_segments(slab, sizes)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, whole)


@pytest.mark.gpu
def test_switch_dispatch_sort_equals_torch_sort(cuda_device):
    """The switch dispatch sorts every lane of the defense grid's slab,
    [6, 10, D]: equal to torch.sort exactly."""
    x = _normal(cuda_device, 17, 6, 10, 50890)
    _sorts_exactly(ops.sort_columns, x)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["switch", "tree", "switch_strict",
                                  "tree_strict"])
def test_plan_routes_match_plain_route(cuda_device, plan):
    """The defense grid (switch) and Fig. 1's lanes (tree) through the
    kernels and again through their plain versions, from the same seeded
    draws, at rtol 1e-4."""
    from repro_torch.fl.plan import ExecutionPlan
    strict = plan.endswith("strict")
    knob = (dict(grouped_dispatch=False) if plan.startswith("switch")
            else dict(flat_state=False))
    runs = []
    for force_plain in (False, True):
        if plan.startswith("switch"):
            engine, params, batches = TF.cases_engine(
                TF.defense_cases(SMOKE), ROUNDS, eval_every=2, mc=SMOKE,
                device=cuda_device, force_plain=force_plain,
                plan=ExecutionPlan(strict_numerics=strict, **knob))
        else:
            exps = [TF.Experiment(n, p, rounds=ROUNDS)
                    for n, p in [("CI", Policy.CI), ("BEV", Policy.BEV)]]
            engine, params, batches = TF.figure_engine(
                exps, eval_every=2, mc=SMOKE, device=cuda_device,
                force_plain=force_plain,
                plan=ExecutionPlan(strict_numerics=strict, **knob))
        ops.reset_launches()
        runs.append(engine.run(params, batches))
        counts = ops.launch_counts()
        assert (sum(counts.values()) == 0) == force_plain, counts
    rk, rp = runs
    assert np.isfinite(rk.loss).all()
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    np.testing.assert_allclose(rk.grad_norm, rp.grad_norm, rtol=1e-4)
    for k in rk.params:
        torch.testing.assert_close(rk.params[k], rp.params[k], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.gpu
def test_strict_plan_routes_hold_their_contracts_on_the_card(cuda_device):
    """Under strict_numerics on the card: the tree state equals the flat
    state bitwise (fig3's lanes: the same fixed-order stats, combine bits
    and update rounding); the switch dispatch equals the grouped one at
    rtol 1e-6, the reference's contract (the defense grid's reductions
    over 6 lanes instead of 1 round differently: 2.0e-7 relative at full
    width over 20 rounds, PERF.md)."""
    from repro_torch.fl.plan import ExecutionPlan
    exps = [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                          attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    fig = [TF.figure_engine(exps, eval_every=2, mc=SMOKE, device=cuda_device,
                            plan=ExecutionPlan(strict_numerics=True,
                                               flat_state=flat))
           for flat in (True, False)]
    flat, tree = (e.run(p, b) for e, p, b in fig)
    np.testing.assert_array_equal(tree.loss, flat.loss)
    np.testing.assert_array_equal(tree.grad_norm, flat.grad_norm)
    for k in flat.params:
        assert torch.equal(tree.params[k], flat.params[k])
    grids = [TF.cases_engine(TF.defense_cases(SMOKE), ROUNDS, eval_every=2,
                             mc=SMOKE, device=cuda_device,
                             plan=ExecutionPlan(strict_numerics=True,
                                                grouped_dispatch=grouped))
             for grouped in (True, False)]
    grouped, switch = (e.run(p, b) for e, p, b in grids)
    assert np.isfinite(switch.loss).all()
    np.testing.assert_allclose(switch.loss, grouped.loss, rtol=1e-6)
    np.testing.assert_allclose(switch.grad_norm, grouped.grad_norm,
                               rtol=1e-6)
    for k in grouped.params:
        torch.testing.assert_close(switch.params[k], grouped.params[k],
                                   rtol=1e-6, atol=1e-7)


# The LM lane's shapes (figures.run_lm_lane: lm_sweep, D = 2 950 528,
# U = 8; the step over two analog lanes, 16 grad_stats rows, the median
# lane's sort), every input far beyond the L2.
LM_D, LM_U = 2_950_528, 8


@pytest.mark.gpu
def test_lm_lane_kernels_at_production_d(cuda_device):
    w, c, g, z, bias, eps, alpha = _inputs(cuda_device, 18, 2, LM_U, LM_D,
                                           torch.float32)
    ops.reset_launches()
    args = (w, c, g, z, bias, eps, alpha)
    for k, p in zip(ops.floa_step_batched(*args),
                    ops.floa_step_batched(*args, plain=True)):
        _close(k, p, TOL[torch.float32])
    rows = g.reshape(2 * LM_U, LM_D)
    np.testing.assert_allclose(ops.grad_stats(rows).cpu().numpy(),
                               ref.grad_stats_ref(rows).cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    _sorts_exactly(ops.sort_columns, g[:1])
    torch.cuda.synchronize()
    assert ops.launch_shapes()["floa_step_batched"] == {(2, LM_U, LM_D): 1}
    assert ops.launch_shapes()["grad_stats"] == {(2 * LM_U, LM_D): 1}
    assert ops.launch_shapes()["sort_columns"] == {(1, LM_U, LM_D): 1,
                                                   (LM_U, LM_D): 1}


@pytest.mark.gpu
def test_lm_lane_round_matches_plain_route(cuda_device):
    """Two rounds of the full LM lane through the kernels and through
    their plain versions, from the same seeded draws; both runs draw the
    weights with the init kernel, one launch a filled leaf."""
    from repro_torch.configs import get_lm_sweep
    from repro_torch.launch.sharding import filled_leaves
    ops.reset_launches()
    rk = TF.run_lm_lane(2, device=cuda_device)
    counts = ops.launch_counts()
    rp = TF.run_lm_lane(2, device=cuda_device, plain=True)
    inits = filled_leaves(get_lm_sweep())
    assert ops.launch_counts() == {**counts,
                                   "counter_trunc_normal": 2 * inits}
    assert {k: v for k, v in counts.items() if v} == {
        "floa_step_batched": 2, "grad_stats": 2, "sort_columns": 2,
        "counter_trunc_normal": inits}
    np.testing.assert_allclose(rk.loss, rp.loss, rtol=1e-4)
    np.testing.assert_allclose(rk.grad_norm, rp.grad_norm, rtol=1e-4)
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(rk.params), tree_leaves(rp.params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_one_rank_nccl_mesh_matches_unmeshed(cuda_device, tmp_path):
    """A one-rank NCCL process group and its ("data",) mesh: Fig. 3's lanes
    at smoke width equal the unmeshed run bitwise (the mesh's lane gathers
    go through NCCL as one-rank copies)."""
    import torch.distributed as dist
    from repro_torch.fl import ExecutionPlan
    from repro_torch.launch.mesh import make_sweep_mesh
    exps = [TF.Experiment(f"{n}@ah{ah}", p, n_attackers=1, alpha_hat=ah,
                          attacker_sigma=3.0, rounds=ROUNDS)
            for ah in (0.1, 1.0) for n, p in [("CI", Policy.CI),
                                              ("BEV", Policy.BEV)]]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_sweep_mesh()
        engine, params, batches = TF.figure_engine(
            exps, mc=SMOKE, device=cuda_device, plan=ExecutionPlan(mesh=mesh))
        assert engine._lane_group is not None
        meshed = engine.run(params, batches)
    finally:
        dist.destroy_process_group()
    engine, params, batches = TF.figure_engine(exps, mc=SMOKE,
                                               device=cuda_device)
    plain = engine.run(params, batches)
    assert np.array_equal(meshed.loss, plain.loss)
    assert np.array_equal(meshed.grad_norm, plain.grad_norm)
    assert all(torch.equal(meshed.params[k], plain.params[k])
               for k in plain.params)


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,kv", [(64, 24, 2), (4096, 24, 2),
                                    (8192, 32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_a_ring_past_its_wrap(cuda_device, s, h, kv,
                                                  dtype):
    """A ring-buffer cache's pos runs past S: every slot is attended.  The
    kernel against the plain version in f32 at pos S, S + 1, 7 S + 5 and
    long_500k's 524 287 (f32 at 1e-5, bf16 at the relative bound of
    test_decode_attention_matches_plain), bit for bit its own output at
    pos = S - 1, for an int pos and a device pos alike."""
    b, dh = 1, 128
    q, k, v = _decode_inputs(cuda_device, s + h, b, h, kv, dh, s, dtype)
    full = ops.decode_attention(q, k, v, s - 1)
    for pos in (s, s + 1, 7 * s + 5, 524287):
        for p in (pos, torch.tensor(pos, dtype=torch.int32,
                                    device=cuda_device)):
            got = ops.decode_attention(q, k, v, p)
            assert torch.equal(got, full)
        want = ops.decode_attention(q.float(), k.float(), v.float(), pos,
                                    plain=True)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            _close(got, want, 1e-5)
        else:
            _holds_plain(got, q, k, v, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [("starcoder2-3b", "decode_32k"),
                                        ("qwen3-4b", "long_500k")])
def test_ring_serve_kernel_route_matches_plain_route(cuda_device, arch,
                                                     shape):
    """Smoke starcoder2-3b (its native 64-slot ring) and qwen3-4b's
    long_500k window cut to 16 (f32, 2 layers), 40 + 40 tokens served past
    the ring's wrap through the kernel and through its plain version: the
    same greedy tokens, logits at rtol 1e-4, one launch a layer a step."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve
    cfg = get_smoke(arch)
    if shape == "long_500k":
        cfg = dataclasses.replace(cfg, long_context_window=16)
    ops.reset_launches()
    rk = serve(cfg, 2, 40, 40, device=cuda_device, shape=shape)
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers * 80
    rp = serve(cfg, 2, 40, 40, device=cuda_device, plain=True, shape=shape)
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers * 80
    assert torch.equal(rk.tokens, rp.tokens)
    torch.testing.assert_close(rk.logits, rp.logits, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_serve_kernel_route_matches_plain_route(cuda_device, arch):
    """The MoE archs on the card, kernel route against plain route.  Smoke
    (f32, 2 layers): the same greedy tokens over 16 + 16, logits at rtol
    1e-4.  Full width cut to 2 layers in bf16, 24 teacher-forced steps,
    the plain run replaying the kernel run's expert choices
    (`moe.RoutingTape`; a rounding-level difference can swap two nearly
    tied experts): logits within chip_smoke.py's bf16 bounds (max 0.25,
    mean 0.02)."""
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import sample_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import init_model, make_decode_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as LM
    cfg = get_smoke(arch)
    ops.reset_launches()
    rk = serve(cfg, 4, 16, 16, device=cuda_device)
    rp = serve(cfg, 4, 16, 16, device=cuda_device, plain=True)
    assert ops.launch_counts()["decode_attention"] == cfg.n_layers * 32
    assert torch.equal(rk.tokens, rp.tokens)
    torch.testing.assert_close(rk.logits, rp.logits, rtol=1e-4, atol=1e-5)

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                        cuda_device)
    b, n = 4, 24
    seq = torch.as_tensor(sample_tokens(b, n, cfg.vocab_size, seed=1),
                          device=cuda_device)
    pos = torch.arange(n, dtype=torch.int32, device=cuda_device)

    def logits(plain):
        step, _ = make_decode_step(cfg, plain=plain)
        caches = LM.init_caches(cfg, b, n, device=cuda_device)
        return torch.stack([step(params, caches, seq[:, i:i + 1],
                                 pos[i])[0][:, 0] for i in range(n)]).float()

    tape = MOE.RoutingTape()
    with MOE.routing(tape):
        lk = logits(False)
        tape.replay()
        lp = logits(True)
    assert tape.decisions == b * n * (cfg.n_layers // 2 if arch.startswith(
        "llama4") else cfg.n_layers)
    diff = (lk - lp).abs()
    assert float(diff.max()) <= 0.25 and float(diff.mean()) <= 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mamba2-1.3b"])
def test_mla_and_ssd_decode_matches_prefill_on_the_card(cuda_device, arch):
    """The smoke MLA and SSD archs (f32) on the card: 40 teacher-forced
    decode steps (MLA's absorbed form over the latent cache, the SSD
    block's recurrence; the SSD smoke chunk is 16, so three chunks)
    against the full-sequence forward on the same tokens, the forward's
    expert choices replayed in the decode, at rtol 1e-4 with an atol of
    1e-4 of the largest |logit|; neither path launches a kernel of the
    port."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import init_model, make_decode_step
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as LM
    cfg = get_smoke(arch)
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                        cuda_device)
    b, n = 2, 40
    seq = torch.as_tensor(sample_tokens(b, n, cfg.vocab_size, seed=2),
                          device=cuda_device)
    ops.reset_launches()
    ftape = MOE.RoutingTape()
    with torch.no_grad(), MOE.routing(ftape):
        want = LM.forward(params, seq, cfg)[0]
    dtape = ftape.by_step(b, n)
    step, _ = make_decode_step(cfg)
    caches = LM.init_caches(cfg, b, n, device=cuda_device)
    pos = torch.arange(n, dtype=torch.int32, device=cuda_device)
    with MOE.routing(dtape):
        got = torch.stack([step(params, caches, seq[:, i:i + 1],
                                pos[i])[0][:, 0] for i in range(n)], dim=1)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    assert len(dtape.recorded) == (n * cfg.n_layers if cfg.moe else 0)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
def test_gather_shards_on_a_one_rank_group(cuda_device, tmp_path):
    """`gather_shards` over a one-rank NCCL group: the forward is the
    shard itself, and the backward this rank's slice of the summed
    gradient, the gradient itself."""
    import torch.distributed as dist
    from repro_torch.launch.distributed import gather_shards
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator(cuda_device).manual_seed(0)
        x = torch.randn(3, 5, 8, device=cuda_device,
                        generator=gen).requires_grad_(True)
        r = torch.randn(3, 5, 8, device=cuda_device, generator=gen)
        y = gather_shards(x, dist.group.WORLD, dim=-1)
        (g,) = torch.autograd.grad((y * r).sum(), [x])
    finally:
        dist.destroy_process_group()
    assert torch.equal(y, x) and torch.equal(g, r)
    assert gather_shards(x, None) is x


@pytest.mark.gpu
@pytest.mark.parametrize("kv_cache_dtype", ["native", "int8"])
def test_hybrid_serve_kernel_route_matches_plain_route(cuda_device,
                                                       kv_cache_dtype):
    """The smoke recurrentgemma-9b at head dim 256 (f32, 5 layers: one
    local attention), its cache native or int8, served 40 + 40 tokens past
    its 32-slot local ring through the kernel and through its plain
    version: the same greedy tokens, logits at rtol 1e-4, one launch a
    local-attention layer a step (the int8 step dequantizes its cache and
    runs the same kernel); and the decode against the full-sequence
    forward (native) at rtol 1e-4 of the largest |logit|."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import sample_tokens
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import init_model, make_decode_step
    from repro_torch.models import transformer as LM
    cfg = dataclasses.replace(get_smoke("recurrentgemma-9b"), head_dim=256,
                              kv_cache_dtype=kv_cache_dtype)
    local = sum(k == "local_attn" for k in cfg.block_pattern)
    ops.reset_launches()
    rk = serve(cfg, 2, 40, 40, device=cuda_device)
    assert ops.launch_counts()["decode_attention"] == local * 80
    assert ops.launch_shapes()["decode_attention"] == {
        (2, 32, 4, 1, 256): local * 80}
    rp = serve(cfg, 2, 40, 40, device=cuda_device, plain=True)
    assert ops.launch_counts()["decode_attention"] == local * 80
    assert torch.equal(rk.tokens, rp.tokens)
    torch.testing.assert_close(rk.logits, rp.logits, rtol=1e-4, atol=1e-5)
    if kv_cache_dtype == "int8":
        return
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                        cuda_device)
    b, n = 2, 48
    seq = torch.as_tensor(sample_tokens(b, n, cfg.vocab_size, seed=2),
                          device=cuda_device)
    with torch.no_grad():
        want = LM.forward(params, seq, cfg)[0]
    step, _ = make_decode_step(cfg)
    caches = LM.init_caches(cfg, b, n, device=cuda_device)
    pos = torch.arange(n, dtype=torch.int32, device=cuda_device)
    got = torch.stack([step(params, caches, seq[:, i:i + 1], pos[i])[0][:, 0]
                       for i in range(n)], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
def test_encdec_decode_kernel_route_matches_plain_route(cuda_device):
    """The smoke seamless-m4t-large-v2 (f32, 2 + 2 layers, dh 32) decoded
    24 steps over 40 encoder frames through the kernel and through its
    plain version: two launches a decoder layer a step (self and cross,
    by shape), logits at rtol 1e-4; and the kernel route against
    `decode_full` at rtol 1e-4 of the largest |logit|."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import sample_tokens
    from repro_torch.launch.steps import (init_model, make_cross_kv_step,
                                          make_decode_step)
    from repro_torch.models import encdec as ED
    cfg = get_smoke("seamless-m4t-large-v2")
    b, n, se = 2, 24, 40
    params = init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                        cuda_device)
    frames = _normal(cuda_device, 3, b, se, cfg.frontend.feature_dim)
    seq = torch.as_tensor(sample_tokens(b, n, cfg.vocab_size, seed=4),
                          device=cuda_device)
    kv_step, _ = make_cross_kv_step(cfg)
    cross = kv_step(params, frames)
    pos = torch.arange(n, dtype=torch.int32, device=cuda_device)
    runs = {}
    for plain in (False, True):
        step, _ = make_decode_step(cfg, plain=plain)
        caches = ED.init_dec_caches(cfg, b, n, device=cuda_device)
        ops.reset_launches()
        runs[plain] = torch.stack([step(params, caches, cross, seq[:, i:i + 1],
                                        pos[i])[0][:, 0] for i in range(n)],
                                  dim=1)
        layers = cfg.encdec.n_dec_layers
        assert ops.launch_shapes()["decode_attention"] == ({} if plain else {
            (b, n, 4, 4, 32): layers * n, (b, se, 4, 4, 32): layers * n})
    torch.testing.assert_close(runs[False], runs[True], rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        want = ED.decode_full(params, seq, ED.encode(params, frames, cfg),
                              cfg)
    torch.testing.assert_close(runs[False], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,dh,s,dtype", [
    (8, 32, 8, 128, 32768, torch.bfloat16), (8, 32, 8, 128, 64, torch.bfloat16),
    (1, 16, 1, 256, 2048, torch.bfloat16), (8, 16, 16, 64, 512, torch.float32),
    (2, 8, 2, 32, 777, torch.float32)])
def test_decode_fake_rule_plans_as_the_kernel(cuda_device, b, h, kv, dh, s,
                                              dtype):
    """The card op's fake rule (what `launch/dryrun.py` traces) allocates
    what the launch does: the output and the split-K workspace, planned
    from `H100_SMS` and `H100_OCCUPANCY` as the kernel plans them from the
    card; a real CUDA tensor launches (counted), a fake one never does;
    the wrapper, off the dispatcher, launches the same kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    lib = _build.library("decode_attention")
    code = _build.DTYPE_CODES[dtype]
    assert lib.decode_attention_occupancy(dh, code) == \
        DA.H100_OCCUPANCY[(dh, dtype)]
    assert torch.cuda.get_device_properties(
        cuda_device).multi_processor_count == DA.H100_SMS
    q, k, v = _decode_inputs(cuda_device, 3, b, h, kv, dh, s, dtype)
    pos = torch.tensor([s - 1], dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    out, ws = DA._card_route(q, k, v, pos)
    assert ops.launch_counts()["decode_attention"] == 1
    n_split, ws_numel = DA._plan(cuda_device.index, b, h, kv, s, dh, dtype)
    assert ws.numel() == ws_numel
    assert (n_split, ws_numel) == DA.split_plan(
        b, h, kv, s, dh, dtype, DA.H100_SMS * DA.H100_OCCUPANCY[(dh, dtype)])
    with FakeTensorMode() as mode:
        fq, fk, fv, fpos = (mode.from_tensor(t) for t in (q, k, v, pos))
        fout, fws = DA._card_route(fq, fk, fv, fpos)
    assert ops.launch_counts()["decode_attention"] == 1
    assert (fout.shape, fout.dtype, fout.device) == (out.shape, out.dtype,
                                                     out.device)
    assert (fws.shape, fws.dtype) == (ws.shape, ws.dtype)
    assert torch.equal(DA.decode_attention(q, k, v, pos), out)
    assert ops.launch_counts()["decode_attention"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-236b", "mamba2-1.3b",
                                  "recurrentgemma-9b",
                                  "llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_remat_step_bitwise_equals_no_remat_on_the_card(cuda_device, arch):
    """One seeded BEV train step of the smoke config with remat=True
    against remat=False on the card, where the backward (and so each
    block's recompute) runs in autograd's device thread: new params,
    stale stats and metrics bitwise; the expert chunks lowered to two
    experts a chunk on the MoE archs, so several chunks run."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_leaves
    cfg = get_smoke(arch)
    shape = dict(global_batch=4, seq_len=24, kind="train")
    params = ST.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                           cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(1)
    batch = {}
    for k, (s, dt) in ST.batch_shapes(cfg, shape, "train").items():
        batch[k] = (torch.randint(0, cfg.vocab_size, s, generator=gen,
                                  device=cuda_device, dtype=dt)
                    if k == "tokens" else
                    torch.randn(s, generator=gen, device=cuda_device).to(dt))
    old = MOE.EXPERT_CHUNK_BYTES
    if cfg.moe is not None:
        per = 4 * 24 * 3 * (cfg.moe.d_expert + cfg.d_model) * 4
        MOE.EXPERT_CHUNK_BYTES = 2 * per
    try:
        out = [ST.make_train_step(dataclasses.replace(cfg, remat=r), None,
                                  shape, alpha=0.02)[0](
            params, ST.init_floa_state(cuda_device), batch, 3)
            for r in (False, True)]
    finally:
        MOE.EXPERT_CHUNK_BYTES = old
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        assert torch.equal(a, b)
    for i in (1, 2):
        for k in out[0][i]:
            assert torch.equal(out[0][i][k], out[1][i][k]), k
    assert torch.isfinite(out[1][2]["loss"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noisy_sgd_kernel_against_its_plain_version(cuda_device, dtype):
    """The update kernel at a leaf split (16, 4) with misaligned rows: z
    (an f32 update of zeros at alpha -1) within 1e-5 of the plain stream,
    the fused update bitwise its z-given mode on that z and the plain
    update given it, every part bitwise the whole's slice, no noise mode
    bitwise the plain one; one launch a call."""
    from collections import namedtuple
    from repro_torch.kernels import philox as P
    ax = namedtuple("Ax", "index size")
    full = (16, 36, 20)
    draw = P.Draw(2 ** 40 + 9, 5, P.Part.whole(full))
    zeros = torch.zeros(full, device=cuda_device)
    zero = torch.zeros((), device=cuda_device)
    one = torch.ones((), device=cuda_device)
    ops.reset_launches()
    z = ops.noisy_sgd(zeros, zeros, zero, one, -1.0, draw=draw)
    assert ops.launch_counts()["noisy_sgd"] == 1
    assert float((z - P.normal(draw, cuda_device)).abs().max()) <= 1e-5
    gen = torch.Generator(cuda_device).manual_seed(0)
    p = torch.randn(full, generator=gen, device=cuda_device).to(dtype)
    g = (torch.randn(full, generator=gen, device=cuda_device)
         * 1e-2).to(dtype)
    shift = torch.tensor(1e-3, device=cuda_device).to(dtype)
    scale = torch.tensor(0.1, device=cuda_device)
    fused = ops.noisy_sgd(p, g, shift, scale, 0.05, draw=draw)
    given = ops.noisy_sgd(p, g, shift, scale, 0.05, z=z)
    assert torch.equal(fused, given)
    assert torch.equal(given, ops.noisy_sgd(p, g, shift, scale, 0.05, z=z,
                                            plain=True))
    assert torch.equal(ops.noisy_sgd(p, g, shift, scale, 0.05),
                       ops.noisy_sgd(p, g, shift, scale, 0.05, plain=True))
    for mi in range(16):
        for ri in range(4):
            part = P.split_part(full, ((0, ax(mi, 16)), (2, ax(ri, 4))))
            sl = part.slices
            got = ops.noisy_sgd(p[sl].contiguous(), g[sl].contiguous(),
                                shift, scale, 0.05,
                                draw=P.Draw(draw.seed, 5, part))
            assert torch.equal(got, fused[sl])


@pytest.mark.gpu
def test_counter_trunc_normal_and_philox_on_the_card(cuda_device):
    """The init's fill within one bf16 ulp of the plain version and its
    parts bitwise the whole's; Philox4x32-10 bitwise curand's on random
    counters and keys."""
    from collections import namedtuple
    from repro_torch.kernels import noisy_update as NU
    from repro_torch.kernels import philox as P
    ax = namedtuple("Ax", "index size")
    full = (8, 64, 36)
    whole = P.Part.whole(full)
    out = ops.counter_trunc_normal(torch.empty(
        full, dtype=torch.bfloat16, device=cuda_device), 3, 7, whole, 0.05)
    want = ops.counter_trunc_normal(torch.empty(
        full, dtype=torch.bfloat16, device=cuda_device), 3, 7, whole, 0.05,
        plain=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2 ** -7,
                               atol=1e-8)
    for mi in range(4):
        part = P.split_part(full, ((2, ax(mi, 4)),))
        got = ops.counter_trunc_normal(torch.empty(
            part.shape, dtype=torch.bfloat16, device=cuda_device), 3, 7, part,
            0.05)
        assert torch.equal(got, out[part.slices])
    gen = torch.Generator(cuda_device).manual_seed(1)
    ctr = torch.randint(-2 ** 31, 2 ** 31, (4096, 4), dtype=torch.int32,
                        device=cuda_device, generator=gen)
    key = torch.randint(-2 ** 31, 2 ** 31, (4096, 2), dtype=torch.int32,
                        device=cuda_device, generator=gen)
    assert torch.equal(NU.philox_raw(ctr, key),
                       NU.philox_raw(ctr, key, curand=True))


# The update kernel's fast path takes 8 elements of one row whose global
# indices start at a multiple of 4; these parts put its edges everywhere:
# rows starting at j = 1, 2, 3 (mod 4), rows of 4, 12, 20 and 64 elements
# over many rows (of two and of three dims after merging), and a tail
# shorter than one vector.
_BOUNDARY_PARTS = {
    "row_start_j1": ((301, 40), (0, 1), (301, 20)),
    "row_start_j2": ((301, 40), (0, 2), (301, 20)),
    "row_start_j3": ((301, 40), (0, 3), (301, 20)),
    "rows_of_4": ((257, 12), (0, 4), (257, 4)),
    "rows_of_12": ((257, 36), (0, 12), (257, 12)),
    "rows_of_20": ((257, 60), (0, 40), (257, 20)),
    "rows_of_64": ((36, 96, 1024), (0, 0, 64), (36, 96, 64)),
    # three dims after merging: rows from the block's table
    "three_dims_rows_of_12": ((6, 40, 24), (1, 8, 4), (4, 20, 12)),
    "three_dims_rows_of_64": ((4, 64, 256), (0, 32, 64), (4, 32, 64)),
    "tail_under_one_vector": ((4099,), (0,), (4099,)),
    "three_elements": ((7,), (2,), (3,)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_BOUNDARY_PARTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noisy_kernels_at_the_fast_path_edges(cuda_device, case, dtype):
    """At each part of `_BOUNDARY_PARTS`: the drawn z (an f32 update of
    zeros at alpha -1) bitwise the whole leaf's slice; the fused update
    bitwise its z-given mode, that mode and no-noise mode bitwise the
    plain update; p and g (and out's fill) at an odd element offset, so no
    pointer is 16-byte aligned, bitwise the aligned call; the init's fill
    bitwise the whole leaf's slice and within one bf16 ulp of its plain
    version."""
    from repro_torch.kernels import philox as P
    full, off, shape = _BOUNDARY_PARTS[case]
    part = P.Part(full, off, shape)
    whole = P.Part.whole(full)
    seed, leaf = 2 ** 33 + 17, 4
    zeros = torch.zeros(full, device=cuda_device)
    zero = torch.zeros((), device=cuda_device)
    one = torch.ones((), device=cuda_device)
    z_whole = ops.noisy_sgd(zeros, zeros, zero, one, -1.0,
                            draw=P.Draw(seed, leaf, whole))
    z = ops.noisy_sgd(zeros[part.slices].contiguous(),
                      zeros[part.slices].contiguous(), zero, one, -1.0,
                      draw=P.Draw(seed, leaf, part))
    assert torch.equal(z, z_whole[part.slices])
    gen = torch.Generator(cuda_device).manual_seed(2)
    n = part.numel
    pbuf = torch.randn(n + 1, generator=gen, device=cuda_device).to(dtype)
    gbuf = (torch.randn(n + 1, generator=gen, device=cuda_device)
            * 1e-2).to(dtype)
    p, g = pbuf[:n].view(shape).clone(), gbuf[:n].view(shape).clone()
    shift = torch.tensor(1e-3, device=cuda_device).to(dtype)
    scale = torch.tensor(0.1, device=cuda_device)
    draw = P.Draw(seed, leaf, part)
    fused = ops.noisy_sgd(p, g, shift, scale, 0.05, draw=draw)
    given = ops.noisy_sgd(p, g, shift, scale, 0.05, z=z)
    assert torch.equal(fused, given)
    assert torch.equal(given, ops.noisy_sgd(p, g, shift, scale, 0.05, z=z,
                                            plain=True))
    assert torch.equal(ops.noisy_sgd(p, g, shift, scale, 0.05),
                       ops.noisy_sgd(p, g, shift, scale, 0.05, plain=True))
    # the same values at an odd element offset: contiguous, not aligned
    p1, g1 = pbuf[1:].view(shape), gbuf[1:].view(shape)
    p1.copy_(p)
    g1.copy_(g)
    assert p1.data_ptr() % 16 != 0 and p1.is_contiguous()
    assert torch.equal(ops.noisy_sgd(p1, g1, shift, scale, 0.05, draw=draw),
                       fused)
    assert torch.equal(ops.noisy_sgd(p1, g1, shift, scale, 0.05, z=z),
                       given)
    # the init's fill
    w = ops.counter_trunc_normal(torch.empty(
        full, dtype=dtype, device=cuda_device), seed, leaf, whole, 0.05)
    got = ops.counter_trunc_normal(torch.empty(
        shape, dtype=dtype, device=cuda_device), seed, leaf, part, 0.05)
    assert torch.equal(got, w[part.slices])
    obuf = torch.empty(n + 1, dtype=dtype, device=cuda_device)
    odd = ops.counter_trunc_normal(obuf[1:].view(shape), seed, leaf, part,
                                   0.05)
    assert torch.equal(odd, got)
    want = ops.counter_trunc_normal(torch.empty(
        shape, dtype=dtype, device=cuda_device), seed, leaf, part, 0.05,
        plain=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2 ** -7,
                               atol=1e-8)


# ------------------------------------------------ compiled execution

def _tiny_lm():
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("qwen3-4b"), n_layers=2)


@pytest.mark.gpu
def test_graphed_serve_equals_eager(cuda_device):
    """`serve` replaying its captured decode step gives the eager loop's
    tokens and logits bit for bit (sampled, so the sampler's generator
    runs between replays), with the same launches; one capture, and every
    position after the first (the warm-up) a replay."""
    from repro_torch import graphs
    from repro_torch.launch.serve import serve
    cfg, (b, p, g) = _tiny_lm(), (4, 12, 10)
    graphs.reset_totals()
    ops.reset_launches()
    got = serve(cfg, b, p, g, device=cuda_device, temperature=0.7)
    counts = ops.launch_counts()
    tot = graphs.totals()
    assert (tot["captures"], tot["replays"]) == (1, p + g - 1)
    ops.reset_launches()
    with graphs.disable_graphs():
        want = serve(cfg, b, p, g, device=cuda_device, temperature=0.7)
    assert ops.launch_counts() == counts
    assert counts["decode_attention"] == (p + g) * cfg.n_layers
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits, want.logits)


def _train_runs(dev, seeds, graphed):
    """The tiny LM's train steps from one init at the given seeds: the
    graphed loop (`launch.train.compile_step`, a device counter copied
    in) or the eager steps."""
    from repro_torch import graphs
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    cfg = _tiny_lm()
    step, _ = ST.make_train_step(cfg, None, dict(global_batch=4, seq_len=16),
                                 alpha=0.05)
    params = ST.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    state = ST.init_floa_state(dev)
    run = TR.compile_step(step) if graphed else step
    losses = []
    with contextlib.nullcontext() if graphed else graphs.disable_graphs():
        for t, s in enumerate(seeds):
            batch = TR.make_batch(cfg, 4, 16, t, dev)
            seed = torch.tensor(s, dtype=torch.int64, device=dev)
            params, state, m = run(params, state, batch, seed)
            losses.append(float(m["loss"]))
    return params, state, losses


@pytest.mark.gpu
def test_graphed_train_step_equals_eager(cuda_device):
    """Three train steps replaying the captured step (its seed a device
    tensor the kernel reads) give the eager steps' params, stale stats and
    losses bit for bit; a replay under another seed draws other noise."""
    from repro_torch.tree import tree_leaves
    seeds = [3, 4, 5]
    gp, gs, gl = _train_runs(cuda_device, seeds, graphed=True)
    ep, es, el = _train_runs(cuda_device, seeds, graphed=False)
    assert gl == el
    for a, b in zip(tree_leaves(gp) + tree_leaves(gs),
                    tree_leaves(ep) + tree_leaves(es)):
        assert torch.equal(a, b)
    op, _, _ = _train_runs(cuda_device, [3, 4, 6], graphed=True)
    assert not torch.equal(tree_leaves(op)[0], tree_leaves(gp)[0])


@pytest.mark.gpu
def test_graphed_fig1_sweep_equals_eager(cuda_device):
    """Fig. 1's lanes through the round's captured graph (the seeded
    draws from the lanes' generators inside it) give the eager loop's
    losses, grad norms and final params bit for bit, with the same
    launches by shape."""
    from repro_torch import graphs
    ops.reset_launches()
    got = TF.run_figure(LANES["fig1"], eval_every=2, mc=SMOKE,
                        device=cuda_device)
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    ops.reset_launches()
    with graphs.disable_graphs():
        want = TF.run_figure(LANES["fig1"], eval_every=2, mc=SMOKE,
                             device=cuda_device)
    assert (ops.launch_counts(), ops.launch_shapes()) == (counts, shapes)
    assert np.array_equal(got.loss, want.loss)
    assert np.array_equal(got.grad_norm, want.grad_norm)
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k])


@pytest.mark.gpu
def test_graphed_resume_equals_uninterrupted(cuda_device, tmp_path):
    """The showdown (Markov, K-of-U, colluding lanes) at a smoke width,
    graphed, chunked with a checkpoint a chunk: resumed from its second
    checkpoint (a fresh engine, graphed) it ends bitwise as the
    uninterrupted run, whose checkpoints hold the eager run's generator
    states."""
    import shutil
    from repro_torch import graphs
    from repro_torch.checkpoint import ckpt as CKPT
    rounds = 8
    full = TF.run_showdown(rounds, mc=SMOKE, device=cuda_device,
                           checkpoint_dir=str(tmp_path / "full"))
    with graphs.disable_graphs():
        eager = TF.run_showdown(rounds, mc=SMOKE, device=cuda_device,
                                checkpoint_dir=str(tmp_path / "eager"))
    assert np.array_equal(full.loss, eager.loss)
    a, _ = CKPT.restore_pytree(str(tmp_path / "full"), 4)
    b, _ = CKPT.restore_pytree(str(tmp_path / "eager"), 4)
    for k in a["carry"]["rng"]:
        assert torch.equal(a["carry"]["rng"][k], b["carry"]["rng"][k])
    shutil.copytree(tmp_path / "full", tmp_path / "cut")
    for f in (tmp_path / "cut").glob("ckpt_6*"):
        f.unlink()
    resumed = TF.run_showdown(rounds, mc=SMOKE, device=cuda_device,
                              checkpoint_dir=str(tmp_path / "cut"),
                              resume=True)
    assert np.array_equal(resumed.loss, full.loss)
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k])

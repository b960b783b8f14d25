"""`repro_torch.launch.cost_analysis`, the counterpart of
`repro/launch/hlo_analysis.py`: `model_flops` and `active_params` equal
the reference's for all ten full configs at the four input shapes; the
roofline arithmetic on the H100's constants; and `CostMode`'s tally of a
known sequence of collectives on a fake process group of 16 ranks (two
nodes of 8), the library's wrappers and a direct `dist.all_reduce`
included; its live bytes, and a trace's peak where `gather`'s backward
runs out of place on fake tensors against an eager run's."""
import contextlib
import warnings

import pytest
import torch
import torch.distributed as dist

with warnings.catch_warnings():
    # jax 0.9 deprecates jax.experimental.shard_map, which the reference
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import get_config as jget_config
    from repro.launch import hlo_analysis as JHA

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import steps as ST
from repro_torch.launch.distributed import all_gather, gather_storage


def test_model_flops_and_active_params_equal_the_reference():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        n = ST.param_count(cfg)
        assert CA.active_params(cfg, n) == JHA.active_params(jcfg, n), arch
        for name, shape in INPUT_SHAPES.items():
            assert CA.model_flops(cfg, shape, n, CA.active_params(cfg, n)) \
                == JHA.model_flops(jcfg, shape, n,
                                   JHA.active_params(jcfg, n)), (arch, name)


def test_roofline_terms_on_h100_constants():
    """One second of each resource at the data sheet's rates; the NVLink
    bytes over 450 GB/s beside the network's over 50 GB/s."""
    t = CA.roofline_terms(989e12, 3.35e12, 50e9)
    assert t == pytest.approx(dict(compute_s=1.0, memory_s=1.0,
                                   collective_s=1.0))
    t = CA.roofline_terms(989e12, 2 * 3.35e12, 100e9, 450e9)
    assert t == pytest.approx(dict(compute_s=1.0, memory_s=2.0,
                                   collective_s=3.0))
    assert CA.dominant(t) == "collective_s"
    assert CA.dominant(CA.roofline_terms(1e15, 1.0, 0.0)) == "compute_s"
    assert CA.H100_TOTAL_MEMORY < 80 * 2 ** 30 < 86e9
    assert CA.group_link(range(8)) == "nvlink"
    assert CA.group_link(range(8, 16)) == "nvlink"
    assert CA.group_link([0, 8]) == "network"
    assert CA.group_link(range(16)) == "network"


def test_tally_of_known_collectives_on_a_fake_group():
    """A fake group of 16 ranks (this process its rank 0): each c10d
    collective is counted once with its result's bytes, by kind, and by
    the link of its group (ranks 0-7 one node: NVLink; 0 and 8 two nodes:
    the network); the library's wrappers and the train step's direct
    all_reduce (`steps._sum_over_workers`) are seen."""
    with DRY.fake_group(16):
        node = dist.new_group(list(range(8)), backend="fake")
        pair = dist.new_group([0, 8], backend="fake")
        x = torch.zeros(4, 8)                 # 128 bytes
        y = torch.zeros(10, dtype=torch.bfloat16)   # 20 bytes
        with CA.CostMode() as cost:
            dist.all_reduce(x, group=node)                      # 128 nvlink
            all_gather(y, node)                                 # 160 nvlink
            dist.reduce_scatter(y, [y.clone() for _ in range(2)],
                                group=pair)                     # 20 network
            dist.broadcast(x, 0, group=pair)                    # 128 network
            z = gather_storage(y, pair)                         # 40 network
            grads = [torch.zeros(3), torch.zeros(5)]
            ST._sum_over_workers(grads, pair)                   # 32 network
    assert tuple(z.shape) == (20,)
    got = cost.collective_summary()
    assert got == {"all_reduce": 160, "all_gather": 200,
                   "reduce_scatter": 20, "broadcast": 128, "all_to_all": 0,
                   "total": 508, "by_link": {"nvlink": 288, "network": 220},
                   "calls": {"all_reduce": 2, "all_gather": 2,
                             "reduce_scatter": 1, "broadcast": 1,
                             "all_to_all": 0}}
    assert not dist.is_initialized()


def test_live_bytes_follow_each_storage():
    """`CostMode` counts a storage from the op that makes it to its
    release, a view as nothing, and what `track` registers."""
    a = torch.zeros(256)
    args = {"a": a, "b": [a, a[:3]]}
    with CA.CostMode() as cost:
        assert cost.track(args) == 1024
        b = a * 2
        v = b.view(16, 16)
        assert cost.live == 2048
        del b
        assert cost.live == 2048          # the view holds the storage
        del v
        assert cost.live == 1024
        c = torch.empty(1000, dtype=torch.bfloat16)
        del c
    assert cost.peak == 1024 + 2000
    assert cost.op_bytes == 2 * 1024 + 2000


def test_meta_tensors_and_card_workspace():
    """A "meta" tensor (shapes only, as `init_params(..., "meta")` makes
    for the noise's shapes) adds nothing to the live bytes; an op of the
    card's workspace table (`CARD_WORKSPACE`: the softmax backward's
    grad * output) adds its buffer to the peak while it runs, beside its
    output, and leaves nothing live after it."""
    x = torch.zeros(64, 32, requires_grad=True)
    with CA.CostMode(workspace=CA.CARD_WORKSPACE) as cost:
        cost.track(x)
        torch.empty(1 << 30, device="meta")
        assert cost.live == cost.peak == 64 * 32 * 4
        y = torch.softmax(x, dim=-1)
        g, = torch.autograd.grad(y, x, torch.ones_like(y))
        del y, g
    # x, y, the ones, the softmax backward's output and its workspace
    assert cost.peak == 5 * 64 * 32 * 4
    assert cost.live == 64 * 32 * 4


def test_gather_backward_peaks_as_an_eager_run():
    """`gather`'s backward scatters into a fresh zeros buffer: in place on
    plain tensors, out of place on fake ones (`SUBCLASS_OUT_OF_PLACE`).
    The trace on fake tensors peaks at the eager run's bytes: x, the
    incoming gradient and the zeros buffer, not a copy of it too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def peak(fake):
        with FakeTensorMode() if fake else contextlib.nullcontext():
            x = torch.zeros(64, 1000, requires_grad=True)
            idx = torch.zeros(64, 1, dtype=torch.long)
            with CA.CostMode() as cost:
                cost.track(x, idx)
                y = torch.gather(x, 1, idx)
                g, = torch.autograd.grad(y, x, torch.ones_like(y))
                del y, g
        return cost.peak

    assert peak(True) == peak(False) == 2 * 64 * 1000 * 4 + 2 * 64 * 4 + 64 * 8

"""The train step's per-leaf update with its noise drawn from the stream,
and the init's fill: wrappers around `csrc/noisy_update.cu`.

`noisy_sgd(p, g, shift, scale, alpha, z=, draw=)` is one leaf's part of
the FLOA update, p - alpha (g + shift + scale z), with the reference's
roundings (`repro/launch/steps.py:224-236`): x = g + shift in g's dtype,
x + (scale z) rounded to g's dtype, then (f32(p) - alpha f32(x)) rounded
to p's dtype.  z is one of: drawn from the stream (`draw`, a
`philox.Draw`: the step's seed, the leaf index, the part's place in the
whole leaf; purpose NOISE), so a rank draws only its part and no z is ever
stored; the kernel reads the seed's key from device memory (an int seed
is placed there first), so a launch captured in a CUDA graph draws under
the seed its tensor holds at each replay; given (`z`, a tensor of the
part's shape: the replayed draws); or none (no noise).  It replaces no
Pallas kernel: the reference's update is fused by XLA.
`counter_trunc_normal(out, seed, leaf, part, scale)` fills a part of a
leaf with the init's truncated normal times `scale`
(`models.common.ParamInit`, purpose INIT), under a host key: the init is
not captured.

CPU tensors take the plain versions (`noisy_sgd_ref`, chunked by the
caller's `chunk`, which gives the bits of one pass; `philox.
fill_trunc_normal_ref`), CUDA tensors launch the kernels or raise;
`plain=True` forces the plain version for kernel-vs-plain checks.  The
routes agree to a few f32 ulps in z (csrc/philox.cuh), and given the same
z the update is the same arithmetic, rounding for rounding.  `shift` and
`scale` are one-element device tensors (the step's eps is one), read by
the kernel: no host sync.  The update is also the custom op
`repro_torch::noisy_sgd`, whose fake rule (`torch.empty_like(p)`: the
kernel allocates nothing else) is what `launch/dryrun.py` traces through
`card_route`; `bytes_flops` is its cost.  Launches are counted in
`noisy_sgd.launches` and `counter_trunc_normal.launches`, one a call.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build, philox
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need
from repro_torch.kernels.philox import Draw, Part

Tensor = torch.Tensor

# operations a kernel spends, for its bound: the thread instructions the
# kernels issue, from the SASS of their hot loops (`tools/sass_mix.py`, an
# H100 build of csrc/noisy_update.cu): the update with no noise 11 an
# element (loads, unpacking, add, rounding, multiply, subtract, pack,
# store, the loop's share); the noise's multiply, add and two roundings 6
# more (the z-given kernel: 17); a Philox4x32-10 call 42 (10 rounds of two
# 32 x 32 -> 64 products and two three-way xors) for 4 elements; a
# Box-Muller pair 91 (two uniforms, libdevice's logf, sqrtf and one range
# reduction for cosf and sinf, the products; the z-drawn kernel: 73 an
# element); the truncated normal 36 an element (the uniform, libdevice's
# erfinvf, the clamp and the scale, a store's share; 46.5 with its Philox)
PHILOX_OPS = 42
NORMAL_PAIR_OPS = 91
UPDATE_OPS = 11
NOISE_OPS = 6
TRUNC_OPS = 36
MODES = {"none": 0, "given": 1, "drawn": 2}


def _geometry(part: Part):
    """(nd, strides, offsets, lengths) as ctypes int64 arrays."""
    strides, off, lens = philox.collapse(part)
    need(len(lens) <= philox.MAX_DIMS,
         f"a part of {len(lens)} dims after merging (max "
         f"{philox.MAX_DIMS})")
    arr = ctypes.c_int64 * len(lens)
    return len(lens), arr(*strides), arr(*off), arr(*lens)


def _check(p, g, shift, scale, z, draw) -> None:
    need(isinstance(p, torch.Tensor) and isinstance(g, torch.Tensor),
         "noisy_sgd: p and g must be tensors")
    check_tensor("g", g, tuple(p.shape), (p.dtype,), p.device)
    need(p.dtype in DTYPE_CODES, f"noisy_sgd: dtype {p.dtype} is not one "
         f"of {list(DTYPE_CODES)}")
    need(shift.numel() == 1 and shift.dtype == g.dtype
         and shift.device == p.device,
         f"noisy_sgd: shift must be one {g.dtype} element on {p.device}")
    need(scale.numel() == 1 and scale.dtype == torch.float32
         and scale.device == p.device,
         f"noisy_sgd: scale must be one f32 element on {p.device}")
    need(z is None or draw is None, "noisy_sgd: z and draw exclude each "
         "other")
    if z is not None:
        check_tensor("z", z, tuple(p.shape), (torch.float32,), p.device)
    if draw is not None:
        need(tuple(draw.part.shape) == tuple(p.shape),
             f"noisy_sgd: the draw's part {tuple(draw.part.shape)} is not "
             f"p's shape {tuple(p.shape)}")


def noisy_sgd_ref(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
                  alpha: float, z: Optional[Tensor] = None,
                  draw: Optional[Draw] = None,
                  chunk: int = philox.DRAW_CHUNK) -> Tensor:
    """The plain update, `chunk` elements at a time: every op is
    elementwise and each z is a function of its global index, so the bits
    are those of one pass whatever the chunk, and the f32 transients stay
    a chunk's size."""
    out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    pf, gf, of = p.reshape(-1), g.reshape(-1), out.view(-1)
    zf = None if z is None else z.reshape(-1)
    for a in range(0, pf.numel(), chunk):
        c = slice(a, a + chunk)
        x = gf[c] + shift
        if zf is not None:
            x = x + (scale * zf[c]).to(g.dtype)
        elif draw is not None:
            zc = philox.normal_part(draw, a, min(chunk, pf.numel() - a),
                                    p.device)
            x = x + (scale * zc).to(g.dtype)
        of[c] = (pf[c].float() - alpha * x.float()).to(p.dtype)
    return out


def _launch_sgd(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
                alpha: float, z: Optional[Tensor], key: Optional[Tensor],
                leaf: int, part: Optional[Part]) -> Tensor:
    """The kernel on checked CUDA tensors: mode "drawn" when `part` is
    given (under `key`, the seed's 0-d int64 tensor on p's device), else
    "given" (z) or "none"."""
    out = torch.empty_like(p)
    if p.numel() == 0:
        return out
    mode = MODES["drawn" if part is not None else
                 "given" if z is not None else "none"]
    nd, strides, off, lens = _geometry(part if part is not None
                                       else Part.whole((p.numel(),)))
    dev = p.device.index
    err = _build.library("noisy_update").noisy_sgd(
        out.data_ptr(), p.data_ptr(), g.data_ptr(), shift.data_ptr(),
        scale.data_ptr(), None if z is None else z.data_ptr(), alpha, mode,
        None if part is None else key.data_ptr(), leaf & philox.MASK, nd,
        strides, off, lens, DTYPE_CODES[p.dtype],
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "noisy_sgd")
    noisy_sgd.launches += 1
    return out


@torch.library.custom_op("repro_torch::noisy_sgd", mutates_args=(),
                         device_types="cuda")
def _card_route(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
                z: Optional[Tensor], alpha: float, key: Optional[Tensor],
                leaf: int, full: List[int], offset: List[int]) -> Tensor:
    """`_launch_sgd` as an op: key the seed's 0-d int64 tensor, and `full`
    empty (key None) when nothing is drawn."""
    part = (Part(tuple(full), tuple(offset), tuple(p.shape)) if full
            else None)
    return _launch_sgd(p, g, shift, scale, alpha, z, key, leaf, part)


@_card_route.register_fake
def _card_route_fake(p, g, shift, scale, z, alpha, key, leaf, full,
                     offset):
    """The kernel allocates its output and nothing else."""
    return torch.empty_like(p)


def bytes_flops(part: Part, esize: int, mode: str) -> Tuple[int, int]:
    """(bytes, operations) of one update of a part of elements of `esize`
    bytes: p and g read once, the output written once (and z read, given);
    the Philox calls the part's rows need (`philox.philox_calls`), the
    normals and the update."""
    n = part.numel
    nbytes = 3 * n * esize + (4 * n if mode == "given" else 0)
    ops = (UPDATE_OPS + (NOISE_OPS if mode != "none" else 0)) * n
    if mode == "drawn":
        calls = philox.philox_calls(part)
        ops += calls * (PHILOX_OPS + 2 * NORMAL_PAIR_OPS)
    return nbytes, ops


def trunc_bytes_flops(part: Part, esize: int) -> Tuple[int, int]:
    """(bytes, operations) of one `counter_trunc_normal` fill: the part
    written once; its Philox calls and the transform."""
    n = part.numel
    return n * esize, philox.philox_calls(part) * PHILOX_OPS + TRUNC_OPS * n


def card_route(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
               alpha: float, *, z: Optional[Tensor] = None,
               draw: Optional[Draw] = None,
               chunk: Optional[int] = None) -> Tensor:
    """`noisy_sgd` through its op whatever the tensors' device: fake
    tensors take the op's fake rule, as `launch/dryrun.py` traces them
    (`chunk`, the plain version's, is taken and ignored)."""
    _check(p, g, shift, scale, z, draw)
    key = (philox.seed_tensor(draw.seed, p.device) if draw is not None
           else None)
    full, off = ((list(draw.part.full), list(draw.part.offset))
                 if draw is not None else ([], []))
    return _card_route(p, g, shift, scale, z, float(alpha), key,
                       draw.leaf if draw is not None else 0, full, off)


def noisy_sgd(p: Tensor, g: Tensor, shift: Tensor, scale: Tensor,
              alpha: float, *, z: Optional[Tensor] = None,
              draw: Optional[Draw] = None, chunk: Optional[int] = None,
              plain: bool = False) -> Tensor:
    """One leaf's part: p - alpha (g + shift + scale z), z drawn (`draw`,
    whose seed is an int or a one-element integer tensor: the kernel reads
    it on the device), given (`z`) or none; p, g contiguous of one dtype
    (f32 or bf16), shift one element of that dtype, scale one f32, alpha a
    float.  `chunk`: the plain version's elements at a time."""
    _check(p, g, shift, scale, z, draw)
    if p.device.type == "cpu" or plain:
        return noisy_sgd_ref(p, g, shift, scale, alpha, z, draw,
                             chunk or philox.DRAW_CHUNK)
    need(p.device.type == "cuda", f"noisy_sgd: unsupported device "
         f"{p.device}")
    if draw is None:
        return _launch_sgd(p, g, shift, scale, alpha, z, None, 0, None)
    return _launch_sgd(p, g, shift, scale, alpha, z,
                       philox.seed_tensor(draw.seed, p.device), draw.leaf,
                       draw.part)


noisy_sgd.launches = 0


def counter_trunc_normal(out: Tensor, seed: int, leaf: int, part: Part,
                         scale: float, *, plain: bool = False) -> Tensor:
    """out (the part of a leaf, contiguous, f32 or bf16) = the init's
    truncated normal on [-2, 2] at the part's global indices (purpose
    INIT), times `scale`, cast to out's dtype; returns out."""
    check_tensor("out", out, tuple(part.shape), DTYPE_CODES, out.device)
    if out.device.type == "cpu" or plain:
        return philox.fill_trunc_normal_ref(out, seed, leaf, part, scale)
    need(out.device.type == "cuda", f"counter_trunc_normal: unsupported "
         f"device {out.device}")
    if out.numel() == 0:
        return out
    nd, strides, off, lens = _geometry(part)
    k0, k1 = philox.key_of(seed)
    dev = out.device.index
    err = _build.library("noisy_update").counter_trunc_normal(
        out.data_ptr(), scale, philox.TN_LO, philox.TN_WIDTH, k0, k1,
        leaf & philox.MASK, nd, strides, off, lens, DTYPE_CODES[out.dtype],
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "counter_trunc_normal")
    counter_trunc_normal.launches += 1
    return out


counter_trunc_normal.launches = 0


def philox_raw(ctr: Tensor, key: Tensor, *, curand: bool = False
               ) -> Tensor:
    """ctr [n, 4] and key [n, 2] int32 (uint32 bits) on the card -> [n, 4]
    int32: the raw Philox4x32-10 words of csrc/philox.cuh or, `curand`,
    of the toolkit's `curand_Philox4x32_10` (csrc/philox_check.cu, a
    yardstick off the main path)."""
    n = ctr.shape[0]
    check_tensor("ctr", ctr, (n, 4), (torch.int32,), ctr.device)
    check_tensor("key", key, (n, 2), (torch.int32,), ctr.device)
    need(ctr.device.type == "cuda", "philox_raw runs on the card only")
    out = torch.empty_like(ctr)
    dev = ctr.device.index
    err = _build.library("philox_check").philox_raw(
        ctr.data_ptr(), key.data_ptr(), out.data_ptr(), n, int(curand),
        torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "philox_raw")
    return out

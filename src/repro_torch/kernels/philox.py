"""Counter-based draws by global index: the port's shard-local randomness.

The reference turns `jax_threefry_partitionable` on (`repro/launch/
dryrun.py:27`, `launch/train.py:19`, `launch/serve.py:15`), so a value of
`jax.random.normal(key, shape)` is a function of (key, global index)
whatever the layout, and each shard draws only its own elements
(`repro/core/aggregation.py:91-96`).  The port does the same with
Philox4x32-10 (Random123's rounds; `curand_Philox4x32_10`'s bits):

- key: the 64-bit stream seed as (lo32, hi32) (`key_of`): a Python int,
  or an integer tensor on the device (the train step's seed, as the
  reference passes `jnp.uint32(t)`), whose int64 words the kernels read
  from device memory, so that a captured step draws anew at each replay;
- counter: (q lo32, q hi32, leaf index, purpose), with q = j // 4 for the
  element's row-major index j in the leaf's WHOLE shape, purpose NOISE (0,
  the train step's noise), INIT (1, the weights) or GAINS (2, the train
  step's Rayleigh gains: leaf 0, j the worker index); the element takes
  output lane j % 4;
- uniform: u = ((x >> 9) + 0.5) * 2^-23, exact in f32, inside (0, 1);
- normal: Box-Muller on the lane pairs (0, 1) and (2, 3): r = sqrt(-2 ln
  u_a), then (r cos 2 pi u_b, r sin 2 pi u_b);
- truncated normal (the init): `torch.nn.init.trunc_normal_`'s transform
  on [-2, 2]: u spread over [2 Phi(-2) - 1, 2 Phi(2) - 1], erfinv, times
  sqrt 2, clamped.

So a value depends on (seed, leaf, purpose, global index) alone, never on
the layout, the chunking or the order of the draws.  The bits cannot be
threefry's: parity with the JAX package goes through replayed draws, and
the stream is held by its known answers and its statistics
(`tests/test_torch_draws.py`).

This module is the plain version, in torch int64 ops (each 32 x 32 -> 64
product wraps in int64; its high half is `(prod >> 32) & 0xFFFFFFFF`), on
any device; `csrc/philox.cuh` is the kernels' device function.  The two
routes agree to a few f32 ulps (logf, cosf, sinf, erfinvf differ), and a
route agrees with itself bitwise across layouts.  A `Part` is the box of a
leaf a rank holds; `collapse` merges its whole inner dims, so that a part
is rows of consecutive global indices, as the kernels walk it.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

M0, M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # key bumps (Weyl)
MASK = 0xFFFFFFFF
NOISE, INIT, GAINS = 0, 1, 2        # the counter's purpose word
U_STEP = 2.0 ** -23
TWO_PI = 2.0 * math.pi               # rounded to f32 where it multiplies
SQRT2 = math.sqrt(2.0)
# the truncated normal's uniform range [2 Phi(-2) - 1, 2 Phi(2) - 1], as
# the f32 constants both routes use
TN_LO = float(torch.tensor(math.erf(-2.0 / SQRT2), dtype=torch.float32))
TN_WIDTH = float(torch.tensor(2.0 * math.erf(2.0 / SQRT2),
                              dtype=torch.float32))
MAX_DIMS = 8                         # csrc/philox.cuh::MAX_DIMS
# elements a plain draw computes at once (its transients: a few int64
# tensors of a quarter of this length, f32 ones of this length)
DRAW_CHUNK = 2 ** 24


class Part(NamedTuple):
    """The box of a leaf a rank holds: the leaf's whole shape, where the
    box starts on each dim, and its shape."""
    full: Tuple[int, ...]
    offset: Tuple[int, ...]
    shape: Tuple[int, ...]

    @staticmethod
    def whole(shape: Sequence[int]) -> "Part":
        shape = tuple(int(n) for n in shape)
        return Part(shape, (0,) * len(shape), shape)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def slices(self) -> Tuple[slice, ...]:
        """The part as an index of the whole leaf."""
        return tuple(slice(o, o + n) for o, n in zip(self.offset,
                                                     self.shape))


class Draw(NamedTuple):
    """One leaf's part of a stream: the seed (an int, or a one-element
    integer tensor: `key_of`), the leaf index (the counter's third word)
    and the part."""
    seed: Union[int, Tensor]
    leaf: int
    part: Part


def key_of(seed) -> Tuple:
    """(lo32, hi32) of a seed taken modulo 2^64: ints of an int, int64
    tensors (0-d, on the seed's device) of a one-element integer tensor,
    read as int64 (two's complement: the same words as the int)."""
    if isinstance(seed, Tensor):
        s = seed.reshape(()).to(torch.int64)
        return s & MASK, (s >> 32) & MASK
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s & MASK, s >> 32


def seed_tensor(seed, device) -> Tensor:
    """The seed as a 0-d int64 tensor on `device`, whose two words are
    `key_of`'s (lo32, hi32): an int taken modulo 2^64 and filled in on the
    device (no host-to-device copy, so a CUDA graph may capture it, with
    the int), a tensor cast on its device (no copy when it already is
    one)."""
    if isinstance(seed, Tensor):
        return seed.reshape(()).to(device=device, dtype=torch.int64)
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.full((), s - (1 << 64) if s >> 63 else s,
                      dtype=torch.int64, device=device)


def split_part(full: Sequence[int], cuts) -> Part:
    """The part of a leaf of shape `full` a rank holds: `cuts` pairs each
    split dim (or None) with its axis (`.index`, `.size`)."""
    full = tuple(int(n) for n in full)
    off, shape = [0] * len(full), list(full)
    for dim, axis in cuts:
        if dim is not None:
            shape[dim] = full[dim] // axis.size
            off[dim] = axis.index * shape[dim]
    return Part(full, tuple(off), tuple(shape))


def local_part(shape: Sequence[int], cuts) -> Part:
    """The part whose shape is `shape` (a rank's shard): `cuts` pairs each
    split dim (or None) with its axis, whose index places it."""
    shape = tuple(int(n) for n in shape)
    full, off = list(shape), [0] * len(shape)
    for dim, axis in cuts:
        if dim is not None:
            full[dim] = shape[dim] * axis.size
            off[dim] = axis.index * shape[dim]
    return Part(tuple(full), tuple(off), shape)


def collapse(part: Part) -> Tuple[List[int], List[int], List[int]]:
    """(strides, offsets, lengths) of `part` with every dim merged into the
    one above it while the inner dim is whole (offset 0, the full length),
    so the last dim is the longest run of consecutive global indices; the
    strides are the merged whole shape's, row-major.  A 0-d leaf is one
    dim of 1."""
    dims = list(zip(part.full, part.offset, part.shape)) or [(1, 0, 1)]
    out = [dims[-1]]
    for f, o, n in reversed(dims[:-1]):
        fi, oi, ni = out[0]
        if oi == 0 and ni == fi:
            out[0] = (f * fi, o * fi, n * fi)
        else:
            out.insert(0, (f, o, n))
    strides, acc = [], 1
    for f, _, _ in reversed(out):
        strides.insert(0, acc)
        acc *= f
    return strides, [o for _, o, _ in out], [n for _, _, n in out]


def part_indices(part: Part, start: int, count: int, device,
                 step: int = 1) -> Tensor:
    """The global indices (int64) of the part's elements [start, start +
    count), every `step`-th, in its own row-major order."""
    strides, off, lens = collapse(part)
    n = lens[-1]
    e = torch.arange(start, start + count, step, dtype=torch.int64,
                     device=device)
    r, j = e // n, e % n + off[-1]
    for k in range(len(lens) - 2, -1, -1):
        j = j + (off[k] + r % lens[k]) * strides[k]
        r = r // lens[k]
    return j


def _mulhilo(a: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    prod = a * m                      # wraps in int64: the low 64 bits
    return (prod >> 32) & MASK, prod & MASK


def philox4x32(c0: Tensor, c1: Tensor, c2: Tensor, c3: Tensor, k0,
               k1) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Philox4x32-10 of the counters (int64 tensors holding uint32 words)
    under the key (k0, k1), ints or 0-d int64 tensors: the four output
    words, int64."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_at(seed, leaf: int, purpose: int, q: Tensor
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The four words of the counters (q lo, q hi, leaf, purpose) of q (an
    int64 tensor) under `seed`'s key (`key_of`)."""
    k0, k1 = key_of(seed)
    return philox4x32(q & MASK, q >> 32, torch.full_like(q, leaf & MASK),
                      torch.full_like(q, purpose & MASK), k0, k1)


def uniform(x: Tensor) -> Tensor:
    """f32 uniforms in (0, 1) of 32-bit words (int64)."""
    return ((x >> 9).float() + 0.5) * U_STEP


def _lanes(seed, leaf: int, purpose: int, j: Tensor, fn) -> Tensor:
    """fn(the four words) -> the four lanes' f32 values, at the counters
    of global indices j (int64), each j taking its lane."""
    lanes = torch.stack(fn(bits_at(seed, leaf, purpose, j >> 2)), dim=1)
    return lanes.gather(1, (j & 3)[:, None])[:, 0]


def _aligned(part: Part) -> bool:
    """Whether every 4 consecutive elements of the part from a multiple of
    4 share one counter: its rows are whole groups of 4 that start at j % 4
    == 0."""
    strides, off, lens = collapse(part)
    return lens[-1] % 4 == 0 and off[-1] % 4 == 0 and (
        len(lens) == 1 or strides[-2] % 4 == 0)


def _part_lanes(draw: "Draw", purpose: int, start: int, count: int, device,
                fn) -> Tensor:
    """fn's lane values at the part's elements [start, start + count), f32,
    flat; an aligned part computes one counter for 4 elements."""
    if not _aligned(draw.part):
        return _lanes(draw.seed, draw.leaf, purpose,
                      part_indices(draw.part, start, count, device), fn)
    a0 = start - start % 4
    nq = (start + count - a0 + 3) // 4
    q = part_indices(draw.part, a0, 4 * nq, device, step=4) >> 2
    lanes = torch.stack(fn(bits_at(draw.seed, draw.leaf, purpose, q)),
                        dim=1).view(-1)
    return lanes[start - a0:start - a0 + count]


def _box_muller(x) -> tuple:
    r01 = torch.sqrt(-2.0 * torch.log(uniform(x[0])))
    t01 = TWO_PI * uniform(x[1])
    r23 = torch.sqrt(-2.0 * torch.log(uniform(x[2])))
    t23 = TWO_PI * uniform(x[3])
    return (r01 * torch.cos(t01), r01 * torch.sin(t01),
            r23 * torch.cos(t23), r23 * torch.sin(t23))


def _trunc(x) -> tuple:
    return tuple(torch.clamp(torch.erfinv(uniform(w) * TN_WIDTH + TN_LO)
                             * SQRT2, -2.0, 2.0) for w in x)


def normal_at(seed, leaf: int, j: Tensor,
              purpose: int = NOISE) -> Tensor:
    """The standard normals (f32) at global indices j (int64)."""
    return _lanes(seed, leaf, purpose, j, _box_muller)


def trunc_normal_at(seed: int, leaf: int, j: Tensor,
                    purpose: int = INIT) -> Tensor:
    """The init's truncated normals on [-2, 2] (f32) at global indices j."""
    return _lanes(seed, leaf, purpose, j, _trunc)


def rayleigh_gains(seed, sigmas: Tensor) -> Tensor:
    """The train step's gains [U] on sigmas' device: worker u's uniform is
    the stream's (seed, leaf 0, purpose GAINS) at global index u, and
    |h_u| = sigma_u sqrt(2 E) with E = -ln u ~ Exp(1), the law of
    `core.channel.rayleigh_gains` (|h|^2 ~ Exp(mean 2 sigma^2)).  No host
    value is read, so a captured step draws anew whenever its seed
    tensor changes."""
    j = torch.arange(sigmas.shape[-1], dtype=torch.int64,
                     device=sigmas.device)
    u = _lanes(seed, 0, GAINS, j, lambda x: tuple(uniform(w) for w in x))
    return sigmas * torch.sqrt(2.0 * -torch.log(u))


def normal_part(draw: Draw, start: int, count: int, device) -> Tensor:
    """Elements [start, start + count) of the part's normals (purpose
    NOISE), f32, flat."""
    return _part_lanes(draw, NOISE, start, count, device, _box_muller)


def normal(draw: Draw, device, chunk: int = DRAW_CHUNK) -> Tensor:
    """The whole part's normals, f32, in the part's shape (for tests and
    the chip's comparisons; the train step never forms them)."""
    out = torch.empty(draw.part.numel, dtype=torch.float32, device=device)
    for a in range(0, out.numel(), chunk):
        n = min(chunk, out.numel() - a)
        out[a:a + n] = normal_part(draw, a, n, device)
    return out.view(draw.part.shape)


def fill_trunc_normal_ref(out: Tensor, seed: int, leaf: int, part: Part,
                          scale: float, chunk: Optional[int] = None
                          ) -> Tensor:
    """The plain `counter_trunc_normal`: out (the part, contiguous, f32 or
    bf16) = the init's truncated normal times `scale` (in f32), cast to its
    dtype, DRAW_CHUNK elements at a time."""
    chunk = chunk or DRAW_CHUNK
    flat = out.view(-1)
    for a in range(0, flat.numel(), chunk):
        n = min(chunk, flat.numel() - a)
        flat[a:a + n] = _part_lanes(Draw(seed, leaf, part), INIT, a, n,
                                    out.device, _trunc) * scale
    return out


def philox_calls(part: Part) -> int:
    """Philox calls a kernel makes for the part: one per q = j // 4 that
    meets a row of it (a misaligned row meets one more than n / 4)."""
    strides, off, lens = collapse(part)
    n, rows = lens[-1], math.prod(lens[:-1])
    if _aligned(part):
        return rows * (n // 4)
    if rows > 2 ** 20:   # many misaligned rows: the most they can need
        return rows * (n // 4 + 2)
    js = part_indices(part, 0, rows * n, "cpu", step=n)
    return int(((js + n - 1) // 4 - js // 4 + 1).sum())


def stream_seed(generator: torch.Generator) -> int:
    """One int64 drawn from `generator`: the init stream's seed, so that
    successive inits from one generator differ and ranks that seed it
    alike draw alike."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))

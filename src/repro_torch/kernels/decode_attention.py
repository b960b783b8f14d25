"""GQA decode-attention kernel (flash-decoding): one query token, long KV.

Wrapper around the CUDA C++ kernel of `csrc/decode_attention.cu`, which
replaces the Pallas kernel `repro/kernels/decode_attention.py::
decode_attention`: q [B, H, dh], k/v [B, S, KV, dh], pos -> [B, H, dh] in
q's dtype, with cache positions > pos masked out and the softmax online in
f32.  The serving path calls it once per layer per decode step
(`models/attention.py::decode_step`).

The kernel splits S over blocks (split-K) and combines the partial softmax
states in a second pass; `num_splits` picks the split count so that the
grid fills about one wave of resident blocks (the occupancy comes from the
kernel itself), and a short cache is one chunk and one pass.  In bf16 a
block takes all query heads of its KV head (up to 8, `HEADS_PER_BLOCK`),
streams K/V through a cp.async ring and forms both products on the tensor
cores; f32 keeps CUDA-core arithmetic.  `pos` may be a Python int or a 0-d
integer tensor on q's device; the kernel reads it on the device, so a
decode step that passes a device tensor needs no host sync.  Any pos >= 0
is in contract: the valid length is min(pos + 1, S), so a pos at or past
S attends every slot.  That is what a ring-buffer (windowed) cache of S
slots needs, whose decode step passes the token's true position
(`models/attention.py::decode_step`), and the plain version does the
same.  A negative pos is out of contract (a Python int raises; the kernel
attends nothing for a negative device pos).  The split count is planned
from S on the host and the chunks are cut from min(pos + 1, S) on the
device, so a 4096-slot ring at pos 524 287 is planned and cut as a
4096-position cache.

CPU tensors take the plain version (`kernels/ref.py::decode_attention_ref`),
CUDA tensors launch the kernel or raise; `plain=True` forces the plain
version for kernel-vs-plain tests.  Launches are counted per wrapper call in
`decode_attention.launches`, and by (B, S, H, KV, dh) in `.shapes`.  At bf16 the two routes differ by rounding:
the plain version rounds the scores and the probabilities to bf16, as the
JAX oracle does; the kernel keeps the scores in f32 and rounds the
probabilities to tf32 (10-bit mantissa) for the P.V product.  The input
checks build their messages only when one fails: on the serving path the
wrapper runs once per layer per decode step.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

HEAD_DIMS = (32, 64, 128)   # the kernel's template instances
# Query heads of one KV head per block: bf16 takes all of up to 8 (the
# tensor-core tile's N), so G <= 8 reads K/V once; f32 takes up to 4.
HEADS_PER_BLOCK = {torch.float32: 4, torch.bfloat16: 8}
MIN_CHUNK = 256             # fewest cache positions worth a chunk of its own
MAX_SPLITS = 1024           # grid.y stays far below its 65535 limit
WAVE_FILL = 0.9             # a grid's least share of one wave, and its last


@functools.lru_cache(maxsize=None)
def _resident_slots(device_index: int, dh: int, dtype_code: int) -> int:
    """Pass-1 blocks the card holds at once: blocks per SM x SMs."""
    per_sm = _build.library("decode_attention").decode_attention_occupancy(
        dh, dtype_code)
    need(per_sm > 0, f"decode_attention: occupancy query failed ({per_sm})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm * sms


@functools.lru_cache(maxsize=4096)
def num_splits(blocks_per_split: int, s_len: int, slots: int) -> int:
    """How many chunks to cut S into: the smallest count whose grid
    (blocks_per_split blocks per chunk) fills WAVE_FILL of the card's
    `slots` resident blocks, with its last wave WAVE_FILL full; failing
    that, the count with the fullest waves.  A chunk of a full cache keeps
    at least MIN_CHUNK positions, so a cache of fewer than 2 * MIN_CHUNK
    positions is one chunk and one pass (the serve shape, S = 64).  The
    bf16 kernel keeps two ring stages in flight per block, so one full
    wave saturates the card's bandwidth and more splits only add to the
    second pass, which costs a launch.  The chunks are cut from pos + 1
    on the device, so they shrink with pos."""
    n_max = max(1, min(MAX_SPLITS, s_len // MIN_CHUNK))
    best, best_fill = 1, 0.0
    for n in range(1, n_max + 1):
        blocks = blocks_per_split * n
        fill = blocks / (-(-blocks // slots) * slots)
        if blocks >= WAVE_FILL * slots and fill >= WAVE_FILL:
            return n
        if fill > best_fill:
            best, best_fill = n, fill
    return best


def launch_plan(b: int, h: int, kvh: int, s_len: int, dtype,
                slots: int) -> tuple:
    """(pass-1 blocks per chunk, chunks): one block per (batch row, KV head,
    group of HEADS_PER_BLOCK[dtype] query heads) and chunk."""
    per_block = HEADS_PER_BLOCK[dtype]
    blocks = b * kvh * -(-(h // kvh) // per_block)
    return blocks, num_splits(blocks, s_len, slots)


@functools.lru_cache(maxsize=4096)
def _plan(device_index: int, b: int, h: int, kvh: int, s_len: int, dh: int,
          dtype) -> tuple:
    """(n_split, workspace floats) for one launch shape on one card."""
    code = DTYPE_CODES[dtype]
    _, n = launch_plan(b, h, kvh, s_len, dtype,
                       _resident_slots(device_index, dh, code))
    return n, (b * h * n * (dh + 2) if n > 1 else 0)


def _pos_tensor(pos, device) -> Tensor:
    """pos as a one-element int32 tensor on `device` (no copy if it is
    one already)."""
    if isinstance(pos, torch.Tensor):
        if (pos.dtype == torch.int32 and pos.device == device
                and pos.numel() == 1):
            return pos
        need(pos.numel() == 1, f"pos must be a scalar, got shape "
             f"{tuple(pos.shape)}")
        need(pos.device == device and not pos.is_floating_point(),
             f"pos must be an integer tensor on {device}, got {pos.dtype} "
             f"on {pos.device}")
        return pos.to(torch.int32)
    return torch.tensor(int(pos), dtype=torch.int32, device=device)


def _check(q, k, v, pos) -> None:
    """Raise ValueError on anything the kernel does not take.  The
    messages are built only when a check fails."""
    if not (isinstance(q, torch.Tensor) and q.dim() == 3):
        raise ValueError("q must be a [B, H, dh] tensor")
    if not (isinstance(k, torch.Tensor) and k.dim() == 4):
        raise ValueError("k must be a [B, S, KV, dh] tensor")
    b, h, dh = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if not (kvh >= 1 and h % kvh == 0):
        raise ValueError(f"decode_attention: H={h} is not a multiple of "
                         f"KV={kvh}")
    if s_len < 1:
        raise ValueError("decode_attention: empty cache")
    check_tensor("q", q, (b, h, dh), DTYPE_CODES, q.device)
    check_tensor("k", k, (b, s_len, kvh, dh), (q.dtype,), q.device)
    check_tensor("v", v, (b, s_len, kvh, dh), (q.dtype,), q.device)
    if not isinstance(pos, torch.Tensor) and int(pos) < 0:
        raise ValueError(f"pos={pos} is negative")


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos, *,
                     plain: bool = False) -> Tensor:
    """q [B, H, dh]; k/v [B, S, KV, dh]; pos scalar >= 0 -> [B, H, dh]:
    the attention over slots [0, min(pos + 1, S))."""
    _check(q, k, v, pos)
    if q.device.type == "cpu" or plain:
        return ref.decode_attention_ref(q, k, v, pos)
    need((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0,
         "decode_attention: q, k and v must be 16-byte aligned")
    pos_t = _pos_tensor(pos, q.device)
    b, h, dh = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    dev = q.device.index
    n_split, ws_numel = _plan(dev, b, h, kvh, s_len, dh, q.dtype)
    out = torch.empty_like(q)
    ws = (torch.empty(ws_numel, dtype=torch.float32, device=q.device)
          if n_split > 1 else out)
    err = _build.library("decode_attention").decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, kvh, s_len, dh, n_split,
        DTYPE_CODES[q.dtype], torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    decode_attention.shapes[(b, s_len, h, kvh, dh)] += 1
    return out


decode_attention.launches = 0
decode_attention.shapes = collections.Counter()

"""GQA decode-attention kernel (flash-decoding): one query token, long KV.

Wrapper around the CUDA C++ kernel of `csrc/decode_attention.cu`, which
replaces the Pallas kernel `repro/kernels/decode_attention.py::
decode_attention`: q [B, H, dh], k/v [B, S, KV, dh], pos -> [B, H, dh] in
q's dtype, with cache positions > pos masked out and the softmax online in
f32.  The serving path calls it once per layer per decode step
(`models/attention.py::decode_step`).

The kernel splits S over blocks (split-K) and combines the partial softmax
states in a second pass; `num_splits` picks the split count so that the
grid fills whole waves of resident blocks (the occupancy comes from the
kernel itself).  `pos` may be a Python int or a 0-d integer tensor on q's
device; the kernel reads it on the device, so a decode step that passes a
device tensor needs no host sync.  pos must lie in [0, S) (positions past
S attend the whole cache; a negative pos is out of contract).

CPU tensors take the plain version (`kernels/ref.py::decode_attention_ref`),
CUDA tensors launch the kernel or raise; `plain=True` forces the plain
version for kernel-vs-plain tests.  Launches are counted per wrapper call in
`decode_attention.launches`.  At bf16 the two routes differ by bf16
rounding: the plain version rounds the scores and the probabilities to
bf16, as the JAX oracle does; the kernel keeps both in f32, as the Pallas
kernel does.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPE_CODES, check_tensor, need

Tensor = torch.Tensor

HEAD_DIMS = (32, 64, 128)   # the kernel's template instances
HEADS_PER_BLOCK = 4         # query heads of one KV head per block (GB)
MIN_CHUNK = 256             # fewest cache positions worth a block of its own
MAX_SPLITS = 1024           # grid.y stays far below its 65535 limit


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
    """How many chunks to cut S into.  The smallest count whose grid
    (blocks_per_split blocks per chunk) fills at least one wave of the
    card's `slots` resident blocks with its last wave at least 90 % full;
    failing that, the count with the fullest waves.  A chunk of a full
    cache keeps at least MIN_CHUNK positions, so a short cache is one chunk
    (and one pass).  The chunks are cut from pos + 1 on the device, so
    they shrink with pos."""
    n_max = max(1, min(MAX_SPLITS, s_len // MIN_CHUNK))
    best, best_fill = 1, 0.0
    for n in range(1, n_max + 1):
        blocks = blocks_per_split * n
        fill = blocks / (-(-blocks // slots) * slots)
        if blocks >= slots and fill >= 0.9:
            return n
        if fill > best_fill:
            best, best_fill = n, fill
    return best


def _pos_tensor(pos, device) -> Tensor:
    """pos as a one-element int32 tensor on `device` (no copy if it is
    one already)."""
    if isinstance(pos, torch.Tensor):
        need(pos.numel() == 1, f"pos must be a scalar, got shape "
             f"{tuple(pos.shape)}")
        need(pos.device == device and not pos.is_floating_point(),
             f"pos must be an integer tensor on {device}, got {pos.dtype} "
             f"on {pos.device}")
        return pos if pos.dtype == torch.int32 else pos.to(torch.int32)
    return torch.tensor(int(pos), dtype=torch.int32, device=device)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos, *,
                     plain: bool = False) -> Tensor:
    """q [B, H, dh]; k/v [B, S, KV, dh]; pos scalar -> [B, H, dh]."""
    need(isinstance(q, torch.Tensor) and q.dim() == 3,
         "q must be a [B, H, dh] tensor")
    need(isinstance(k, torch.Tensor) and k.dim() == 4,
         "k must be a [B, S, KV, dh] tensor")
    b, h, dh = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    need(q.device.type in ("cpu", "cuda"), f"unsupported device {q.device}")
    need(dh in HEAD_DIMS, f"decode_attention: head dim {dh} not in "
         f"{HEAD_DIMS}")
    need(kvh >= 1 and h % kvh == 0,
         f"decode_attention: H={h} is not a multiple of KV={kvh}")
    need(s_len >= 1, "decode_attention: empty cache")
    check_tensor("q", q, (b, h, dh), tuple(DTYPE_CODES), q.device)
    check_tensor("k", k, (b, s_len, kvh, dh), (q.dtype,), q.device)
    check_tensor("v", v, (b, s_len, kvh, dh), (q.dtype,), q.device)
    if not isinstance(pos, torch.Tensor):
        need(0 <= int(pos) < s_len,
             f"pos={pos} outside the cache [0, {s_len})")
    if q.device.type == "cpu" or plain:
        return ref.decode_attention_ref(q, k, v, pos)
    need(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
         "decode_attention: q, k and v must be 16-byte aligned")
    pos_t = _pos_tensor(pos, q.device)
    code = DTYPE_CODES[q.dtype]
    hgroups = -(-(h // kvh) // HEADS_PER_BLOCK)
    n_split = num_splits(b * kvh * hgroups, s_len,
                         _resident_slots(q.device.index, dh, code))
    out = torch.empty_like(q)
    ws = (torch.empty(b * h * n_split * (dh + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else out)
    err = _build.library("decode_attention").decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, kvh, s_len, dh, n_split, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

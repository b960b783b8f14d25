"""Host-to-device staging of the chunked sweep's batch blocks.

The counterpart of `repro/launch/mesh.py::stage_batch_block`:
`BlockStager.stage(block)` moves one host block (a dict of [C, ...] numpy
arrays) to the engine's device, floating data as float32, as
`as_device_array` stages the monolithic run's whole stack: every staging
gives the same bytes.  In a sharded sweep every rank stages the whole
(replicated) block to its own device with its own stager, where the
reference lands one block replicated over the mesh; a worker-sharded rank
then reads its workers' rows of it.

Synchronous staging is a pageable copy on the compute stream: the host waits
for it, and it waits for the rounds already enqueued.  Asynchronous staging
(the plan's `async_staging`) lets block k+1's copy overlap chunk k's rounds:

  1. the host writes the block into one of two page-locked (pinned) host
     buffers, alternating, so block k+2 never overwrites the buffer whose
     copy of block k+1 may still be in flight (the host waits on that
     buffer's previous copy first);
  2. a side `torch.cuda.Stream` allocates the device block and copies into
     it with `non_blocking=True`, then records an event;
  3. `StagedBlock.ready()` makes the compute stream wait on that event
     before round t0 reads the block, and `record_stream` tells the caching
     allocator that the compute stream uses the block, so its memory is
     not handed to a later block before the compute stream is done with it.

Pinning never falls back to a pageable copy: a buffer that is not pinned
raises.  On the CPU staging is a plain copy and `async_staging` changes
nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def as_device_array(x, device) -> Tensor:
    """Host array -> tensor on `device`, floating data as float32 (what
    `jnp.asarray` gives the JAX engine: the synthetic digits are float64
    under NumPy 2's promotion rules)."""
    x = np.array(x)   # a writable copy: torch refuses read-only buffers
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    return torch.as_tensor(x, device=device)


def _staged_dtype(dtype: np.dtype) -> np.dtype:
    return np.dtype(np.float32) if np.issubdtype(dtype, np.floating) \
        else dtype


class StagedBlock:
    """One block on the device: `tensors` (name -> [C, ...]) and, when it
    came through the side stream, the event its copy recorded."""

    def __init__(self, tensors: Dict[str, Tensor],
                 event: Optional["torch.cuda.Event"] = None):
        self.tensors = tensors
        self.event = event

    def ready(self) -> Dict[str, Tensor]:
        """The block, with the current stream ordered after its copy."""
        if self.event is not None:
            device = next(iter(self.tensors.values())).device
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.event)
            for t in self.tensors.values():
                t.record_stream(stream)
            self.event = None
        return self.tensors


class BlockStager:
    """Stages [C, ...] batch blocks to `device`; `async_staging` takes the
    pinned double buffer and the side stream on a CUDA device."""

    def __init__(self, device, async_staging: bool = False):
        self.device = torch.device(device)
        self.async_staging = async_staging and self.device.type == "cuda"
        self._stream = None
        self._buffers: List[Optional[Dict[str, Tensor]]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        if self.async_staging:
            self._stream = torch.cuda.Stream(self.device)

    def stage(self, block: Dict[str, np.ndarray]) -> StagedBlock:
        if not self.async_staging:
            return StagedBlock({k: as_device_array(v, self.device)
                                for k, v in block.items()})
        slot, self._slot = self._slot, 1 - self._slot
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()   # its last copy has landed
        pinned = self._pinned(slot, block)
        for k, v in block.items():
            np.copyto(pinned[k][:len(v)].numpy(), v, casting="unsafe")
        with torch.cuda.stream(self._stream):
            out = {k: pinned[k][:len(v)].to(self.device, non_blocking=True)
                   for k, v in block.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return StagedBlock(out, event)

    def _pinned(self, slot: int, block: Dict[str, np.ndarray]
                ) -> Dict[str, Tensor]:
        """The slot's pinned buffers, (re)allocated when a block outgrows
        them; a buffer that is not page-locked raises."""
        bufs = self._buffers[slot]
        if bufs is None or any(
                k not in bufs or bufs[k].shape[1:] != v.shape[1:]
                or bufs[k].shape[0] < v.shape[0]
                or bufs[k].numpy().dtype != _staged_dtype(v.dtype)
                for k, v in block.items()):
            bufs = {}
            for k, v in block.items():
                dt = torch.from_numpy(
                    np.empty(0, _staged_dtype(v.dtype))).dtype
                bufs[k] = torch.empty(v.shape, dtype=dt, pin_memory=True)
                if not bufs[k].is_pinned():
                    raise RuntimeError(
                        f"async staging: the host buffer of {k!r} "
                        f"({tuple(v.shape)}) could not be page-locked")
            self._buffers[slot] = bufs
        return bufs

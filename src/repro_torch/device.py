"""Device choice shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry point's device.  'cuda' without a card raises: the port
    never falls back to the CPU on its own (pass device='cpu' for that)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions "
                "on the CPU")
        if dev.index is None:   # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

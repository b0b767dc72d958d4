"""The device an entry point of the port runs on.

The drivers default to the card (``device="cuda"``); the CPU is taken
only when the caller names it. There is no fallback: without a CUDA
device, a CUDA device raises.
"""
from __future__ import annotations

import torch

from .errors import ZenError


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device, a bare 'cuda' resolved to the current
    CUDA device; raises ZenError naming ``device="cpu"`` when a CUDA
    device is asked for and none exists."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise ZenError(
            f"device {str(device)!r}: torch.cuda.is_available() is False; pass "
            'device="cpu" to run on the CPU (no fallback)'
        )
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())

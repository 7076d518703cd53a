"""Where the port runs, and the one rule for capturing CUDA graphs."""
from __future__ import annotations

import threading

import torch

# torch.cuda.graph shares one capture stream unless given one, and a
# capture is the one window in which another thread's CUDA calls matter:
# the engine and the measured tuner capture one graph at a time
CAPTURE_LOCK = threading.Lock()


def resolve_device(device) -> torch.device:
    """``device`` as given, else the card; no card and no ``device``
    raises rather than running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card by default; pass "
            "device=\"cpu\" to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")

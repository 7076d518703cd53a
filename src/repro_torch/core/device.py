"""Where the port runs, and the one rule for capturing CUDA graphs."""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

# torch.cuda.graph shares one capture stream unless given one, and a
# capture is the one window in which another thread's CUDA calls matter:
# the engine, the LM steps and the measured tuner capture one graph at a
# time
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


@contextlib.contextmanager
def capture(graph, *, stream, pool=None):
    """Capture ``graph`` on ``stream`` (``thread_local`` mode, so other
    threads may use the card meanwhile) under ``CAPTURE_LOCK``, with
    Python's cyclic garbage collector off. A collection inside the capture
    runs the finalizers of objects dropped before it (a dropped engine's
    pinned buffers, events and streams) in the capturing thread, where
    their CUDA calls are not permitted; a finalizer swallows the error and
    the capture fails later, far from the cause. With the collector off,
    that garbage is collected after the capture."""
    with CAPTURE_LOCK:
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                yield
        finally:
            if enabled:
                gc.enable()

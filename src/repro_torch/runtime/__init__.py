"""Runtime fault tolerance (``repro/runtime``): the restart loop, the
straggler watch and the transient-error type; and the span recorder
(``runtime/trace.py``). The fault-tolerance names load on first use, so
importing ``repro_torch.runtime.trace`` (as the engine does) pulls in no
mesh or sharding module."""
import importlib

_FAULT_TOLERANCE = ("StragglerWatch", "TransientFailure", "resilient_train")


def __getattr__(name):
    if name in _FAULT_TOLERANCE:
        module = importlib.import_module("repro_torch.runtime.fault_tolerance")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

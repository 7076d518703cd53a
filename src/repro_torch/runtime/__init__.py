"""Runtime fault tolerance (``repro/runtime``): the transient-error type
for now; the restart loop comes with training."""
from repro_torch.runtime.fault_tolerance import TransientFailure  # noqa: F401

"""Runtime fault tolerance (``repro/runtime``): the restart loop, the
straggler watch and the transient-error type."""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    StragglerWatch,
    TransientFailure,
    resilient_train,
)

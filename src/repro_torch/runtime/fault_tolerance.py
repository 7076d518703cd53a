"""Fault tolerance (``repro/runtime/fault_tolerance.py``): the
transient-error type. ``resilient_train``, the straggler watch and the
checkpoint helpers come with training (ROADMAP queue 5)."""


class TransientFailure(Exception):
    """The repo-wide transient-error type: the serving tier retries
    exactly this class of dispatch and build fault (``serving.resilience``
    re-exports it); anything else is treated as persistent."""

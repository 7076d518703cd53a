"""``queue_wait_ms.<cell kind>``: the mean ms a traced request waits
from its arrival to the start of the dispatch that takes it (the
batching window, the device scheduler's queue and the hand-off), over
the traced window's ``repro_torch.request`` spans that reached a
dispatch, from the program's span recorder. A program counter; None
where the program has no recorder, where no such request was traced, or
where the recorder dropped spans."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    waits = [s["dispatch_ns"] - s["start_ns"] for s in snap["spans"]
             if s["name"] == "repro_torch.request"
             and s.get("dispatch_ns") is not None]
    if snap["dropped"] or not waits:
        return None
    return sum(waits) / len(waits) / 1e6

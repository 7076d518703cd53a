"""``dispatch_copy_in_ms.<cell kind>``: the ms a traced dispatch spends
copying its requests' images from host memory to the card one by one
(its ``repro_torch.dispatch.copy_in`` span), summed over the traced
window's ``repro_torch.dispatch`` spans and divided by them, from the
program's span recorder. A program counter; None where the program has
no recorder, where no dispatch was traced, or where the recorder dropped
spans."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    dispatches = {s["id"] for s in snap["spans"]
                  if s["name"] == "repro_torch.dispatch"}
    if snap["dropped"] or not dispatches:
        return None
    copy_ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
                  if s["name"] == "repro_torch.dispatch.copy_in"
                  and s["parent"] in dispatches)
    return copy_ns / len(dispatches) / 1e6

"""``copy_in_us.<cell kind>``: the µs the engine spends copying an image
from host memory to the card, from the program's span recorder: the
``repro_torch.engine.copy_in`` spans inside the traced window's root
``repro_torch.engine.run`` spans, summed, over those roots. A program
counter; None where the program has no recorder, where no root was
traced, or where the recorder dropped spans."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    roots = {s["id"] for s in snap["spans"]
             if s["name"] == "repro_torch.engine.run" and not s["parent"]}
    if snap["dropped"] or not roots:
        return None
    copy_ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
                  if s["name"] == "repro_torch.engine.copy_in"
                  and s["parent"] in roots)
    return copy_ns / len(roots) / 1e3

"""``launch_us.<cell kind>``: the µs of a root ``repro_torch.engine.run``
span that its ``repro_torch.engine.copy_in`` does not cover (the checks,
the lock, the graph's lookup, the copy into its input, the replay's
launch and the clone of its logits), summed over the traced window's
roots and divided by them, from the program's span recorder. A program
counter; None where the program has no recorder, where no root was
traced, or where the recorder dropped spans."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    roots = {s["id"]: s["end_ns"] - s["start_ns"] for s in snap["spans"]
             if s["name"] == "repro_torch.engine.run" and not s["parent"]}
    if snap["dropped"] or not roots:
        return None
    copy_ns = sum(s["end_ns"] - s["start_ns"] for s in snap["spans"]
                  if s["name"] == "repro_torch.engine.copy_in"
                  and s["parent"] in roots)
    return (sum(roots.values()) - copy_ns) / len(roots) / 1e3

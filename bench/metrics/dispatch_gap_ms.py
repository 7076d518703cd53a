"""``dispatch_gap_ms.<cell kind>``: the ms between one traced dispatch
and the next that no ``repro_torch.dispatch`` span covers (resolving
the last batch's futures, forming the next, the hand-off to the thread
that runs it): from the first traced dispatch's start to the last's
end, the time outside every dispatch span, over the gaps between them
(dispatches less one), from the program's span recorder. A program
counter; None where the program has no recorder, where fewer than two
dispatches were traced, or where the recorder dropped spans."""


def read(run):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    spans = sorted((s["start_ns"], s["end_ns"]) for s in snap["spans"]
                   if s["name"] == "repro_torch.dispatch")
    if snap["dropped"] or len(spans) < 2:
        return None
    covered, reach = 0, spans[0][0]
    for start, end in spans:
        if end > reach:
            covered += end - max(start, reach)
            reach = end
    idle_ns = reach - spans[0][0] - covered
    return idle_ns / (len(spans) - 1) / 1e6

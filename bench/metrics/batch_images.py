"""``batch_images.<cell kind>``: the mean images a dispatch of the
untraced window carried, from the batcher's ``batch_histogram`` (the
dispatches counted in that window). A program counter."""


def read(run):
    hist = run.counters.get("batch_histogram")
    if not hist:
        return None
    dispatches = sum(hist.values())
    return sum(int(b) * n for b, n in hist.items()) / dispatches

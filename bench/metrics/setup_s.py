"""``setup_s``: seconds from process start to the first timed request
(imports, the card, the kernel library, weights, tuning, graph capture
and warm-up of the cell's shapes). Host clock."""


def read(run):
    return run.setup_s

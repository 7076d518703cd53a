"""``device_ops.<cell kind>``: device operations (kernels, copies, sets)
in the traced window per image completed in it."""


def read(run):
    t, rec = run.trace, run.traced
    if t is None or not t.device_ops or not rec.completed:
        return None
    return t.device_ops / rec.completed

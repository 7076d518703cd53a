"""``image_ms``: the window's milliseconds over the images completed in
it, each image counted from the call to its logits in host memory.
Host clock; closed loop of one client."""


def read(run):
    rec = run.record
    if not rec.completed:
        return None
    return rec.window_s / rec.completed * 1e3

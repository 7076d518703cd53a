"""``served_images_per_s``: answers in host memory inside the window,
over the window's seconds. Host clock; closed loop with a fixed number of
requests in flight."""


def read(run):
    rec = run.record
    if not rec.window_s:
        return None
    return rec.completed / rec.window_s

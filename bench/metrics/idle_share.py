"""``idle_share.<cell kind>``: the share of the traced window in which
no operation ran on the device (one minus the union of device activity
over the window). Percent."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

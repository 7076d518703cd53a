"""``mfu.<cell kind>``: the whole request's share of the chip's peak.
The operations of one request (the configuration's reference counts them:
for a CNN, 2 x the multiply-adds of every conv site and the classifier,
from the published layer shapes) times the requests completed in the
untraced window, over that window by the host clock, against the peak of
the configuration's dtype (H100 SXM at 700 W: 67 TFLOP/s fp32). Percent."""


def read(run):
    rec = run.record
    if run.peaks is None or not rec.window_s or not rec.completed:
        return None
    rate = run.ref.flops(run.config) * rec.completed / rec.window_s
    return 100.0 * rate / run.peaks[run.config["dtype"]]

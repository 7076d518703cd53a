"""``conv_roofline.<cell kind>``: the conv sites' least time over the
device's busy time, per image. A site's least time is the larger of its
operations over the dtype's peak and its bytes (input, filter and output,
each once) over 3.35 TB/s; the busy time is the union over streams of
every device operation in the traced window, over the images completed in
it. The sites are the reference's (``sites(cfg)``). Percent."""
from bench.harness import counts


def read(run):
    t, rec = run.trace, run.traced
    if t is None or not t.busy_s or run.peaks is None or not rec.completed:
        return None
    least = counts.conv_roofline_s(run.ref.sites(run.config),
                                   run.config["dtype"], run.peaks)
    return 100.0 * least / (t.busy_s / rec.completed)

"""``image_p95_ms``: the 95th percentile (nearest rank) of every image's
latency in the window, from the call to its logits in host memory. Host
clock."""
from bench.harness.stats import percentile


def read(run):
    p = percentile(run.record.latencies_s, 95)
    return None if p is None else p * 1e3

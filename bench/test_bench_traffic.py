"""The traffic drivers, the trace's arithmetic, and the percentile."""
import numpy as np
import pytest
import torch

from bench.harness import manifest
from bench.harness.stats import percentile
from bench.harness.trace import Tracer, summarize, union


class _Echo:
    """A system that answers each image with its first pixels."""

    def run(self, image):
        return torch.as_tensor(image).reshape(-1)[:4].clone()

    def submit(self, image):
        from concurrent.futures import Future
        f = Future()
        f.set_result(self.run(image))
        return f

    def result(self, ticket, timeout):
        return ticket.result(timeout)


@pytest.mark.parametrize("mix", [
    {"driver": "one_client", "system": "engine", "pool": 4},
    {"driver": "closed", "system": "server", "outstanding": 5, "pool": 4}])
def test_drivers_answer_every_request_once(mix):
    pool = np.arange(4 * 8, dtype=np.float32).reshape(4, 2, 2, 2)
    rec = manifest.driver(mix).drive(_Echo(), pool, mix, 0.2, 7,
                                     Tracer(False))
    assert rec.attempted == len(rec.answers) > 0
    assert rec.completed == len(rec.latencies_s)
    assert not rec.errors and not rec.missing
    for k, y in rec.answers:
        assert torch.equal(y, torch.from_numpy(pool[k]).reshape(-1)[:4])


def test_union_and_summary():
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    ev = [("bench.window", "span", 0, 100),
          ("bench.engine.run", "span", 0, 60),
          ("bench.copy_out", "span", 60, 100),
          ("k1", "device", 10, 30), ("k2", "device", 20, 40),
          ("k1", "device", 70, 80), ("early", "device", -50, -10)]
    t = summarize(ev)
    assert t.window_s == 100e-9 and t.busy_s == 40e-9
    assert t.device_ops == 3
    assert t.top_ops[0] == ["k1", 30e-9]
    assert t.idle_gaps[0] == ["engine.run", 30e-9]  # 40..70
    assert summarize([("k", "device", 0, 1)]) is None


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95 and percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0 and percentile([], 95) is None

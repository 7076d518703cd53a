"""The five readers of the program's span recorder: each gives the value
its definition gives on a made-up snapshot, and None where the program
has no recorder, where the recorder holds no traced root, and where it
dropped spans; a traced run of each kind of cell on the CPU reports
them."""
import sys
import time

import pytest

from bench.harness import manifest
from bench.harness.runner import run_cell

MS = 1_000_000  # ns


def _span(name, sid, parent, start, end, **extra):
    return {"name": f"repro_torch.{name}", "id": sid, "parent": parent,
            "group": sid, "thread": 1, "start_ns": start, "end_ns": end,
            **extra}


SPANS = [
    # two engine.run roots, 1,000 and 2,000 ns, with copy-ins of 300, 500
    _span("engine.copy_in", 2, 1, 100, 400),
    _span("engine.run", 1, 0, 0, 1_000),
    _span("engine.copy_in", 4, 3, 2_000, 2_500),
    _span("engine.run", 3, 0, 2_000, 4_000),
    # three dispatches: 2-5, 6-9 and 9.5-12 ms, copy-ins 0.8, 0.6, 1.0 ms,
    # the second a batch of one (its engine.run takes the copied image, so
    # it has no engine.copy_in); the engine's spans inside are not roots
    _span("dispatch.copy_in", 11, 10, 2 * MS, 2.8 * MS),
    _span("engine.run_batch", 12, 10, 2.9 * MS, 4 * MS),
    _span("dispatch", 10, 0, 2 * MS, 5 * MS, requests=[31, 32], padded=2),
    _span("dispatch.copy_in", 21, 20, 6 * MS, 6.6 * MS),
    _span("engine.run", 22, 20, 6.7 * MS, 8 * MS),
    _span("dispatch", 20, 0, 6 * MS, 9 * MS, requests=[33], padded=1),
    _span("dispatch.copy_in", 41, 40, 9.5 * MS, 10.5 * MS),
    _span("dispatch", 40, 0, 9.5 * MS, 12 * MS, requests=[], padded=1),
    # requests waiting 2 and 4 ms, and one shed before any dispatch
    _span("request", 50, 0, 0, 5 * MS, dispatch_ns=2 * MS),
    _span("request", 51, 0, 1 * MS, 5 * MS, dispatch_ns=5 * MS),
    _span("request", 52, 0, 1 * MS, 3 * MS, dispatch_ns=None),
]
EXPECTED = {
    "copy_in_us.single": (300 + 500) / 2 / 1e3,
    "launch_us.single": (1_000 + 2_000 - 800) / 2 / 1e3,
    "queue_wait_ms.serve_closed": (2 + 4) / 2,
    "dispatch_copy_in_ms.serve_closed": (0.8 + 0.6 + 1.0) / 3,
    "dispatch_gap_ms.serve_closed": (1 + 0.5) / 2,
}
NEW = sorted(EXPECTED)


def _snapshot(spans, dropped=0):
    return {"spans": spans, "dropped": dropped, "totals": {},
            "anchor": {"perf_counter_ns": 0, "time_ns": 0}}


@pytest.fixture
def recorder(monkeypatch):
    from repro_torch.runtime import trace

    def plant(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)
    return plant


@pytest.mark.parametrize("name", NEW)
def test_reader_value(name, recorder):
    recorder(_snapshot(SPANS))
    assert manifest.metric_reader(name)(None) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no_root", "dropped", "no_recorder"])
def test_reader_none(name, case, recorder, monkeypatch):
    if case == "no_root":
        # only what no reader counts as its root: a shed request, an
        # engine.run inside a dispatch
        recorder(_snapshot([SPANS[-1], SPANS[8]]))
    elif case == "dropped":
        recorder(_snapshot(SPANS, dropped=1))
    else:  # a program without the recorder module
        import repro_torch.runtime

        monkeypatch.delattr(repro_torch.runtime, "trace", raising=False)
        monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert manifest.metric_reader(name)(None) is None


@pytest.mark.parametrize("cell, overrides, seconds", [
    ("resnet18.single", {"config": {"image_size": 32},
                         "mix": {"pool": 4}}, 0.3),
    # batches of 4 and a second's window: dispatches enough for a gap
    # between two of them on a loaded host
    ("resnet18.serve_closed", {"config": {"image_size": 32},
                               "mix": {"pool": 4, "outstanding": 4}}, 1.0),
])
def test_traced_run_reports_them(cell, overrides, seconds):
    from repro_torch.runtime import trace

    trace.reset()
    result = run_cell(cell, 2 ** 31 + 7, seconds, True,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=overrides)
    mf = manifest.Manifest()
    want = {m["name"] for m in mf.metrics(mf.cell(cell), "per_layer")} \
        & set(NEW)
    assert want and want <= set(result["metrics"])
    assert trace.snapshot()["dropped"] == 0

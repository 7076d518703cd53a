"""Every entry of BENCHMARK.json resolves to its files by name, and the
manifest keeps to the benchmark's contract on names and sizes."""
import json
import re

import pytest

from bench.harness import manifest

MF = manifest.Manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    d = MF.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["bench"]
    assert d["command"] == ["python3", "bench/run.py"]
    assert 1 <= d["run_seconds"] <= 51
    assert (manifest.ROOT / "bench" / "run.py").exists()


@pytest.mark.parametrize("cell", sorted(MF.cells))
def test_cell_resolves(cell):
    w = MF.cell(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = MF.config(w)
    assert cfg["name"] == w["config"]
    ref = manifest.reference(cfg)
    for hook in ("draw", "inputs", "judge", "flops", "sites"):
        assert callable(getattr(ref, hook))
    mix = manifest.traffic(w["traffic"])
    assert callable(manifest.driver(mix).drive)
    assert callable(manifest.system(mix).build)
    for kind in ("end_to_end", "per_layer"):
        for m in MF.metrics(w, kind):
            assert callable(manifest.metric_reader(m["name"]))
    e2e = {m["name"] for m in MF.metrics(w, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert MF.metrics(w, "per_layer")


@pytest.mark.parametrize("entry", MF.data["configs"],
                         ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("bench/configs/")
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert 0 < cfg["limits"]["logit_rel_err"] < 1e-3


def test_names_units_and_metric_keys():
    names = [c["name"] for c in MF.data["configs"]] + list(MF.cells)
    metrics = MF.data["end_to_end"] + MF.data["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in MF.data["end_to_end"]}
    for m in MF.data["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in MF.data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:  # each reports what the metric moves
            assert m["moves"] in {x["name"] for x in
                                  MF.metrics(MF.cell(cell), "end_to_end")}


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in MF.cells.values()}
    assert used == set(MF.configs)
    pairs = [(w["config"], w["traffic"]) for w in MF.cells.values()]
    assert len(pairs) == len(set(pairs))

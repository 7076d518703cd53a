"""Operation counts from the published layer shapes, and the reference's
conv sites against the program's."""
import json

import pytest

from bench.harness import counts, manifest

CONFIGS = {"resnet18": 1.82e9, "mobilenet_v2": 3.0e8}


def _cfg(name):
    return json.loads((manifest.BENCH / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_macs_match_published(name):
    cfg = _cfg(name)
    ref = manifest.reference(cfg)
    head = ref.head_width(cfg) * cfg["num_classes"]
    macs = counts.conv_macs(ref.sites(cfg)) + head
    assert macs == pytest.approx(CONFIGS[name], rel=0.01)
    assert cfg["published_macs"] == CONFIGS[name]
    assert ref.flops(cfg) == 2 * macs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sites_match_program(name):
    """The reference's sites are the program's conv sites, with the same
    geometry: the counts read the work the program does."""
    from repro_torch.configs import get
    from repro_torch.models.registry import cnn_module

    cfg = _cfg(name)
    ref = manifest.reference(cfg)
    pcfg = get(cfg["program_config"])
    theirs = {n: s for n, s in cnn_module(pcfg).conv_specs(pcfg)}
    ours = {s["name"]: s for s in ref.sites(cfg)}
    assert ours.keys() == theirs.keys()
    for n, s in ours.items():
        t = theirs[n]
        assert (s["h"], s["w"], s["cin"], s["cout"], s["r"], s["s"],
                s["stride"]) == (t.h, t.w, t.c, t.k, t.r, t.s, t.stride)
        assert s["groups"] == t.groups


def test_roofline_is_bound_by_operations_for_resnet():
    cfg = _cfg("resnet18")
    ref = manifest.reference(cfg)
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    t = counts.conv_roofline_s(ref.sites(cfg), "float32", peaks)
    ops_only = 2 * counts.conv_macs(ref.sites(cfg)) / peaks["float32"]
    assert ops_only <= t < 1.1 * ops_only


def test_site_bytes_count_each_tensor_once():
    site = {"r": 3, "s": 3, "cin": 4, "cout": 8, "groups": 1, "h": 5,
            "w": 5, "ho": 5, "wo": 5}
    assert counts.site_bytes(site, 4) == 4 * (5 * 5 * 4 + 9 * 4 * 8
                                              + 5 * 5 * 8)
    assert counts.site_macs(site) == 9 * 4 * 8 * 25

"""The plain reference against the program's CPU engine on the same
weights at a small image size, and the TF32 rounding of the control."""
import json

import pytest
import torch

from bench.harness import manifest
from bench.reference.common import round_tf32, same_pads
from bench.systems.cnn_program import folded


def _cfg(name, size):
    cfg = json.loads((manifest.BENCH / "configs" / f"{name}.json")
                     .read_text())
    return {**cfg, "image_size": size}


@pytest.mark.parametrize("name,size", [("resnet18", 32), ("mobilenet_v2", 32),
                                       ("resnet18", 40)])
def test_reference_matches_program_cpu_engine(name, size):
    cfg = _cfg(name, size)
    ref = manifest.reference(cfg)
    weights = ref.draw(cfg, 2 ** 31 + 7, "cpu")
    images = ref.inputs(cfg, 3, 2 ** 31 + 7)
    engine = {"system": "engine"}
    system = manifest.system(engine).build(cfg, engine, weights, "cpu")
    got = torch.stack([system.run(img) for img in images])
    want = ref.logits(weights, cfg, torch.from_numpy(images))
    err = ((got - want).abs().amax(1) / want.abs().amax(1)).max().item()
    assert err < cfg["limits"]["logit_rel_err"] / 10
    control = ref.logits(weights, cfg, torch.from_numpy(images), "tf32")
    cerr = ((control - want).abs().amax(1)
            / want.abs().amax(1)).max().item()
    assert cerr > cfg["limits"]["logit_rel_err"]


def test_weights_repeat_for_a_seed_and_fold():
    cfg = _cfg("resnet18", 32)
    ref = manifest.reference(cfg)
    a = ref.draw(cfg, 5, "cpu")
    b = ref.draw(cfg, 5, "cpu")
    c = ref.draw(cfg, 6, "cpu")
    assert torch.equal(a["s1b0"]["proj"]["w"], b["s1b0"]["proj"]["w"])
    assert not torch.equal(a["stem"]["w"], c["stem"]["w"])
    f = folded(a, cfg["bn_eps"])["s0b1"]["c2"]
    bn = a["s0b1"]["c2"]
    x = torch.randn(10, bn["w"].shape[-1])
    unfolded = (x - bn["mean"]) / torch.sqrt(bn["var"] + cfg["bn_eps"]) \
        * bn["gamma"] + bn["beta"]
    torch.testing.assert_close(x * f["scale"] + f["bias"], unfolded)
    assert (ref.inputs(cfg, 2, 9) == ref.inputs(cfg, 2, 9)).all()


def test_round_tf32_keeps_ten_mantissa_bits_ties_to_even():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 4, one + 3 * ulp / 4, one + ulp / 2,
                      one + 3 * ulp / 2, -(one + 3 * ulp / 4), 0.0, 3.0])
    want = torch.tensor([one, one + ulp, one, one + 2 * ulp,
                         -(one + ulp), 0.0, 3.0])
    assert torch.equal(round_tf32(x), want)


def test_same_pads_split_low_first():
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(224, 3, 2) == (0, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)

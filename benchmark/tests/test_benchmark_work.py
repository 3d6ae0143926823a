"""The analytic counts against the published ones, and the leaves the
harness hands out against the program's model."""

import json
import os

import pytest

from benchmark.work import resnet as work

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def config(name: str) -> dict:
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,params,gmacs", [
    ("resnet50", 25_557_032, 4.1),  # He et al. Table 1 (v1.5: 4.1 G)
    ("resnet152", 60_192_808, 11.5),
])
def test_published_counts(name, params, gmacs):
    c = config(name)
    assert work.param_count(c) == params == c["parameters"]
    assert work.forward_macs(c) / 1e9 == pytest.approx(gmacs, rel=0.01)
    assert work.train_flops(c, 1) == 6 * work.forward_macs(c)


def test_batch_norm_bytes_count_five_tensors():
    c = config("resnet50")
    bns = [l for l in work.layers(c) if l["kind"] == "bn"]
    assert len(bns) == 53  # 49 convs on the path, 4 shortcuts
    elems = sum(l["channels"] * l["hout"] ** 2 for l in bns)
    assert work.bn_train_bytes(c, 3, 2) == 5 * elems * 3 * 2


@pytest.mark.parametrize("name", ["resnet50", "resnet152"])
def test_leaves_match_the_program(name):
    from mgwfbp_tpu_torch import models as zoo

    c = config(name)
    model, _ = zoo.create_model(c["program_model"],
                                dataset=c["program_dataset"])
    program = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert program == [(n, s) for n, s, _ in work.params(c)]

"""The plain reference against the program's ResNets on the same seeded
weights, at a small image size on the CPU in float32; and the reference's
independence from the program."""

import ast
import json
import os

import pytest
import torch

from benchmark import weights
from benchmark.reference import resnet as ref
from benchmark.work import resnet as work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["resnet50", "resnet152"])
def test_reference_matches_the_program(name):
    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.train.step import forward_loss

    c = config(name)
    cpu = torch.device("cpu")
    w = weights.make_weights(work.params(c), 7, cpu)
    model, _ = zoo.create_model(c["program_model"],
                                dataset=c["program_dataset"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    x, y = weights.make_batches(1, 2, 3, 64, 1000, 7, 0, cpu)
    model.train()
    loss, _, _ = forward_loss(model, "classify", x[0, 0], y[0, 0])
    loss.backward()
    ref_loss, grads = ref.loss_and_grads(c, w, x[0, 0], y[0, 0])
    torch.testing.assert_close(loss.detach(), ref_loss, rtol=1e-5, atol=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-4, atol=1e-6)


def test_sgd_step_is_torchs():
    """The reference's update is torch.optim.SGD's with coupled decay on
    leaves of rank 2 and more."""
    opt = {"lr": 0.1, "momentum": 0.875, "weight_decay": 1e-3}
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g)}
    tp = {k: torch.nn.Parameter(v.clone()) for k, v in p.items()}
    sgd = torch.optim.SGD([{"params": [tp["w"]], "weight_decay": 1e-3},
                           {"params": [tp["b"]], "weight_decay": 0.0}],
                          lr=0.1, momentum=0.875)
    bufs = {}
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        ref.sgd_step(p, bufs, grads, opt)
        for k in tp:
            tp[k].grad = grads[k].clone()
        sgd.step()
    for k in p:
        torch.testing.assert_close(p[k], tp[k].detach())


def test_fp8_control_rounds_coarser_than_bfloat16():
    t = torch.linspace(-3, 3, 1001)
    q = ref._round_fp8(t, torch.float8_e4m3fn, ref.E4M3_MAX)
    bf = t.to(torch.bfloat16).float()
    assert (q - t).abs().max() > 4 * (bf - t).abs().max()


def test_reference_imports_nothing_of_the_program():
    """By its source (imports) and by what importing it loads."""
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "mgwfbp_tpu",
                       "mgwfbp_tpu_torch"}

"""Whole runs of the harness on the CPU at the small cell's size (the look
for a card skipped with ``--device cpu``): a sound run comes out correct
and prints its result as the contract says; with the timed path broken
underneath (``--fault``) it comes out not correct, once for each fault a
training cell can have; the fp8 control fails the limits the program
passes. And on the card, at a committed cell's own size, the control."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import check, drive, spec, weights
from conftest import ROOT, SMALL


def run(root: str, cell: str, *extra: str, seed: int = 3_000_000_021):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "1", "--trace", "0", "--device", "cpu",
         *extra], cwd=root, capture_output=True, text=True, timeout=600)
    return proc


def result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_sound_run_is_correct_and_well_formed(small_root):
    r = result(run(small_root, f"{SMALL}.b8.1rank"))
    assert r["correct"] is True
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"images_per_s", "step_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell,fault", [
    (f"{SMALL}.b8.1rank", "unchanged"),
    (f"{SMALL}.b8.1rank", "half_batch"),
    (f"{SMALL}.b8.2rank", "no_exchange"),
])
def test_planted_fault_is_not_correct(small_root, cell, fault):
    r = result(run(small_root, cell, "--fault", fault))
    assert r["correct"] is False, r["checks"]


def test_no_result_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark."""
    root = tmp_path / "bare"
    root.mkdir()
    subprocess.run(["cp", "-r", os.path.join(ROOT, "benchmark"),
                    os.path.join(ROOT, "BENCHMARK.json"), str(root)],
                   check=True)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "resnet50.b256.1card", "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def control_gaps(cell: spec.Cell, seed: int, device: torch.device) -> dict:
    """The check's numbers of the fp8 reference in the program's place."""
    c, t = cell.config, cell.traffic
    x, y = weights.make_batches(drive.CHECK_STEPS, int(t["batch_per_card"]),
                                int(c["in_channels"]), int(c["image_size"]),
                                int(c["num_classes"]), seed, 0, device)

    def feed(i):
        return x[i], y[i]

    ref = drive.reference_check(cell, seed, feed, device, 1)
    ctrl = drive.reference_check(cell, seed, feed, device, 1, quant="fp8")
    return check.numbers(ctrl, ref)


def test_control_fails_the_small_limits(small_root):
    cell = spec.load_cell(small_root, f"{SMALL}.b8.1rank",
                          bench_dir=os.path.join(small_root, "benchmark"))
    for seed in (1, 2):
        ok, rows = check.judge(control_gaps(cell, seed, torch.device("cpu")),
                               cell.limits)
        assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet50.b256.1card",
                                  "resnet152.b128.1card"])
def test_control_fails_the_cell_limits_on_the_card(cuda, name):
    cell = spec.load_cell(ROOT, name)
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        ok, rows = check.judge(control_gaps(cell, seed, torch.device("cuda")),
                               cell.limits)
        assert not ok, rows

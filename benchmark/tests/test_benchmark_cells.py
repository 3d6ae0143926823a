"""A cell, a configuration, a traffic mix, a limits file, a per-layer
metric and a kernel family are found once their files and entries are
added, with no edit to a file the benchmark has."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec
from conftest import ROOT, SMALL, SMALL_LIMITS


def test_committed_cells_load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for w in doc["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        assert cell.ranks == cell.chips == w["chips"]
        assert cell.limits, f"{w['name']} has no limits file"
        names = {m["name"] for m in cell.per_layer}
        assert any(n.startswith("mfu_pct") for n in names)
        assert ("comm_exposed_ms" in names) == (cell.chips > 1)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert {m["moves"] for m in cell.per_layer} <= reported
        for m in cell.per_layer + cell.end_to_end:
            assert callable(spec.metric_reader(m["name"]))


def test_added_cells_are_found(small_root):
    for ranks in (1, 2):
        cell = spec.load_cell(small_root, f"{SMALL}.b8.{ranks}rank",
                              bench_dir=os.path.join(small_root, "benchmark"))
        assert cell.config["image_size"] == 64
        assert cell.traffic["batch_per_card"] == 8
        assert cell.limits == SMALL_LIMITS
        assert ("collectives_per_step" in {m["name"] for m in cell.per_layer}
                ) == (ranks > 1)


def test_added_metric_and_family_are_found(small_root, tmp_path):
    """A new reader and a new kernel family, read by the copy's harness."""
    root = str(tmp_path / "checkout")
    subprocess.run(["cp", "-r", small_root, root], check=True)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "metrics", "transpose_share.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.family('layout')['patterns'][0]\n")
    with open(os.path.join(bench, "kernels", "pool.json"), "w") as f:
        json.dump({"why": "test", "patterns": ["max_pool"]}, f)
    doc_path = os.path.join(root, "BENCHMARK.json")
    with open(doc_path) as f:
        doc = json.load(f)
    doc["per_layer"].append({"name": "transpose_share", "unit": "%",
                             "better": "lower", "source": "device_trace",
                             "layer": "models convolution kernels",
                             "moves": "images_per_s"})
    with open(doc_path, "w") as f:
        json.dump(doc, f)
    code = (
        "import sys, types; sys.path.insert(0, '.')\n"
        "from benchmark import spec\n"
        f"cell = spec.load_cell('.', '{SMALL}.b8.1rank')\n"
        "assert 'transpose_share' in [m['name'] for m in cell.per_layer]\n"
        "ctx = types.SimpleNamespace(family=spec.kernel_family)\n"
        "print(spec.metric_reader('transpose_share')(ctx),"
        " sorted(spec.kernel_families()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True).stdout
    assert out.split()[0] == "nchwToNhwc"
    assert "pool" in out


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no.such.cell")

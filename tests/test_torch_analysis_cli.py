"""``python -m mgwfbp_tpu_torch.analysis``, the port's analysis CLI (the
counterpart of ``python -m mgwfbp_tpu.analysis``).

The shipped tree exits 0 with the step pass on the CPU (``--device cpu``;
the default observes on the card, and without one is TRC000), and its
static passes alone (``--skip-step``) in well under 15 s. Each family bit
comes out for a seeded violation: JIT 1 (a wall clock in a compiled
function), SCH 2 (the guard's count moved out of its range, in the step
pass's own children), RUN 4 (a primary-gated barrier), ANA 8 (a dead
suppression), TRC 16 (a model the pass cannot build; no card), THR 32 (an
unlocked buffer shared with a thread). The ``--json`` document has the JAX
CLI's keys, and ANA001 runs only when every consuming pass ran."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from mgwfbp_tpu_torch.analysis import spmd_check
from mgwfbp_tpu_torch.analysis.__main__ import main
from mgwfbp_tpu_torch.analysis.rules import FAMILY_BITS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_STEP = ["--policies", "wfbp", "--comm-ops", "all_reduce"]

JIT_SEED = (
    "import time, torch\nfrom functools import partial\n"
    "@partial(torch.compile)\ndef f(x):\n    return x + time.time()\n"
)
RUN_SEED = (
    "from mgwfbp_tpu_torch.runtime import coordination as coord\n"
    "def f():\n"
    "    if coord.is_primary():\n"
    "        coord.barrier('x')\n"
)
ANA_SEED = "def f():\n    x = 1  # mgwfbp: noqa[JIT001] -- stale\n    return x\n"
THR_SEED = (
    "import threading\n"
    "class Buf:\n"
    "    def __init__(self):\n"
    "        self._rows = []\n"
    "        self._t = threading.Thread(target=self._drain)\n"
    "        self._t.start()\n"
    "    def _drain(self):\n"
    "        while True:\n"
    "            self._rows.pop()\n"
    "    def push(self, x):\n"
    "        self._rows.append(x)\n"
)
# loaded by the step pass's children (PYTHONPATH): the guard's count runs
# outside its finite_check range, as a step that lost the range would
SCH_SEED = (
    "import torch\n"
    "from mgwfbp_tpu_torch.train import step\n"
    "def unscoped(tensors):\n"
    "    flat = torch.cat([t.reshape(-1) for t in tensors])\n"
    "    return torch.count_nonzero(~torch.isfinite(flat)).float()\n"
    "step.nonfinite_count = unscoped\n"
)


def _run(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _seed(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    return str(p)


def test_shipped_tree_exits_zero_on_the_cpu(capsys):
    rc, out, err = _run(capsys, ["--device", "cpu"])
    assert rc == 0, out + err
    assert "0 error(s)" in err


def test_static_passes_exit_zero_fast():
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.analysis", "--skip-step"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    dt = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert dt < 15.0, f"--skip-step took {dt:.1f} s"


def test_jit_bit(tmp_path, capsys):
    bad = _seed(tmp_path, "bad.py", JIT_SEED)
    rc, out, _ = _run(capsys, ["--skip-step", "--skip-spmd", bad])
    assert rc == FAMILY_BITS["JIT"] == 1
    assert "JIT001" in out


def test_sch_bit(tmp_path, capsys, monkeypatch):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(SCH_SEED)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site), ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    rc, out, err = _run(capsys, ["--skip-lint", "--skip-thr", "--skip-spmd",
                                 "--device", "cpu"] + ONE_STEP)
    assert rc == FAMILY_BITS["SCH"] == 2, out + err
    assert "SCH008" in out


def test_run_bit(tmp_path, capsys, monkeypatch):
    bad = _seed(tmp_path, "protocol.py", RUN_SEED)
    # the RUN pass's targets are package-relative; an absolute path joins
    # as itself
    monkeypatch.setattr(spmd_check, "DEFAULT_TARGETS",
                        spmd_check.DEFAULT_TARGETS + (bad,))
    rc, out, _ = _run(capsys, ["--skip-step", "--json"])
    doc = json.loads(out)
    assert rc == doc["exit_code"] == FAMILY_BITS["RUN"] == 4
    assert doc["errors_by_family"] == {"RUN": 1}
    run = [f for f in doc["findings"] if f["rule"] == "RUN001"]
    assert run[0]["file"] == bad and run[0]["line"] == 3
    # the shipped tree's thread-safe pins ride along, marked suppressed
    assert any(f["suppressed"] and f["family"] == "THR"
               for f in doc["findings"])


def test_ana_bit(tmp_path, capsys):
    dead = _seed(tmp_path, "dead.py", ANA_SEED)
    rc, out, _ = _run(capsys, ["--skip-step", dead])
    assert rc == FAMILY_BITS["ANA"] == 8
    assert "ANA001" in out and "JIT001" in out


@pytest.mark.parametrize("skip", ["--skip-lint", "--skip-thr",
                                  "--skip-spmd"])
def test_ana001_off_when_a_consuming_pass_is_skipped(tmp_path, capsys, skip):
    dead = _seed(tmp_path, "dead.py", ANA_SEED)
    rc, out, _ = _run(capsys, ["--skip-step", skip, dead])
    assert rc == 0 and "ANA001" not in out


@pytest.mark.parametrize("argv", [
    ["--model", "no_such_model", "--device", "cpu"] + ONE_STEP,
    ["--device", "cuda"] + ONE_STEP,
], ids=["unbuildable_model", "no_card"])
def test_trc_bit(capsys, argv):
    import torch

    if "cuda" in argv and torch.cuda.is_available():
        argv = ["--model", "no_such_model", "--device", "cuda"] + ONE_STEP
    rc, out, err = _run(capsys, ["--skip-lint", "--skip-thr",
                                 "--skip-spmd"] + argv)
    assert rc == FAMILY_BITS["TRC"] == 16, out + err
    assert "TRC000" in out


def test_thr_bit(tmp_path, capsys):
    bad = _seed(tmp_path, "race.py", THR_SEED)
    rc, out, _ = _run(capsys, ["--skip-step", "--skip-lint", "--skip-spmd",
                               bad])
    assert rc == FAMILY_BITS["THR"] == 32
    assert "THR001" in out


def test_json_keys_equal_the_jax_document(tmp_path, capsys):
    from mgwfbp_tpu.analysis.__main__ import main as jax_main

    bad = _seed(tmp_path, "bad.py", JIT_SEED)
    jax_bad = _seed(tmp_path, "jax_bad.py", JIT_SEED.replace(
        "torch.compile", "jax.jit").replace("import time, torch",
                                            "import time, jax"))
    jax_rc = jax_main(["--skip-jaxpr", "--skip-spmd", "--skip-thr", "--json",
                       jax_bad])
    jax_doc = json.loads(capsys.readouterr().out)
    rc, out, _ = _run(capsys, ["--skip-step", "--skip-spmd", "--skip-thr",
                               "--json", bad])
    doc = json.loads(out)
    assert list(doc) == list(jax_doc)
    assert rc == doc["exit_code"] == jax_rc == 1
    assert doc["errors_by_family"] == jax_doc["errors_by_family"]
    assert [list(f) for f in doc["findings"]] == [
        list(f) for f in jax_doc["findings"]]
    assert [(f["rule"], f["line"]) for f in doc["findings"]] == [
        (f["rule"], f["line"]) for f in jax_doc["findings"]]


def test_flags_mirror_the_jax_cli(capsys):
    from mgwfbp_tpu.analysis.__main__ import main as jax_main

    def flags(entry) -> set:
        with pytest.raises(SystemExit):
            entry(["--help"])
        out = capsys.readouterr().out
        return {w.rstrip(",") for w in out.split() if w.startswith("--")}

    port, jax = flags(main), flags(jax_main)
    assert port - jax == {"--skip-step", "--device"}
    assert jax - port == {"--skip-jaxpr"}

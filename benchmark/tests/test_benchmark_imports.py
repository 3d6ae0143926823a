"""No process of the benchmark loads JAX or the JAX package, compared by
the whole top-level name (the program's name begins with the JAX
package's); the reference loads nothing of the program."""

import subprocess
import sys
import types

from benchmark import drive
from conftest import ROOT

HARNESS = ("benchmark.run", "benchmark.calibrate", "benchmark.drive",
           "benchmark.check", "benchmark.trace", "benchmark.spec",
           "benchmark.weights", "benchmark.faults", "benchmark.work.resnet",
           "benchmark.reference.resnet")


def loaded_tops(imports: list[str]) -> set[str]:
    code = ("import importlib, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(out.split())


def test_harness_and_program_load_no_jax():
    tops = loaded_tops(list(HARNESS) + [
        "mgwfbp_tpu_torch.train.trainer", "mgwfbp_tpu_torch.parallel.mesh",
        "mgwfbp_tpu_torch.models"])
    assert "mgwfbp_tpu_torch" in tops
    assert not tops & set(drive.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = loaded_tops(["benchmark.reference.resnet", "benchmark.weights",
                        "benchmark.work.resnet"])
    assert not tops & (set(drive.FORBIDDEN) | {"mgwfbp_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mgwfbp_tpu_torch_like",
                        types.ModuleType("mgwfbp_tpu_torch_like"))
    before = drive.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mgwfbp_tpu.models",
                        types.ModuleType("mgwfbp_tpu.models"))
    assert drive.forbidden_modules() == sorted(set(before) | {"mgwfbp_tpu"})

"""The benchmark's description, found by name: ``BENCHMARK.json`` at the
root of the checkout lists the cells and metrics; each piece sits in a
file of its own under ``benchmark/``:

  * a configuration: the ``file`` its ``configs`` entry names;
  * a traffic mix: ``traffic/<name>.json``;
  * a metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns a number
    or None (nothing to read);
  * a kernel family: ``kernels/<name>.json`` (name patterns);
  * the analytic work and the plain reference of a model family:
    ``work/<family>.py`` and ``reference/<family>.py``;
  * the limits of the correctness check of a cell: ``limits/<cell>.json``.

So a cell, a configuration, a traffic mix or a metric is added by files and
entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # metric entries it reports with --trace 1
    limits: dict

    @property
    def ranks(self) -> int:
        return int(self.traffic["ranks"])


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    key lists or, without one, every cell reporting what it moves (a
    per-layer metric) or every cell (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    if int(traffic["ranks"]) != int(w["chips"]):
        raise ValueError(f"{name}: traffic {w['traffic']!r} runs "
                         f"{traffic['ranks']} ranks on {w['chips']} chips")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    limits = _load_json(limits_path)["limits"] if os.path.exists(
        limits_path) else {}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                limits=limits)


def metric_reader(name: str, bench_dir: str = HERE):
    """``read(ctx)`` of ``metrics/<name>.py`` (a name may hold dots: the
    file is loaded by its path)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def family_module(kind: str, family: str):
    """``work.<family>`` or ``reference.<family>``."""
    return importlib.import_module(f"benchmark.{kind}.{family}")


def kernel_family(name: str, bench_dir: str = HERE) -> dict:
    """``{"patterns": [...], "exclude": [...]}`` of ``kernels/<name>.json``:
    a kernel belongs to the family when its name holds one of the patterns
    and none of the exclusions."""
    return _load_json(os.path.join(bench_dir, "kernels", f"{name}.json"))


def kernel_families(bench_dir: str = HERE) -> dict:
    """Every family of ``kernels/``, by name."""
    return {f[:-5]: kernel_family(f[:-5], bench_dir)
            for f in sorted(os.listdir(os.path.join(bench_dir, "kernels")))
            if f.endswith(".json")}


def peaks(bench_dir: str = HERE) -> dict:
    return _load_json(os.path.join(bench_dir, "peaks.json"))

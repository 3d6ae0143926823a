"""The port's bench when the card does not come up (``mgwfbp_tpu_torch.
bench``, counterpart of ``bench.py``'s ``ChipUnavailable`` path).

  * with CUDA's initialisation forced to time out (``preflight_backend``
    raising ``DeadlineExceeded``), the bench retries it a bounded number of
    times, then prints a ``skipped: "chip unavailable"`` payload and exits
    0; it never measures on the CPU instead;
  * with ``MGWFBP_TELEMETRY_DIR`` set it appends a ``bench_skip`` record
    that the JAX reader and schema accept, the same event the JAX bench
    writes, and the JAX aggregator counts it
    (``mgwfbp_bench_skips_total``);
  * ``MGWFBP_FAULT_PLAN=chip_unavailable`` takes the same path in a
    subprocess, and its payload has the JAX bench's keys and values but
    the free-text ``detail``;
  * any other failure of the start-up (no card at all) is not an outage:
    an ``error`` payload and rc 1, as before.
"""

import json
import os
import subprocess
import sys

from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu.telemetry.export import prometheus_text
from mgwfbp_tpu_torch import bench
from mgwfbp_tpu_torch.telemetry import export
from mgwfbp_tpu_torch.utils import platform
from mgwfbp_tpu_torch.utils.platform import DeadlineExceeded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_timed_out_init_is_a_structured_skip(tmp_path, monkeypatch, capsys):
    calls = []

    def hung(timeout_s=None, device="cuda"):
        calls.append(device)
        raise DeadlineExceeded("CUDA initialisation exceeded 1s deadline")

    def no_grid(*a, **kw):
        raise AssertionError("the bench measured without a card")

    monkeypatch.setattr(platform, "preflight_backend", hung)
    monkeypatch.setattr(bench, "run_bench", no_grid)
    monkeypatch.setattr(bench, "INIT_RETRY_DELAYS_S", (0.0,))
    monkeypatch.setenv("MGWFBP_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    assert bench.main([]) == 0
    assert calls == ["cuda"] * 3
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["skipped"] == "chip unavailable"
    assert payload["value"] is None and "error" not in payload
    assert "3 attempts" in payload["detail"]
    path = str(tmp_path / "telemetry.jsonl")
    rows = jax_events.read_events(path)
    assert [r["event"] for r in rows] == ["header", "bench_skip"]
    assert rows[0]["run"] == {"source": "bench"}
    assert rows[1]["detail"] == payload["detail"]
    for r in rows:
        assert all(k in r for k in jax_events.EVENT_TYPES[r["event"]])
    text = prometheus_text(rows)
    assert "mgwfbp_bench_skips_total 1" in text
    assert text == export.prometheus_text(rows)


def test_a_card_that_answers_on_a_retry_runs_the_grid(monkeypatch, capsys):
    calls = []

    def flaky(timeout_s=None, device="cuda"):
        calls.append(device)
        if len(calls) < 2:
            raise DeadlineExceeded("first attempt timed out")
        return ["cuda:0"]

    monkeypatch.setattr(platform, "preflight_backend", flaky)
    monkeypatch.setattr(bench, "INIT_RETRY_DELAYS_S", (0.0,))
    monkeypatch.setattr(bench, "run_bench", lambda device: {
        "metric": "m", "value": 1.0})
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    assert bench.main([]) == 0 and len(calls) == 2
    assert json.loads(capsys.readouterr().out)["value"] == 1.0


def _run(cmd, tmp_path, tel) -> tuple[int, dict]:
    env = dict(os.environ, PYTHONPATH=ROOT, MGWFBP_FAULT_PLAN="chip_unavailable",
               MGWFBP_TELEMETRY_DIR=str(tel), JAX_PLATFORMS="cpu")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    return res.returncode, json.loads(res.stdout.strip().splitlines()[-1])


def test_fault_plan_skip_matches_the_jax_bench(tmp_path):
    rc, ours = _run([sys.executable, "-m", "mgwfbp_tpu_torch.bench"],
                    tmp_path, tmp_path / "port")
    jrc, theirs = _run([sys.executable, "bench.py"], tmp_path,
                       tmp_path / "jax")
    assert rc == jrc == 0
    assert set(ours) == set(theirs)
    assert {k: v for k, v in ours.items() if k != "detail"} == {
        k: v for k, v in theirs.items() if k != "detail"}
    assert "chip_unavailable" in ours["detail"]
    for d in ("port", "jax"):
        rows = jax_events.read_events(str(tmp_path / d / "telemetry.jsonl"))
        assert [r["event"] for r in rows] == ["header", "bench_skip"]


def test_no_card_at_all_is_an_error_not_a_skip(monkeypatch, capsys):
    def absent(timeout_s=None, device="cuda"):
        raise RuntimeError("no CUDA device is available")

    monkeypatch.setattr(platform, "preflight_backend", absent)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    assert bench.main([]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert "no CUDA device" in payload["error"] and "skipped" not in payload

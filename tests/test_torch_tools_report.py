"""The port's report tools (``mgwfbp_tpu_torch/tools/telemetry_report.py``,
``telemetry_merge.py``, ``autotune_report.py``) against the JAX package's
``tools/`` scripts of the same names, on what a port run wrote.

One short CPU run of the port's ``train_cli`` at 2 gloo ranks (LeNet,
``--telemetry``, ``--autotune`` with a schedule cache, async checkpoints)
writes two per-process streams and one cache entry. On them:

  * ``telemetry_report`` prints the JAX tool's text for each stream, and
    its ``--chrome-trace`` and ``--prometheus`` files are the JAX tool's
    bytes; the one difference in the printed text is the two output paths,
    which name each tool's own files;
  * ``telemetry_merge --out`` writes the JAX tool's timeline bytes and
    prints its report (one timeline, one row per process); its straggler
    table has the fleet fan-in's semantics (``telemetry/fleet.py``);
  * ``autotune_report`` prints the JAX tool's report of the cache entry,
    naming the winner and every raced label;
  * the live page and the fleet page render a replay of the stream as the
    JAX tool renders the same documents; the port's ``--selftest`` passes;
  * every port tool runs in a subprocess under ``tools.nojax`` (JAX, Flax,
    optax, orbax and the JAX package refused) and exits 0; the JAX tool
    under the same refusal fails.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import autotune_report as jax_autotune_report
import telemetry_merge as jax_telemetry_merge
import telemetry_report as jax_telemetry_report
from mgwfbp_tpu_torch.runtime.supervisor import free_port
from mgwfbp_tpu_torch.telemetry import read_event_set
from mgwfbp_tpu_torch.tools import (
    autotune_report,
    nojax,
    telemetry_merge,
    telemetry_report,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two gloo ranks of ``train_cli``: their tag directory and the cache
    entry of the race."""
    d = str(tmp_path_factory.mktemp("tools_run"))
    port = free_port()
    args = [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
            "lenet", "--synthetic", "--device", "cpu", "--batch-size", "8",
            "--epochs", "1", "--num-batches-per-epoch", "10", "--autotune",
            "--autotune-steps", "2", "--schedule-cache",
            os.path.join(d, "cache"), "--telemetry", "--logdir",
            os.path.join(d, "logs"), "--checkpoint-dir",
            os.path.join(d, "ckpt"), "--ckpt-every-steps", "3"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                   MGWFBP_NUM_PROCESSES="2", MGWFBP_PROCESS_ID=str(rank))
        env.pop("MGWFBP_FAULT_PLAN", None)
        procs.append(subprocess.Popen(
            args, env=env, cwd=d, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(d, f"p{rank}.log"), "w")))
    try:
        codes = [p.wait(timeout=RUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0], open(os.path.join(d, "p0.log")).read()[-3000:]
    (tag,) = os.listdir(os.path.join(d, "logs"))
    (entry,) = os.listdir(os.path.join(d, "cache"))
    return os.path.join(d, "logs", tag), os.path.join(d, "cache", entry)


def _main(fn, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("proc", [0, 1])
def test_telemetry_report_and_exports_are_the_jax_tools(run, tmp_path, proc):
    tag, _ = run
    stream = os.path.join(tag, f"telemetry.p{proc}.jsonl")
    records = read_event_set(stream)
    text = telemetry_report.format_report(records)
    assert text == jax_telemetry_report.format_report(records)
    assert "overlap efficiency" in text and "autotune commit" in text
    outs = {}
    for name, mod in (("port", telemetry_report),
                      ("jax", jax_telemetry_report)):
        trace = str(tmp_path / f"{name}.trace.json")
        prom = str(tmp_path / f"{name}.prom")
        rc, printed = _main(mod.main, [stream, "--chrome-trace", trace,
                                       "--prometheus", prom])
        assert rc == 0
        with open(trace, "rb") as f, open(prom, "rb") as g:
            outs[name] = (printed.replace(trace, "TRACE").replace(
                prom, "PROM"), f.read(), g.read())
    assert outs["port"] == outs["jax"]
    json.loads(outs["port"][1])  # the trace parses
    assert b"mgwfbp_steps_total 10" in outs["port"][2]


def test_telemetry_merge_is_the_jax_tools(run, tmp_path):
    tag, _ = run
    got = str(tmp_path / "port.jsonl")
    want = str(tmp_path / "jax.jsonl")
    rc, printed = _main(telemetry_merge.main, [tag, "--out", got])
    assert rc == 0
    assert _main(jax_telemetry_merge.main, [tag, "--out", want]) == (
        0, printed)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    assert "2 stream(s), 2 process(es)" in printed
    rows = [line.split() for line in printed.splitlines()[3:]]
    assert [r[0] for r in rows] == ["0", "1"]
    merged = [json.loads(line) for line in open(got)]
    telemetry_merge.check_monotonic(merged)
    table = telemetry_merge.straggler_table(merged)
    assert table == jax_telemetry_merge.straggler_table(merged)
    assert [r["steps"] for r in table] == [10, 10]


def test_merge_table_has_the_fleet_tables_semantics(tmp_path):
    """The merge's post-hoc straggler table and the fleet fan-in's live one
    (``telemetry/fleet.straggler_table``) agree on the same steps: each
    process's mean step and its excess over the fastest process."""
    from mgwfbp_tpu_torch.telemetry import EventWriter
    from mgwfbp_tpu_torch.telemetry.fleet import ChildScrape
    from mgwfbp_tpu_torch.telemetry.fleet import straggler_table as live
    from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator

    durs = {0: 0.010, 1: 0.013}
    paths = []
    for p, dur in durs.items():
        path = str(tmp_path / f"telemetry.p{p}.jsonl")
        w = EventWriter(path, run={"process_index": p, "process_count": 2})
        for i in range(10):
            w.emit("step", step=i + 1, epoch=0, start_s=i * dur, dur_s=dur)
        w.close()
        paths.append(path)
    rows = telemetry_merge.straggler_table(
        telemetry_merge.merge_streams(paths))
    children = []
    for p, path in enumerate(paths):
        agg = MetricsAggregator()
        agg.replay(read_event_set(path))
        children.append(ChildScrape(p, "127.0.0.1", 0, status={},
                                    values=agg.values()))
    live_rows = live(children)
    assert [r["process"] for r in rows] == [r["process"] for r in live_rows]
    for post, now in zip(rows, live_rows):
        assert post["mean_step_s"] == pytest.approx(now["mean_step_s"])
        assert post["mean_excess_s"] == pytest.approx(now["excess_s"])
    assert live_rows[1]["excess_s"] == pytest.approx(0.003)


def test_autotune_report_is_the_jax_tools(run):
    _, entry_path = run
    rc, printed = _main(autotune_report.main, [entry_path])
    assert rc == 0
    assert _main(jax_autotune_report.main, [entry_path]) == (0, printed)
    entry = json.load(open(entry_path))
    assert f"committed winner: {entry['winner']}" in printed
    assert entry["race"]
    for e in entry["race"]:
        assert e["label"] in printed


def test_live_and_fleet_pages_are_the_jax_tools(run):
    from mgwfbp_tpu_torch.telemetry.export import (
        parse_metrics_text,
        render_metrics,
    )
    from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator

    tag, _ = run
    agg = MetricsAggregator()
    agg.replay(read_event_set(os.path.join(tag, "telemetry.p0.jsonl")))
    status = json.loads(json.dumps(agg.status()))
    values = parse_metrics_text(render_metrics(agg.values()))
    live = telemetry_report.format_live_report(status, values)
    assert live == jax_telemetry_report.format_live_report(status, values)
    assert "steps: 10 recorded" in live
    doc = {"reachable": 2, "unreachable": [], "healthy": True,
           "straggler_table": [
               {"process": 0, "step": 10, "mean_step_s": 0.01,
                "excess_s": 0.0, "excess_pct": 0.0},
               {"process": 1, "step": 10, "mean_step_s": 0.012,
                "excess_s": 0.002, "excess_pct": 20.0}],
           "slowest_process": {"process": 1, "excess_s": 0.002,
                               "excess_pct": 20.0},
           "active_alarms": [{"alarm": "straggler", "slow_process": 1,
                              "excess_s": 0.002, "processes": [0, 1]}]}
    page = telemetry_report.format_fleet_report(doc)
    assert page == jax_telemetry_report.format_fleet_report(doc)


def test_selftest_passes(capsys):
    assert telemetry_report.selftest() == 0
    assert "telemetry selftest OK" in capsys.readouterr().out


def _tool_cases():
    """(id, module, argv builder over (tag dir, cache entry, tmp dir))."""
    return [
        ("telemetry_report", "mgwfbp_tpu_torch.tools.telemetry_report",
         lambda tag, entry, d: [os.path.join(tag, "telemetry.p0.jsonl"),
                                "--chrome-trace", os.path.join(d, "t.json"),
                                "--prometheus", os.path.join(d, "m.prom")]),
        ("telemetry_report_selftest",
         "mgwfbp_tpu_torch.tools.telemetry_report",
         lambda tag, entry, d: ["--selftest"]),
        ("telemetry_merge", "mgwfbp_tpu_torch.tools.telemetry_merge",
         lambda tag, entry, d: [tag, "--out", os.path.join(d, "m.jsonl")]),
        ("autotune_report", "mgwfbp_tpu_torch.tools.autotune_report",
         lambda tag, entry, d: [entry]),
        ("an4_report", "mgwfbp_tpu_torch.tools.an4_report",
         lambda tag, entry, d: ["--help"]),
        ("an4_trainmode_wer", "mgwfbp_tpu_torch.tools.an4_trainmode_wer",
         lambda tag, entry, d: ["--help"]),
        ("fault_smoke", "mgwfbp_tpu_torch.tools.fault_smoke",
         lambda tag, entry, d: ["--help"]),
        ("check", "mgwfbp_tpu_torch.tools.check",
         lambda tag, entry, d: ["--list"]),
    ]


@pytest.mark.parametrize("case", _tool_cases(), ids=lambda c: c[0])
def test_port_tool_runs_with_jax_refused(run, tmp_path, case):
    tag, entry = run
    _, module, build = case
    res = subprocess.run(nojax.argv(module, *build(tag, entry,
                                                   str(tmp_path))),
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout


def test_the_jax_tool_fails_under_the_refusal(run):
    tag, _ = run
    res = subprocess.run(
        nojax.argv("telemetry_merge", tag), capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=dict(
            os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT, os.path.join(ROOT, "tools")])))
    assert res.returncode != 0
    assert "mgwfbp_tpu" in res.stderr

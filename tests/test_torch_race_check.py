"""The port's host-concurrency race checker
(``mgwfbp_tpu_torch.analysis.race_check``) against the JAX package's.

Twins of tests/test_race_check.py: every marker-free snippet goes through
both checkers and the (rule id, line) sets must be equal (and carry the
rule the JAX suite expects); the ``thread-safe`` marker tests run with the
port's ``# mgwfbp:`` prefix; the shipped port tree is clean and fast, and
its discovered contexts include the async shard writer, the serving plane,
the loader's prefetch thread and telemetry/serve.py's handler; the THR
family carries exit bit 32 through the port's CLI."""

from __future__ import annotations

import json
import re
import time

import pytest

from mgwfbp_tpu.analysis import race_check as jax_race
from mgwfbp_tpu.analysis import rules as jax_rules
from mgwfbp_tpu_torch.analysis import race_check as port_race
from mgwfbp_tpu_torch.analysis.rules import (
    FAMILY_BITS,
    Finding,
    SuppressionTracker,
    exit_code,
)


# the JAX package's marker prefix, read from its own grammar
JAX_PREFIX = re.search(r"#\\s\*(\w+):", jax_rules._NOQA.pattern).group(1)


def _ids(findings):
    return [f.rule_id for f in findings]


def _check(src: str, tracker=None):
    return port_race.check_sources({"mod.py": src}, tracker=tracker)


THR001_SEED = (
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
THR002_SEED = (
    "import threading\n"
    "class S:\n"
    "    def __init__(self):\n"
    "        self._a_lock = threading.Lock()\n"
    "        self._b_lock = threading.Lock()\n"
    "        self._t = threading.Thread(target=self.worker)\n"
    "        self._t.start()\n"
    "    def worker(self):\n"
    "        with self._a_lock:\n"
    "            with self._b_lock:\n"
    "                self.x = 1\n"
    "    def refresh(self):\n"
    "        with self._b_lock:\n"
    "            with self._a_lock:\n"
    "                self.x = 2\n"
)
THR003_SEED = (
    "import time\n"
    "import threading\n"
    "from http.server import BaseHTTPRequestHandler\n"
    "class H(BaseHTTPRequestHandler):\n"
    "    def do_GET(self):\n"
    "        with self._lock:\n"
    "            self.payload = 1\n"
    "    def do_POST(self):\n"
    "        with self._lock:\n"
    "            time.sleep(5.0)\n"
)
THR004_SEED = (
    "import signal\n"
    "import threading\n"
    "class T:\n"
    "    def __init__(self):\n"
    "        self._state_lock = threading.Lock()\n"
    "        signal.signal(signal.SIGTERM, self._on_sig)\n"
    "    def _on_sig(self, signum, frame):\n"
    "        with self._state_lock:\n"
    "            self.flag = True\n"
)
THR005_SEED = (
    "import threading\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self._f = open('log.jsonl', 'a')\n"
    "        self._lock = threading.Lock()\n"
    "        self._t = threading.Thread(target=self._worker)\n"
    "        self._t.start()\n"
    "    def _worker(self):\n"
    "        self._f.write('x')\n"
    "    def close(self):\n"
    "        with self._lock:\n"
    "            self._f.close()\n"
)

# name -> (source, a rule the JAX suite expects, or None for a clean twin)
SNIPPETS = {
    "thr001_unlocked_shared_buffer": (THR001_SEED, "THR001"),
    "thr001_clean_with_common_lock": (
        "import threading\n"
        "class Buf:\n"
        "    def __init__(self):\n"
        "        self._rows = []\n"
        "        self._lock = threading.Lock()\n"
        "        self._t = threading.Thread(target=self._drain)\n"
        "        self._t.start()\n"
        "    def _drain(self):\n"
        "        with self._lock:\n"
        "            self._rows.pop()\n"
        "    def push(self, x):\n"
        "        with self._lock:\n"
        "            self._rows.append(x)\n", None),
    "thr001_clean_single_context": (
        "class Buf:\n"
        "    def __init__(self):\n"
        "        self._rows = []\n"
        "    def push(self, x):\n"
        "        self._rows.append(x)\n"
        "    def drop(self):\n"
        "        self._rows.pop()\n", None),
    "thr002_abba_inversion": (THR002_SEED, "THR002"),
    "thr002_clean_with_consistent_order": (
        THR002_SEED.replace(
            "        with self._b_lock:\n"
            "            with self._a_lock:\n"
            "                self.x = 2\n",
            "        with self._a_lock:\n"
            "            with self._b_lock:\n"
            "                self.x = 2\n"), None),
    "thr003_blocking_under_serving_lock": (THR003_SEED, "THR003"),
    "thr003_clean_when_blocking_outside_lock": (
        "import time\n"
        "import threading\n"
        "from http.server import BaseHTTPRequestHandler\n"
        "class H(BaseHTTPRequestHandler):\n"
        "    def do_GET(self):\n"
        "        with self._lock:\n"
        "            self.payload = 1\n"
        "    def do_POST(self):\n"
        "        time.sleep(5.0)\n"
        "        with self._lock:\n"
        "            self.payload = 2\n", None),
    "thr004_lock_in_signal_handler": (THR004_SEED, "THR004"),
    "thr004_clean_flag_store_only": (
        "import signal\n"
        "class T:\n"
        "    def __init__(self):\n"
        "        signal.signal(signal.SIGTERM, self._on_sig)\n"
        "    def _on_sig(self, signum, frame):\n"
        "        self.flag = True\n", None),
    "thr005_unlocked_write_vs_locked_close": (THR005_SEED, "THR005"),
    "thr005_clean_when_write_shares_the_lock": (
        THR005_SEED.replace(
            "        self._f.write('x')\n",
            "        with self._lock:\n"
            "            self._f.write('x')\n"), None),
    "async_writer_without_handoff_is_caught": (
        "import threading\n"
        "class AsyncSaver:\n"
        "    def __init__(self):\n"
        "        self._error = None\n"
        "        self._done = False\n"
        "    def submit(self, files):\n"
        "        self._error = None\n"
        "        self._done = False\n"
        "        t = threading.Thread(target=self._worker, args=(files,))\n"
        "        t.start()\n"
        "    def _worker(self, files):\n"
        "        try:\n"
        "            files.clear()\n"
        "        except OSError as e:\n"
        "            self._error = str(e)\n"
        "        self._done = True\n"
        "    def poll(self):\n"
        "        if self._done:\n"
        "            self._error = None\n", "THR001"),
    "async_writer_with_slot_handoff_is_clean": (
        "import threading\n"
        "class Slot:\n"
        "    def __init__(self):\n"
        "        self.error = None\n"
        "        self.done = threading.Event()\n"
        "class AsyncSaver:\n"
        "    def __init__(self):\n"
        "        self._slot = None\n"
        "    def submit(self, files):\n"
        "        slot = Slot()\n"
        "        t = threading.Thread(target=self._worker,\n"
        "                             args=(slot, files))\n"
        "        self._slot = slot\n"
        "        t.start()\n"
        "    def _worker(self, slot, files):\n"
        "        try:\n"
        "            files.clear()\n"
        "        except OSError as e:\n"
        "            slot.error = str(e)\n"
        "        finally:\n"
        "            slot.done.set()\n"
        "    def poll(self):\n"
        "        slot = self._slot\n"
        "        if slot is None:\n"
        "            return None\n"
        "        if not slot.done.is_set():\n"
        "            return None\n"
        "        self._slot = None\n"
        "        return slot.error\n", None),
    "liveness_monitor_on_a_thread_is_caught": (
        "import threading\n"
        "class Monitor:\n"
        "    def __init__(self):\n"
        "        self._steps = {}\n"
        "        self._verdicts = {}\n"
        "        t = threading.Thread(target=self._scrape_loop)\n"
        "        t.start()\n"
        "    def _scrape_loop(self):\n"
        "        while True:\n"
        "            self._steps[0] = self._steps.get(0, 0) + 1\n"
        "            self._verdicts[0] = 'wedged'\n"
        "    def heal_policy(self):\n"
        "        v = self._verdicts.pop(0, None)\n"
        "        if v == 'wedged':\n"
        "            self._steps.clear()\n"
        "        return v\n", "THR001"),
    "liveness_monitor_poll_confined_is_clean": (
        "class Monitor:\n"
        "    def __init__(self):\n"
        "        self._steps = {}\n"
        "        self._verdicts = {}\n"
        "    def poll(self, scrape):\n"
        "        self._steps[0] = scrape\n"
        "        if scrape == self._steps.get(0):\n"
        "            self._verdicts[0] = 'wedged'\n"
        "    def heal_policy(self):\n"
        "        return self._verdicts.pop(0, None)\n", None),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_marker_free_snippet_parity(name):
    src, rule = SNIPPETS[name]
    j = jax_race.check_sources({"mod.py": src})
    p = _check(src)
    port_set = {(f.rule_id, f.line) for f in p}
    assert port_set == {(f.rule_id, f.line) for f in j}, [
        f.format() for f in p]
    if rule is None:
        assert port_set == set()
    else:
        assert rule in _ids(p)
        # ... with the messages naming the same state (the JAX text names
        # its own marker prefix)
        jax_msgs = [f.message.replace(f"# {JAX_PREFIX}:", "# mgwfbp:")
                    for f in j]
        assert sorted(f.message for f in p) == sorted(jax_msgs)


# -- the thread-safe grammar with the port's prefix ---------------------------


def test_thread_safe_pin_suppresses_and_is_consumed():
    tracker = SuppressionTracker()
    src = THR001_SEED.replace(
        "        self._rows.append(x)\n",
        "        # mgwfbp: thread-safe -- flushed only after join()\n"
        "        self._rows.append(x)\n",
    )
    assert _check(src, tracker=tracker) == []
    assert tracker.unused_findings() == []
    assert any(f.rule_id == "THR001" for f in tracker.suppressed_findings)


def test_dead_thread_safe_pin_is_ana001():
    tracker = SuppressionTracker()
    assert _check(
        "class C:\n"
        "    def f(self):\n"
        "        # mgwfbp: thread-safe -- nothing here races\n"
        "        return 1\n",
        tracker=tracker,
    ) == []
    assert _ids(tracker.unused_findings()) == ["ANA001"]


def test_reasonless_thread_safe_pin_is_ana001():
    tracker = SuppressionTracker()
    _check(THR001_SEED.replace(
        "        self._rows.append(x)\n",
        "        self._rows.append(x)  # mgwfbp: thread-safe\n",
    ), tracker=tracker)
    assert any(f.rule_id == "ANA001" for f in tracker.unused_findings())


# -- the shipped port tree ---------------------------------------------------------


def test_shipped_tree_is_clean_and_fast():
    tracker = SuppressionTracker()
    t0 = time.perf_counter()
    findings = port_race.check_paths(tracker=tracker)
    dt = time.perf_counter() - t0
    assert findings == [], [f.format() for f in findings]
    assert dt < 30.0, f"THR pass took {dt:.1f}s"
    dead = [f for f in tracker.unused_findings()
            if "thread-safe" in f.message]
    assert dead == [], [f.format() for f in dead]
    # the port's pins hide the findings they document: the signal flags,
    # the dispatcher's carry, the watchdog's heartbeat
    hidden = {f.message.split("'")[1] for f in tracker.suppressed_findings
              if f.rule_id == "THR001"}
    assert {"Trainer._signals_armed", "Trainer._preempt_signal",
            "PredictService._carry", "ProgressWatchdog._phase",
            "ProgressWatchdog._last", "ProgressWatchdog._allow"} <= hidden


@pytest.fixture(scope="module")
def contexts():
    return {c[0] for c in port_race.discover_contexts()}


def test_shipped_contexts_include_the_async_writer(contexts):
    assert "thread:Checkpointer._shard_payload_worker" in contexts
    for kind in ("handler:", "executor:", "observer:", "signal:"):
        assert any(lbl.startswith(kind) for lbl in contexts), kind


def test_shipped_contexts_include_the_serving_plane(contexts):
    assert "thread:PredictService._run" in contexts
    assert "thread:ReloadWatcher._run" in contexts


def test_shipped_contexts_include_the_port_entry_points(contexts):
    # the loader's prefetch thread and telemetry/serve.py's HTTP handler
    assert "thread:PrefetchLoader._iter_thread.feed" in contexts
    assert "handler:_Handler" in contexts


# -- exit codes + CLI -----------------------------------------------------------------


def test_thr_family_exit_bit():
    assert FAMILY_BITS["THR"] == 32
    assert exit_code([Finding("a.py", 1, "THR001", "m")]) == 32
    assert exit_code([
        Finding("a.py", 1, "THR002", "m"),
        Finding("a.py", 2, "RUN001", "m"),
    ]) == 36


@pytest.mark.parametrize("seed", [
    THR001_SEED, THR002_SEED, THR003_SEED, THR004_SEED, THR005_SEED,
], ids=["THR001", "THR002", "THR003", "THR004", "THR005"])
def test_cli_exit_code_32_per_seeded_rule(tmp_path, seed, capsys):
    from mgwfbp_tpu_torch.analysis.__main__ import main

    f = tmp_path / "seeded.py"
    f.write_text(seed)
    rc = main([str(f), "--skip-lint", "--skip-spmd", "--skip-step"])
    captured = capsys.readouterr()
    assert rc == FAMILY_BITS["THR"] == 32, captured.out + captured.err


def test_cli_json_carries_thr_findings_with_suppression_state(
        tmp_path, capsys):
    from mgwfbp_tpu_torch.analysis.__main__ import main

    live = tmp_path / "live.py"
    live.write_text(THR001_SEED)
    pinned = tmp_path / "pinned.py"
    pinned.write_text(THR001_SEED.replace("Buf", "PinnedBuf").replace(
        "        self._rows.append(x)\n",
        "        # mgwfbp: thread-safe -- flushed only after join()\n"
        "        self._rows.append(x)\n",
    ))
    rc = main([str(live), str(pinned), "--json", "--skip-lint",
               "--skip-spmd", "--skip-step"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == doc["exit_code"] == 32
    assert doc["errors_by_family"].get("THR") == 1
    thr = [d for d in doc["findings"] if d["family"] == "THR"]
    assert {d["suppressed"] for d in thr} == {True, False}
    assert all(d["rule"] == "THR001" for d in thr)

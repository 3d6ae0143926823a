"""The port's progress watchdog, deadlines, launch probe, gather primitives
and the training process's live plane, on the CPU, held against the JAX
package where the two can run side by side.

  * ``utils.watchdog.ProgressWatchdog``: off by default, fires on a stall
    and stays quiet with beats, honours an allowance until the next beat
    (``tests/test_watchdog.py:13-62``); a trainer arms and disarms it; a
    ``stall`` fault under it gives a ``watchdog_stall`` event;
  * ``utils.platform``: ``run_with_deadline`` (``tests/test_deadline.py``),
    ``env_float``/``env_int`` against the JAX functions, and
    ``preflight_backend`` (the CPU touches no CUDA; a card asked for where
    there is none raises; a hang raises ``DeadlineExceeded``);
  * ``runtime.coordination``'s ``gather_values``, ``gather_vectors`` and
    ``all_argmin`` at 1 and 2 gloo ranks equal the JAX functions' answers
    on the same values (ties and None included); the two ranks run with an
    explicit environment, are drained together and bounded, and a failing
    rank's stderr is in the assertion; the module drops its process groups
    before interpreter shutdown;
  * the training ``/status`` and ``/healthz`` of a real port ``Trainer``:
    the step advances with the run, and the same events fed to the JAX
    package's ``MetricsAggregator`` give the same health, step and counts
    (a ``bad_step`` is counted, a ``watchdog_stall`` is unhealthy until the
    next step, and for good once it aborts); the port writes its bound
    port to ``MGWFBP_METRICS_PORT_FILE``; ``/metrics``, ``/profile`` and
    ``/postmortems`` answer what the JAX plane answers for the same
    stream.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mgwfbp_tpu.runtime import coordination as jax_coord
from mgwfbp_tpu.telemetry.export import render_metrics
from mgwfbp_tpu.telemetry.serve import MetricsAggregator as JaxAggregator
from mgwfbp_tpu.utils import platform as jax_platform
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.runtime import coordination as coord
from mgwfbp_tpu_torch.telemetry import events_of, read_events
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.utils import platform
from mgwfbp_tpu_torch.utils.platform import (
    DeadlineExceeded,
    preflight_backend,
    run_with_deadline,
)
from mgwfbp_tpu_torch.utils.watchdog import ProgressWatchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- the watchdog ------------------------------------------------------------

def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("MGWFBP_WATCHDOG_S", raising=False)
    with ProgressWatchdog() as wd:
        assert not wd.enabled
        assert not wd.fired


def test_fires_on_stall_and_stays_quiet_with_beats():
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    handler = Capture()
    logging.getLogger("mgwfbp.watchdog").addHandler(handler)
    stalls = []
    try:
        with ProgressWatchdog(timeout_s=0.3, check_interval_s=0.05,
                              on_stall=lambda **kw: stalls.append(kw)) as wd:
            assert wd.enabled
            for _ in range(6):
                wd.beat("train epoch 0")
                time.sleep(0.05)
            assert not wd.fired
            time.sleep(0.6)
        assert wd.fired
    finally:
        logging.getLogger("mgwfbp.watchdog").removeHandler(handler)
    msgs = [r.getMessage() for r in records]
    assert any("no training progress" in m for m in msgs)
    assert any("train epoch 0" in m for m in msgs)
    assert stalls and stalls[0]["phase"] == "train epoch 0"
    assert stalls[0]["abort"] is False and stalls[0]["idle_s"] > 0.3


def test_phase_allowance_defers_firing():
    with ProgressWatchdog(timeout_s=0.2, check_interval_s=0.05) as wd:
        wd.beat("first train step", allow_s=1.0)
        time.sleep(0.5)
        assert not wd.fired
        wd.beat("train epoch 0")  # the allowance ends with the next beat
        time.sleep(0.5)
        assert wd.fired


def test_abort_dumps_every_stack_and_exits_86(tmp_path):
    """In a child process: the stack dump lands in the log file before the
    rc-86 exit."""
    log = tmp_path / "train.log"
    script = (
        "import time\n"
        "from mgwfbp_tpu_torch.utils.logging import get_logger\n"
        "from mgwfbp_tpu_torch.utils.watchdog import ProgressWatchdog\n"
        f"get_logger('mgwfbp.trainer', logfile={str(log)!r})\n"
        "with ProgressWatchdog(timeout_s=0.3, abort=True,\n"
        "                      check_interval_s=0.05) as wd:\n"
        "    wd.beat('blocked collective')\n"
        "    time.sleep(30)\n"
    )
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 86
    text = log.read_text()
    assert "watchdog stall in 'blocked collective'" in text
    assert "Thread" in text
    assert "all-thread traceback dump" in res.stderr


# -- deadlines, environment knobs, the launch probe ----------------------------

def test_run_with_deadline():
    assert run_with_deadline(lambda: 42, 5.0) == 42
    with pytest.raises(DeadlineExceeded, match="slowop"):
        run_with_deadline(lambda: time.sleep(30), 0.1, what="slowop")
    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 / 0, 5.0)


@pytest.mark.parametrize("fn,raw", [
    ("env_float", None), ("env_float", " 7 "), ("env_float", "junk"),
    ("env_int", ""), ("env_int", "12"), ("env_int", "1.5"),
])
def test_env_knobs_match_jax(fn, raw):
    environ = {} if raw is None else {"MY_KNOB": raw}

    def answer(mod):
        try:
            return getattr(mod, fn)("MY_KNOB", 3, environ=environ)
        except ValueError as e:
            return str(e)

    assert answer(platform) == answer(jax_platform)


def test_preflight_backend(monkeypatch):
    assert preflight_backend(device="cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preflight_backend(device="cuda", timeout_s=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(platform, "_touch_cards", lambda: time.sleep(30))
    with pytest.raises(DeadlineExceeded, match="MGWFBP_INIT_TIMEOUT_S"):
        preflight_backend(device="cuda", timeout_s=0.2)
    monkeypatch.setattr(platform, "_touch_cards", lambda: ["card"])
    assert preflight_backend(device="cuda", timeout_s=0) == ["card"]


# -- gather_values, gather_vectors, all_argmin -----------------------------------

# per rank: (scalar, vector, candidate timings)
COORD_VALUES = [
    (1.5, [1.0, 2.0, 3.0], [3.0, None, 2.0, 2.0, float("nan")]),
    (-2.0, [4.0, 5.0, 6.0], [1.0, 5.0, 2.0, 2.5, 1.0]),
]


def _jax_group(fn, per_rank: list, kind: str) -> list:
    """What the JAX function answers on each rank of a group with these
    per-rank arguments: each rank's contribution to the device reduction
    is captured, reduced as the device would, and handed back."""
    rows = []
    n = len(per_rank)
    saved = (jax_coord.process_count, jax_coord.process_index,
             jax_coord._device_reduce)
    try:
        jax_coord.process_count = lambda: n
        for r, arg in enumerate(per_rank):
            jax_coord.process_index = lambda r=r: r
            jax_coord._device_reduce = (
                lambda vals, k, op="": rows.append(list(vals))
                or np.zeros(len(vals)))
            fn(arg)
        red = np.sum(rows, 0) if kind == "sum" else np.max(rows, 0)
        out = []
        for r, arg in enumerate(per_rank):
            jax_coord.process_index = lambda r=r: r
            jax_coord._device_reduce = lambda vals, k, op="": red.copy()
            out.append(fn(arg))
        return out
    finally:
        (jax_coord.process_count, jax_coord.process_index,
         jax_coord._device_reduce) = saved


def _jax_answers(values: list) -> list:
    """[(gather_values, gather_vectors, all_argmin)] per rank, from JAX."""
    if len(values) == 1:
        s, v, c = values[0]
        return [(jax_coord.gather_values(s), jax_coord.gather_vectors(v),
                 jax_coord.all_argmin(c))]
    gv = _jax_group(jax_coord.gather_values, [s for s, _, _ in values], "sum")
    gw = _jax_group(jax_coord.gather_vectors, [v for _, v, _ in values],
                    "sum")
    am = _jax_group(jax_coord.all_argmin, [c for _, _, c in values], "max")
    return list(zip(gv, gw, am))


def _norm(answer) -> str:
    """Answers compared as JSON (inf and nan spelled out)."""
    gv, gw, (win, red) = answer
    return json.dumps([[float(x) for x in gv],
                       [[float(x) for x in row] for row in gw],
                       int(win), [float(x) for x in red]])


_COORD_CHILD = r"""
import datetime, json, sys
import torch.distributed as dist
from mgwfbp_tpu_torch.runtime import coordination as coord
rank, world, rdv, values = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            json.loads(sys.argv[4]))
dist.init_process_group("gloo", init_method=f"file://{rdv}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=180))
s, v, c = values[rank]
out = [coord.gather_values(s), coord.gather_vectors(v),
       list(coord.all_argmin([None if x is None else float(x) for x in c]))]
print(json.dumps(out))
dist.destroy_process_group()
"""


# what a child needs of the environment; nothing else of the test worker's
# (whose variables earlier tests in the same process may have set) leaks in
_CHILD_ENV_KEYS = ("PATH", "HOME", "TMPDIR", "LANG", "LC_ALL",
                   "LD_LIBRARY_PATH")


def _run_children(argvs: list, timeout_s: float = 240.0,
                  script: str = _COORD_CHILD,
                  extra_env: dict = None) -> list:
    """Run one ``script`` (``_COORD_CHILD``) per argv with an explicit
    environment (plus ``extra_env``),
    drain every child's pipes at once (a child blocked on a full pipe
    while the parent waits on its sibling would hold the group's
    collective), and return each child's last stdout line as JSON. A
    child that fails, or a group that outlives ``timeout_s`` (every child
    is then killed), fails the test with every child's stderr."""
    env = {k: os.environ[k] for k in _CHILD_ENV_KEYS if k in os.environ}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(extra_env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for argv in argvs]
    outs: list = [None] * len(procs)

    def drain(i: int) -> None:
        outs[i] = procs[i].communicate()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    for p in procs:
        if p.poll() is None:
            p.kill()
    for t in threads:
        t.join(10)

    def report() -> str:
        return "\n".join(
            f"rank {i}: rc {p.returncode}, stderr:\n"
            f"{(outs[i] or ('', ''))[1][-3000:]}"
            for i, p in enumerate(procs))

    assert not hung, f"rank(s) {hung} still running after {timeout_s:.0f}" \
        f" s; killed\n{report()}"
    assert [p.returncode for p in procs] == [0] * len(procs), report()
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


@pytest.mark.parametrize("world", [1, 2])
def test_gather_primitives_match_jax(world, tmp_path):
    values = COORD_VALUES[:world]
    want = [_norm(a) for a in _jax_answers(values)]
    if world == 1:
        s, v, c = values[0]
        got = [_norm((coord.gather_values(s), coord.gather_vectors(v),
                      coord.all_argmin(c)))]
    else:
        doc = json.dumps(values)  # NaN travels as the JSON token NaN
        got = [_norm((gv, gw, tuple(am))) for gv, gw, am in _run_children(
            [[str(r), str(world), str(tmp_path / "rdv"), doc]
             for r in range(world)])]
    assert got == want
    # every rank agrees
    assert len(set(got)) == 1


_RELEASE_CHILD = r"""
import sys
from mgwfbp_tpu_torch.runtime import coordination as coord
class Probe:
    def __del__(self):
        print("finalizing" if sys.is_finalizing() else "released", flush=True)
coord._side = (Probe(), Probe())
"""


def test_coordination_drops_its_groups_before_interpreter_shutdown():
    """The side group (and the world it belongs to) must be destroyed while
    the interpreter still runs: destroyed during its finalisation, gloo's
    teardown aborted one child in ten of a loaded two-rank run of the test
    above (rc -6, "terminate called without an active exception", after
    its answer was printed)."""
    env = {k: os.environ[k] for k in _CHILD_ENV_KEYS if k in os.environ}
    env.update(PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _RELEASE_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["released", "released"]


def test_all_argmin_refuses_an_empty_list():
    with pytest.raises(ValueError, match="empty"):
        coord.all_argmin([])


# -- the live plane of a training process ------------------------------------------

def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _lenet_cfg(tmp_path, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=5, max_epochs=1,
                logdir=str(tmp_path), checkpoint_dir=None, seed=5,
                augment=False)
    base.update(kw)
    return make_config("lenet", **base)


def _health_view(agg) -> tuple:
    st = agg.status()
    return (agg.health(), st["healthy"], st["health_reason"], st["step"],
            st["epoch"], st["bad_steps"], st["rollbacks"])


def test_trainer_status_and_healthz_match_the_jax_aggregator(
        tmp_path, monkeypatch):
    port_file = tmp_path / "port.json"
    monkeypatch.setenv("MGWFBP_METRICS_PORT_FILE", str(port_file))
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2")
    cfg = _lenet_cfg(tmp_path, metrics_port=0)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        assert cfg.telemetry  # the plane implies the stream that feeds it
        doc = json.loads(port_file.read_text())
        assert doc["role"] == "train" and doc["process"] == 0
        port = doc["port"]
        assert port == t._metrics_server.port
        code, body = _get(port, "/status")
        assert code == 200 and json.loads(body)["step"] is None
        t.fit(1)
        code, body = _get(port, "/status")
        st = json.loads(body)
        assert (st["step"], st["epoch"], st["bad_steps"]) == (5, 0, 1)
        assert st["healthy"] and st["run"]["model"] == "lenet"
        assert st["schedule"]["comm_op"] == "all_reduce"
        assert _get(port, "/healthz") == (200, "ok\n")
        # the same stream through the JAX aggregator
        recs = read_events(os.path.join(str(tmp_path), cfg.tag(),
                                        "telemetry.jsonl"))
        jagg = JaxAggregator()
        jagg.replay(recs)
        assert _health_view(jagg) == _health_view(t._metrics_agg)
        # the rest of the plane answers as the JAX plane does
        code, body = _get(port, "/metrics")
        assert code == 200 and body == render_metrics(jagg.values())
        code, body = _get(port, "/profile")
        assert code == 200 and json.loads(body) == dict(
            jagg.profile_status(), supported=True)
        code, body = _get(port, "/postmortems")
        want = jagg.postmortems()  # a replay keeps each record's wall
        want["recent"] = [{k: v for k, v in r.items() if k != "wall"}
                          for r in want["recent"]]
        assert code == 200 and json.loads(body) == want
        assert want["total"] == 1  # the NaN step's bundle
        # a stall that does not abort: 503 until the loop steps again
        t._on_watchdog_stall("train epoch 1", 7.0, 5.0, False)
        jagg.observe("watchdog_stall", {"phase": "train epoch 1",
                                        "idle_s": 7.0, "timeout_s": 5.0,
                                        "abort": False})
        code, body = _get(port, "/healthz")
        assert code == 503 and "watchdog stall" in body
        assert _health_view(jagg) == _health_view(t._metrics_agg)
        step = {"step": 6, "epoch": 1, "start_s": 0.0, "dur_s": 0.1}
        t.telemetry.emit("step", **step)
        jagg.observe("step", step)
        assert _get(port, "/healthz") == (200, "ok\n")
        assert _health_view(jagg) == _health_view(t._metrics_agg)
        # an aborting stall stays unhealthy whatever comes after
        t0 = time.monotonic()
        t._on_watchdog_stall("train epoch 1", 9.0, 5.0, True)
        assert time.monotonic() - t0 >= 0.9  # held for the prober
        jagg.observe("watchdog_stall", {"phase": "train epoch 1",
                                        "idle_s": 9.0, "timeout_s": 5.0,
                                        "abort": True})
        step = dict(step, step=7)
        t.telemetry.emit("step", **step)
        jagg.observe("step", step)
        code, body = _get(port, "/healthz")
        assert code == 503 and "rc 86" in body
        assert _health_view(jagg) == _health_view(t._metrics_agg)
        events = events_of(recs, "bad_step")
        assert [e["step"] for e in events] == [2]
    finally:
        t.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=2)


def test_trainer_arms_the_watchdog_and_a_stall_fires_it(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("MGWFBP_WATCHDOG_S", "0.4")
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "stall@secs=1.5,step=3")
    cfg = _lenet_cfg(tmp_path, telemetry=True)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    seen = []
    orig = ProgressWatchdog.__enter__

    def enter(self):
        self.check_interval_s = 0.1
        seen.append(self)
        return orig(self)

    monkeypatch.setattr(ProgressWatchdog, "__enter__", enter)
    try:
        m = t.fit(1)
        assert np.isfinite(m["train"]["loss"])
        assert t._watchdog is None  # disarmed after fit
        assert seen and seen[0].enabled and seen[0].fired
    finally:
        t.close()
    recs = read_events(os.path.join(str(tmp_path), cfg.tag(),
                                    "telemetry.jsonl"))
    stalls = events_of(recs, "watchdog_stall")
    assert stalls and stalls[0]["phase"] == "train epoch 0"
    assert stalls[0]["abort"] is False
    assert max(e["step"] for e in events_of(recs, "step")) == 5


def test_aggregator_serves_extra_status():
    agg = MetricsAggregator(run={"role": "serve"},
                            extra_status=lambda: {"kernel_launches": {"k": 3}})
    agg.observe("reload", {"step": 4, "lag_s": 0.5, "duration_s": 0.1})
    st = agg.status()
    assert st["kernel_launches"] == {"k": 3}
    assert st["serving"]["step"] == 4 and st["serving"]["reloads"] == 1

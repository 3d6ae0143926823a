"""The exit trace (``mgwfbp_tpu_torch.utils.watchdog``: ``exit_mark``,
``start_stack_sampler``) and the heal phase's reading of it
(``chip_multicard.survivor_timeline``).

With ``MGWFBP_STACK_SAMPLE_S`` unset the trace writes nothing; set, each
mark is one stderr line with monotonic and wall seconds, and a daemon
thread writes the main thread's innermost frames at that interval. The
heal phase places a survivor's timestamped lines (the marks, torch's C++
log prefix, the Python logger's) in seconds after the peer's kill. An NCCL
world that ``parallel.mesh.init_distributed`` starts bounds the wait of
torch's watchdog for its debug dump (``NCCL_DUMP_WAIT_MS``) unless the
environment sets it.
"""

import os
import sys
import time

import pytest

from mgwfbp_tpu_torch.utils import watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_an_unarmed_trace_writes_nothing(monkeypatch, capsys):
    monkeypatch.delenv(watchdog.STACK_SAMPLE_ENV, raising=False)
    watchdog.exit_mark("leaving")
    assert watchdog.start_stack_sampler() is None
    assert capsys.readouterr().err == ""


def test_a_mark_carries_monotonic_and_wall_seconds(monkeypatch, capsys):
    monkeypatch.setenv(watchdog.STACK_SAMPLE_ENV, "5")
    before = time.time()
    watchdog.exit_mark("destroy_process_group")
    line = capsys.readouterr().err.strip()
    assert line.startswith(f"{watchdog.EXIT_TRACE_PREFIX} "
                           "destroy_process_group monotonic ")
    wall = float(line.rsplit("wall ", 1)[1])
    assert before - 1 <= wall <= time.time() + 1


def test_the_sampler_writes_where_the_main_thread_waits(monkeypatch, capsys):
    monkeypatch.setenv(watchdog.STACK_SAMPLE_ENV, "0.05")
    t = watchdog.start_stack_sampler()
    assert t is not None and t.daemon
    time.sleep(0.3)  # the main thread waits here
    err = capsys.readouterr().err
    assert "main thread at test_torch_exit_trace.py" in err
    assert "test_the_sampler_writes_where_the_main_thread_waits" in err


def test_the_heal_phase_places_a_survivors_lines(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        import chip_multicard
    finally:
        sys.path.remove(ROOT)
    kill = time.mktime((2026, 10, 18, 18, 0, 0, 0, 0, -1))
    log = tmp_path / "p0.i0.log"
    log.write_text("\n".join([
        "2026-10-18 17:59:50,000 [vm] INFO mgwfbp.trainer: before the kill",
        "[rank0]:[E1018 18:00:30.250000000 ProcessGroupNCCL.cpp:632] "
        "Watchdog caught collective operation timeout",
        "a line without a time",
        f"{watchdog.EXIT_TRACE_PREFIX} SIGTERM handled at step 9 monotonic "
        f"12.0 wall {kill + 0.5:.3f}",
        "2026-10-18 18:01:00,125 [vm] ERROR mgwfbp.trainer: coordination "
        "timeout",
        "2026-10-18 18:05:00,000 [vm] INFO mgwfbp.trainer: after the exit",
    ]))
    got = chip_multicard.survivor_timeline(str(log), kill, kill + 91.0)
    assert [t for t, _ in got] == pytest.approx([30.25, 0.5, 60.125])
    assert "Watchdog" in got[0][1] and "SIGTERM" in got[1][1]


@pytest.mark.parametrize("backend,preset,want", [
    ("nccl", None, "1000"), ("nccl", "30000", "30000"), ("gloo", None, None)])
def test_an_nccl_world_bounds_the_watchdogs_dump_wait(monkeypatch, backend,
                                                      preset, want):
    from mgwfbp_tpu_torch.parallel import mesh

    if preset is None:
        monkeypatch.delenv(mesh.NCCL_DUMP_WAIT_ENV, raising=False)
    else:
        monkeypatch.setenv(mesh.NCCL_DUMP_WAIT_ENV, preset)
    seen = {}
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(
        mesh.dist, "init_process_group",
        lambda b, **kw: seen.update(
            backend=b, wait=os.environ.get(mesh.NCCL_DUMP_WAIT_ENV)))
    mesh.init_distributed("cpu", num_processes=2, process_id=0,
                          init_method="file:///unused", backend=backend)
    assert seen == {"backend": backend, "wait": want}

"""The port's one span primitive, and the process's span recorder.

``span(name)`` is a named range of host time that costs something only
where something reads it. It is, at once:

  * a ``torch.profiler.record_function`` range while torch.profiler
    records, on the profiler's own clock, so it lines up with the device
    trace;
  * an entry of the calling thread's ``open_scopes`` while a schedule
    observer watches (``watch_scopes``, armed by
    ``analysis.schedule_check``), so that every collective of a step is
    attributed to the range it was issued in. Only the collective scopes
    take part (``scope=True``, the default: the reducer's
    ``mgwfbp_groupNNNN``, the step's ``metrics_reduce`` ...); the train
    step's phases do not;
  * a host-clock record (name, start, end; ``time.perf_counter``
    seconds) in the ``sink`` given (``SetupSpans``).

With none of the three it returns a shared no-op context: one profiler
check and one module-level read, no allocation, no range.

The recorder (one a process, as the profiler is) is armed while
torch.profiler records and inside ``recording()`` (tests, measurements).
A train step asks once, at its start, whether it is armed
(``begin_step``); an armed step's ``StepRecord`` takes the step's and
the reducer's marks: B, the end of the step's backward
(``backward_end``), and each merge group's ``ready`` (the bucket packed, before its
collective) and ``done`` (its collectives complete). On a card a mark is
a CUDA event from a pool the recorder reuses, recorded on the stream the
mark belongs to; on the CPU it is a host clock reading. Nothing is read
on the host inside a step: the events are resolved when the recorder is
read (``recent_steps``), after the caller's own synchronisation. The
ring keeps the last ``RING`` armed steps.

``SetupSpans`` times a one-off set-up (``Trainer.__init__``) on the host
clock whatever is armed; ``publish`` makes its seconds the process's
latest set-up (``setup_seconds``).
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import threading
import time
from typing import Optional

import torch

RING = 64

# the shared no-op context of a span nothing reads
_NULL = contextlib.nullcontext()

# the open collective scopes of each thread, kept while a schedule
# observer is armed (``watch_scopes``): on the card the gradient hooks run
# on autograd's device thread
_SCOPE_TLS = threading.local()
_scope_watchers = 0
_scope_watch_lock = threading.Lock()

# ``recording()`` depth, and the step being recorded (None: the span
# records nothing)
_recording = 0
_armed: Optional["StepRecord"] = None


@contextlib.contextmanager
def watch_scopes():
    """Keep every thread's open collective scopes while inside
    (``open_scopes``; ``analysis.schedule_check`` arms it)."""
    global _scope_watchers
    with _scope_watch_lock:
        _scope_watchers += 1
    try:
        yield
    finally:
        with _scope_watch_lock:
            _scope_watchers -= 1


def open_scopes() -> tuple[str, ...]:
    """The collective scopes open on the calling thread, outermost first
    (empty unless ``watch_scopes`` is armed)."""
    return tuple(getattr(_SCOPE_TLS, "stack", ()))


class _Span:
    __slots__ = ("name", "watched", "range", "sink", "t0")

    def __init__(self, name: str, watched: bool, profiled: bool,
                 sink: Optional[list]):
        self.name = name
        self.watched = watched
        self.range = (torch.profiler.record_function(name) if profiled
                      else None)
        self.sink = sink
        self.t0 = 0.0

    def __enter__(self):
        if self.watched:
            _SCOPE_TLS.stack = open_scopes() + (self.name,)
        if self.range is not None:
            self.range.__enter__()
        if self.sink is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            self.sink.append((self.name, self.t0, time.perf_counter()))
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.watched:
            _SCOPE_TLS.stack = open_scopes()[:-1]
        return False


def span(name: str, scope: bool = True, sink: Optional[list] = None):
    """A range named ``name`` (module docstring): a profiler range while
    torch.profiler records, an entry of ``open_scopes`` while a schedule
    observer watches (``scope``), and a host record in ``sink``; else
    nothing."""
    profiled = torch.autograd._profiler_enabled()
    watched = scope and _scope_watchers > 0
    if not (profiled or watched or sink is not None):
        return _NULL
    return _Span(name, watched, profiled, sink)


class Phases:
    """Consecutive spans that together cover a stretch of host time (the
    train step's phases; not collective scopes): ``to(name)`` opens
    ``name`` and then ends the open one, so that no instant between them
    lies outside a phase (they overlap by the switch's few µs); ``end()``
    ends the last."""

    def __init__(self):
        self._open = None

    def to(self, name: str) -> None:
        nxt = span(name, scope=False)
        nxt.__enter__()
        self.end()
        self._open = nxt

    def end(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


# -- the recorder -------------------------------------------------------------


class StepRecord:
    """One armed step's marks (CUDA events on a card, host clock readings
    on the CPU):
    ``backward_end`` (B), and each merge group's ``ready`` and ``done`` by
    group index, in launch order. ``start``, the reference of a reading,
    is the step's first mark: every other mark follows it on the device
    (B and the ready marks on the step's stream, each done after its
    group's ready). The step makes no runtime call before it needs one,
    so none lies outside its phases."""

    __slots__ = ("cuda", "start", "backward_end", "ready", "done")

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.start = None
        self.backward_end = None
        self.ready: dict = {}
        self.done: dict = {}

    def mark(self):
        """A mark now: an event recorded on the current stream (a card), or
        the host clock."""
        if self.cuda:
            try:
                m = _spare.pop()  # atomic: the hooks' thread marks too
            except IndexError:
                m = torch.cuda.Event(enable_timing=True)
            m.record()
        else:
            m = time.perf_counter()
        if self.start is None:
            self.start = m
        return m

    def events(self) -> list:
        """The step's CUDA events (``start`` is one of them)."""
        if not self.cuda:
            return []
        return ([self.backward_end] if self.backward_end is not None
                else []) + list(self.ready.values()) + list(self.done.values())


_steps: collections.deque = collections.deque()
_spare: list = []  # the CUDA events of steps that left the ring
_setup: dict = {}
_lock = threading.Lock()


@contextlib.contextmanager
def recording():
    """Arm the recorder for every step begun inside (as torch.profiler
    does while it records)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def begin_step(cuda: bool) -> Optional[StepRecord]:
    """The armed record of the step beginning now (``cuda``: its marks are
    events), or None when the recorder is not armed."""
    global _armed
    if not (_recording or torch.autograd._profiler_enabled()):
        return None
    _armed = StepRecord(cuda)
    return _armed


def armed_step() -> Optional[StepRecord]:
    """The record of the step being recorded, if any."""
    return _armed


def end_step(rec: Optional[StepRecord]) -> None:
    """Close ``rec`` (``begin_step``'s) into the ring."""
    global _armed
    if rec is None:
        return
    _armed = None
    with _lock:
        _steps.append(rec)
        while len(_steps) > RING:
            _spare.extend(_steps.popleft().events())


def clear() -> None:
    """Forget every recorded step and the published set-up."""
    with _lock:
        while _steps:
            _spare.extend(_steps.popleft().events())
        _setup.clear()


def _ms(rec: StepRecord, mark) -> float:
    """Milliseconds from the step's first mark to ``mark`` (an event
    waited for first: a read, never inside a step)."""
    if not rec.cuda:
        return (mark - rec.start) * 1e3
    mark.synchronize()
    return rec.start.elapsed_time(mark)


def _reading(rec: StepRecord) -> dict:
    """One step's marks resolved: ``groups``, in
    launch order, each {"group", "ready_ms", "done_ms"} in milliseconds
    after B ("done_ms" None where no completion was marked);
    ``tail_ms`` = max(0, the last done - B), None without a group."""
    out = {"cuda": rec.cuda, "groups": [], "tail_ms": None}
    if rec.backward_end is None:
        return out
    b = _ms(rec, rec.backward_end)
    for gi, ready in rec.ready.items():
        done = rec.done.get(gi)
        out["groups"].append({
            "group": gi, "ready_ms": _ms(rec, ready) - b,
            "done_ms": None if done is None else _ms(rec, done) - b})
    done = [g["done_ms"] for g in out["groups"] if g["done_ms"] is not None]
    if done:
        out["tail_ms"] = max(0.0, max(done))
    return out


def recent_steps(n: Optional[int] = None) -> list[dict]:
    """The reading of each of the last ``n`` armed steps (every step the
    ring holds when None), oldest first. Read after synchronising."""
    with _lock:
        recs = list(_steps)
    if n is not None:
        recs = recs[max(len(recs) - n, 0):] if n > 0 else []
    return [_reading(r) for r in recs]


def group_medians(readings: list[dict]) -> tuple[dict, Optional[float]]:
    """Over ``recent_steps`` readings: {group: {"ready_to_done_ms",
    "after_backward_ms"}}, the medians of done(g) - ready(g) and of
    max(0, done(g) - B) over the steps that marked both, and the median
    ``tail_ms`` (None where no step has one)."""
    per: dict = {}
    for r in readings:
        for g in r["groups"]:
            if g["done_ms"] is not None:
                per.setdefault(g["group"], []).append(g)
    rows = {gi: {"ready_to_done_ms": statistics.median(
                     g["done_ms"] - g["ready_ms"] for g in gs),
                 "after_backward_ms": statistics.median(
                     max(0.0, g["done_ms"]) for g in gs)}
            for gi, gs in sorted(per.items())}
    tails = [r["tail_ms"] for r in readings if r["tail_ms"] is not None]
    return rows, (statistics.median(tails) if tails else None)


class SetupSpans:
    """Host-clock spans of a one-off set-up, recorded whatever is armed;
    blocks of one name add up."""

    def __init__(self):
        self.records: list = []

    def span(self, name: str):
        return span(name, scope=False, sink=self.records)

    def seconds(self) -> dict:
        """Seconds by name, in the order the names were first recorded."""
        out: dict = {}
        for name, t0, t1 in self.records:
            out[name] = out.get(name, 0.0) + (t1 - t0)
        return out

    def publish(self) -> None:
        """Make these the process's latest set-up (``setup_seconds``)."""
        secs = self.seconds()
        with _lock:
            _setup.clear()
            _setup.update(secs)


def setup_seconds() -> dict:
    """The latest published set-up's seconds by span name."""
    with _lock:
        return dict(_setup)

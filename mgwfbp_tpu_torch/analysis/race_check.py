"""Host-concurrency race checker: the THR rule family (the port's copy of
``mgwfbp_tpu/analysis/race_check.py``, over the port's tree).

The host side of the runtime is deliberately multi-threaded: the HTTP
serving plane (`telemetry/serve.py`), the fleet watcher
(`telemetry/fleet.py`), the watchdog (`utils/watchdog.py`), the loader
prefetch thread (`data/loader.py`), the async checkpoint writer
(`checkpoint.py`), EventWriter observer callbacks, and SIGTERM/SIGINT
handlers all share mutable trainer/telemetry state.  This pass proves
that sharing disciplined, statically:

1. **Context discovery** — thread entry points are read off the AST:
   ``threading.Thread(target=...)``, ``ThreadPoolExecutor.submit/map``,
   ``do_*`` methods on ``BaseHTTPRequestHandler`` subclasses,
   EventWriter ``observer=`` callbacks (including ``tee_observers``
   fan-out and ``x.observer = fn`` rebinds), ``signal.signal`` handlers
   (an async-signal context, stricter than a thread), and ``_watch``
   poll loops (merged into the main context when reachable by a
   synchronous call, as the supervisor's is).

2. **Effect signatures** — reusing the SPMD checker's interprocedural
   machinery (`spmd_check.Checker` call resolution + class/attr type
   inference), each function gets, to fixpoint: the locks it is
   guaranteed to hold on entry (must-hold intersection over analyzed
   call sites), the class-qualified shared attributes it writes and the
   locks held at each write, the blocking operations it reaches
   (``@group_op`` calls, file I/O, ``sleep``, HTTP), and stream
   write/close sites.

3. **THR rules** —
   THR001  shared attribute written from >= 2 concurrency contexts with
           no common lock across the writes (torn/lost update)
   THR002  lock-order inversion across contexts (ABBA deadlock)
   THR003  blocking op while holding a lock a serving-plane handler
           also takes (generalizes RUN006 beyond group ops)
   THR004  signal handler doing non-async-signal-safe work
   THR005  stream written without the lock its close() holds

Suppression is the ``# mgwfbp: thread-safe -- reason`` marker (on the
access line, the comment line directly above, or on/above the enclosing
``def`` for a function-level pin); consumption is tracked so ANA001
flags dead or reason-less pins.  ``# mgwfbp: noqa[THR00x]`` works too,
with the same honesty accounting.

Known holes (deliberate, to keep the pass fast and the FP rate near
zero): lambdas are not treated as entry points, callbacks stored in
plain attributes (``self.on_stall``) are not traced, and the must-hold
lock intersection under-reports locks held on only *some* call paths.

In the port the same rules discover the loader's prefetch thread
(``PrefetchLoader._iter_thread.feed``) and telemetry/serve.py's HTTP
handler (``_Handler``). The reducer's gradient hooks are left out: they
run on autograd's device thread while the step's own thread waits in
``backward()`` for them, so nothing they touch is written concurrently;
what they do inside the step is the step pass's business (SCH005).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Optional, Sequence

from mgwfbp_tpu_torch.analysis.rules import (
    Finding,
    SuppressionTracker,
    filter_suppressed,
    has_thread_safe_marker,
)
from mgwfbp_tpu_torch.analysis.spmd_check import (
    _FS_WRITE_TAILS,
    _PKG_ROOT,
    TRANSPORT_PATH,
    Checker,
    FuncInfo,
    ModuleInfo,
    _dotted,
    _expand_targets,
    _is_lock_expr,
    _load_module,
    _walk_no_defs,
    discover_group_ops,
)

# the host-concurrency surfaces (package-relative)
DEFAULT_THR_TARGETS = (
    "runtime",
    "serving",
    os.path.join("train", "trainer.py"),
    "checkpoint.py",
    os.path.join("telemetry", "serve.py"),
    os.path.join("telemetry", "fleet.py"),
    os.path.join("telemetry", "events.py"),
    os.path.join("telemetry", "recorder.py"),
    os.path.join("utils", "watchdog.py"),
    os.path.join("data", "loader.py"),
)

# constructors whose instances ARE synchronization primitives: calling
# their mutator methods (Event.set, Queue.put, ...) is synchronization,
# not a racy write — direct reassignment of the attribute still is
_SYNC_CTORS = {
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue", "deque",
}
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_THREAD_CTORS = {"Thread", "Timer"}

# method tails that mutate their receiver in place
_MUTATOR_TAILS = {
    "append", "appendleft", "extend", "add", "update", "pop", "popleft",
    "clear", "remove", "discard", "insert", "setdefault", "put",
    "put_nowait",
}
_STREAM_W_TAILS = {"write", "writelines", "flush"}
_HTTP_TAILS = {"urlopen", "getresponse", "request"}
_MULTI_INSTANCE = ("handler:", "executor:")


@dataclasses.dataclass(frozen=True)
class _Site:
    fnid: int
    path: str
    line: int
    locks: frozenset  # lexically-held lock keys at the site


@dataclasses.dataclass
class _FnEff:
    """Own (non-interprocedural) effects of one function body."""
    writes: dict = dataclasses.field(default_factory=dict)    # key->[Site]
    blocking: list = dataclasses.field(default_factory=list)  # (kind,name,Site)
    acquires: list = dataclasses.field(default_factory=list)  # (lock,Site)
    pairs: list = dataclasses.field(default_factory=list)     # (a,b,Site)
    stream_w: dict = dataclasses.field(default_factory=dict)  # key->[Site]
    stream_c: dict = dataclasses.field(default_factory=dict)  # key->[Site]
    calls: list = dataclasses.field(default_factory=list)     # (fi,locks,line)


def _modtail(mod: ModuleInfo) -> str:
    base = os.path.basename(mod.path)
    return base[:-3] if base.endswith(".py") else base


def _concurrent(a: Iterable[str], b: Iterable[str]) -> bool:
    """Can code running under context set `a` interleave with code under
    `b`?  Yes when the union spans two distinct contexts, or when they
    share a multi-instance context (several handler/executor threads run
    the same code simultaneously)."""
    sa, sb = set(a), set(b)
    if not sa or not sb:
        return False
    if len(sa | sb) > 1:
        return True
    return any(c.startswith(_MULTI_INSTANCE) for c in sa & sb)


class RaceChecker:
    """Whole-program host-concurrency analysis over `modules`."""

    def __init__(
        self,
        modules: Sequence[ModuleInfo],
        ops: dict,
        tracker: Optional[SuppressionTracker] = None,
        transport_base: str = "coordination.py",
    ):
        # the SPMD checker is the resolution substrate: class/function
        # indexes, call resolution, transport-primitive marking
        self.base = Checker(
            list(modules), ops, (), None, transport_base=transport_base
        )
        self.modules = self.base.modules
        self.tracker = tracker
        self._mod_by_path = {m.path: m for m in self.modules}
        self.fns: dict[int, FuncInfo] = {}
        self.all_funcs: list[FuncInfo] = []
        self.local_defs: dict[int, dict[str, FuncInfo]] = {}
        self.lock_attrs: set[tuple[str, str]] = set()
        self.sync_attrs: set[tuple[str, str]] = set()
        self.thread_attrs: set[tuple[str, str]] = set()
        self.eff: dict[int, _FnEff] = {}
        # (label, fi, lineno) — real concurrency contexts
        self.entries: list[tuple[str, FuncInfo, int]] = []
        # poll loops: listed as discovered, merged into main if reachable
        self.poll_entries: list[tuple[str, FuncInfo, int]] = []
        self.merged_polls: set[str] = set()
        self.ctx: dict[int, set] = {}
        self.inherited: dict[int, Optional[frozenset]] = {}
        self.findings: list[Finding] = []
        self._reported: set[tuple] = set()

    # -- model construction -------------------------------------------
    def _fill_types(self) -> None:
        """Constructor-based attribute typing (`self.x = ClassName(...)`)
        plus the sync-primitive / lock / thread attr registries."""
        for mod in self.modules:
            for fi in mod.functions.values():
                if fi.classname is None:
                    continue
                entry = self.base.class_index.get(fi.classname)
                if entry is None:
                    continue
                ci = entry[1]
                for node in _walk_no_defs(fi.node, skip_root_def=True):
                    if not (
                        isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                    ):
                        continue
                    cname = (_dotted(node.value.func) or "").rsplit(
                        ".", 1
                    )[-1]
                    for t in node.targets:
                        d = _dotted(t)
                        if not (
                            d and d.startswith("self.")
                            and d.count(".") == 1
                        ):
                            continue
                        attr = d.split(".", 1)[1]
                        if cname in self.base.class_index:
                            ci.attr_types.setdefault(attr, cname)
                        if cname in _LOCK_CTORS:
                            self.lock_attrs.add((fi.classname, attr))
                        if cname in _SYNC_CTORS:
                            self.sync_attrs.add((fi.classname, attr))
                        if cname in _THREAD_CTORS:
                            self.thread_attrs.add((fi.classname, attr))

    def _collect_funcs(self) -> None:
        roots = [
            fi for mod in self.modules for fi in mod.functions.values()
        ]
        for fi in roots:
            self._register_fn(fi)
            self._collect_nested(fi)

    def _register_fn(self, fi: FuncInfo) -> None:
        self.fns[id(fi)] = fi
        self.all_funcs.append(fi)

    def _collect_nested(self, parent: FuncInfo) -> None:
        """Nested defs (loader's `feed`/`job` pattern) get their own
        pseudo-FuncInfo so thread/executor targets resolve to them and
        their bodies are analyzed in their own context."""
        for node in self._immediate_nested(parent.node):
            fi = FuncInfo(
                f"{parent.qualname}.{node.name}", node, parent.module,
                parent.classname,
            )
            self.local_defs.setdefault(id(parent), {})[node.name] = fi
            self._register_fn(fi)
            self._collect_nested(fi)

    @staticmethod
    def _immediate_nested(root) -> list:
        out, stack = [], list(ast.iter_child_nodes(root))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(n)
            elif not isinstance(n, (ast.Lambda, ast.ClassDef)):
                stack.extend(ast.iter_child_nodes(n))
        return out

    def _discover_class_entries(self) -> None:
        for mod in self.modules:
            for cname, ci in mod.classes.items():
                bases = [
                    (_dotted(b) or "").rsplit(".", 1)[-1]
                    for b in ci.node.bases
                ]
                if any(b.endswith("RequestHandler") for b in bases):
                    # every method of a handler class runs on a serving
                    # thread — do_* are the entries, the rest helpers
                    for mname, mnode in ci.methods.items():
                        fi = mod.functions.get(f"{cname}.{mname}")
                        if fi is not None:
                            self.entries.append(
                                (f"handler:{cname}", fi, mnode.lineno)
                            )
                fi = mod.functions.get(f"{cname}._watch")
                if fi is not None:
                    self.poll_entries.append(
                        (f"poll:{cname}._watch", fi, fi.node.lineno)
                    )

    # -- lock / attr keys ---------------------------------------------
    def _shared_key(
        self, dotted: str, fi: FuncInfo, vt: dict, globals_decl: set,
        local_ctors: frozenset = frozenset(),
    ) -> Optional[str]:
        """Class-qualified key for a shared mutable target, or None for
        locals/unresolvables.  `self.X` -> `Class.X`; `self.Y.Z` and
        `var.Z` resolve the receiver class via constructor typing.
        Writes through a variable the function itself constructed
        (`out = Thing(); out.field = x`) are construction-before-
        publication — the builder pattern — and not shared."""
        parts = dotted.split(".")
        if parts[0] == "self" and fi.classname:
            if len(parts) == 2:
                return f"{fi.classname}.{parts[1]}"
            if len(parts) == 3:
                entry = self.base.class_index.get(fi.classname)
                tc = (
                    entry[1].attr_types.get(parts[1])
                    if entry else None
                )
                if tc:
                    return f"{tc}.{parts[2]}"
            return None
        if len(parts) == 2 and parts[0] in vt:
            if parts[0] in local_ctors:
                return None
            return f"{vt[parts[0]]}.{parts[1]}"
        if len(parts) == 1:
            if parts[0] in globals_decl or parts[0] in fi.module.consts:
                return f"{_modtail(fi.module)}.{parts[0]}"
        return None

    def _lock_key(
        self, node: ast.AST, fi: FuncInfo, vt: dict
    ) -> Optional[str]:
        """Class-qualified identity of a lock-like with-item (avoids
        conflating every class's `_lock` into one token)."""
        name = _dotted(node)
        if name is None and isinstance(node, ast.Call):
            name = _dotted(node.func)
        if name is None:
            return None
        parts = name.split(".")
        lockish = _is_lock_expr(node) is not None
        if parts[0] == "self" and fi.classname:
            if len(parts) == 2:
                if lockish or (fi.classname, parts[1]) in self.lock_attrs:
                    return f"{fi.classname}.{parts[1]}"
                return None
            if len(parts) == 3:
                entry = self.base.class_index.get(fi.classname)
                tc = (
                    entry[1].attr_types.get(parts[1])
                    if entry else None
                )
                if tc and (lockish or (tc, parts[2]) in self.lock_attrs):
                    return f"{tc}.{parts[2]}"
            return None
        if len(parts) == 2 and parts[0] in vt:
            if lockish or (vt[parts[0]], parts[1]) in self.lock_attrs:
                return f"{vt[parts[0]]}.{parts[1]}"
            return None
        if lockish:
            if len(parts) == 1 and parts[0] in fi.module.consts:
                return f"{_modtail(fi.module)}.{parts[0]}"
            if len(parts) >= 2:
                return ".".join(parts[-2:])
            return f"{fi.qualname}.{parts[0]}"
        return None

    def _var_types(self, fi: FuncInfo) -> tuple[dict, frozenset]:
        """Function-local `var -> ClassName` from `v = self.X`,
        `v = getattr(self, "X", ...)`, `v = ClassName(...)`, and
        `with ClassName(...) as v:` bindings.  Second return: the vars
        bound by a constructor call here (function-owned objects)."""
        vt: dict[str, str] = {}
        ctor_bound: set[str] = set()
        entry = (
            self.base.class_index.get(fi.classname)
            if fi.classname else None
        )
        attr_types = entry[1].attr_types if entry else {}

        def bind(name: str, value) -> None:
            attr = None
            if isinstance(value, ast.Attribute):
                d = _dotted(value)
                if d and d.startswith("self.") and d.count(".") == 1:
                    attr = d.split(".", 1)[1]
            elif isinstance(value, ast.Call):
                fnd = _dotted(value.func) or ""
                tail = fnd.rsplit(".", 1)[-1]
                if (
                    fnd == "getattr" and len(value.args) >= 2
                    and isinstance(value.args[0], ast.Name)
                    and value.args[0].id == "self"
                    and isinstance(value.args[1], ast.Constant)
                ):
                    attr = value.args[1].value
                elif tail in self.base.class_index:
                    vt[name] = tail
                    ctor_bound.add(name)
                    return
            if attr is not None and attr in attr_types:
                vt[name] = attr_types[attr]
                ctor_bound.discard(name)

        for node in _walk_no_defs(fi.node, skip_root_def=True):
            if (
                isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                bind(node.targets[0].id, node.value)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.optional_vars, ast.Name):
                        bind(item.optional_vars.id, item.context_expr)
        return vt, frozenset(ctor_bound)

    # -- the per-function effect walk ---------------------------------
    def _walk_fn(self, fi: FuncInfo) -> None:
        eff = _FnEff()
        self.eff[id(fi)] = eff
        if fi.is_op is not None:
            return  # transport primitives are atomic leaves
        mod = fi.module
        # `__init__` bodies contribute no shared writes: construction
        # happens-before publication of the object to any other thread
        is_init = fi.node.name == "__init__"
        globals_decl = {
            n for node in _walk_no_defs(fi.node, skip_root_def=True)
            if isinstance(node, ast.Global) for n in node.names
        }
        vt, local_ctors = self._var_types(fi)
        ldefs = self.local_defs.get(id(fi), {})

        def site(line: int, held) -> _Site:
            return _Site(id(fi), mod.path, line, frozenset(held))

        def record_write(key: Optional[str], line: int, held) -> None:
            if key is None or is_init:
                return
            sites = eff.writes.setdefault(key, [])
            if len(sites) < 8:
                sites.append(site(line, held))

        def resolve_callable(e) -> Optional[FuncInfo]:
            if isinstance(e, ast.Call):
                d = (_dotted(e.func) or "").rsplit(".", 1)[-1]
                if d == "partial" and e.args:
                    return resolve_callable(e.args[0])
                return None
            d = _dotted(e)
            if d is None:
                return None
            parts = d.split(".")
            if len(parts) == 1:
                if parts[0] in ldefs:
                    return ldefs[parts[0]]
                f2 = mod.functions.get(parts[0])
                if f2 is not None:
                    return f2
                src = mod.from_imports.get(parts[0])
                if src is not None:
                    return self.base._find_module_func(src[0], src[1])
                return None
            if parts[0] == "self" and fi.classname:
                if len(parts) == 2:
                    return self.base._lookup_method(
                        fi.classname, parts[1]
                    )
                if len(parts) == 3:
                    entry = self.base.class_index.get(fi.classname)
                    tc = (
                        entry[1].attr_types.get(parts[1])
                        if entry else None
                    )
                    if tc:
                        return self.base._lookup_method(tc, parts[2])
                return None
            if len(parts) == 2:
                if parts[0] in vt:
                    return self.base._lookup_method(
                        vt[parts[0]], parts[1]
                    )
                mt = mod.module_aliases.get(parts[0])
                if mt:
                    return self.base._find_module_func(mt, parts[1])
            return None

        def reg_entry(label_kind: str, e) -> None:
            tfi = resolve_callable(e)
            if tfi is not None:
                self.entries.append((
                    f"{label_kind}:{tfi.qualname}", tfi,
                    getattr(e, "lineno", fi.node.lineno),
                ))

        def reg_observers(e) -> None:
            if isinstance(e, ast.IfExp):
                reg_observers(e.body)
                reg_observers(e.orelse)
                return
            if isinstance(e, ast.Constant):
                return
            if isinstance(e, ast.Call):
                tail = (_dotted(e.func) or "").rsplit(".", 1)[-1]
                if tail == "tee_observers":
                    for a in e.args:
                        reg_observers(a)
                return
            reg_entry("observer", e)

        def mutable_receiver_key(recv: str) -> Optional[str]:
            key = self._shared_key(
                recv, fi, vt, globals_decl, local_ctors
            )
            if key is None:
                return None
            cls, _, attr = key.rpartition(".")
            if (cls, attr) in self.sync_attrs:
                return None  # Event.set / Queue.put are synchronization
            return key

        def handle_call(n: ast.Call, held) -> None:
            fn = _dotted(n.func)
            line = n.lineno
            tail = fn.rsplit(".", 1)[-1] if fn else ""
            recv = fn[: -(len(tail) + 1)] if fn and "." in fn else ""
            # -- entry-point registrations
            if tail in _THREAD_CTORS:
                for kw in n.keywords:
                    if kw.arg == "target" or (
                        tail == "Timer" and kw.arg == "function"
                    ):
                        reg_entry("thread", kw.value)
            elif tail == "submit" and n.args:
                reg_entry("executor", n.args[0])
            elif tail == "map" and n.args and any(
                h in recv.rsplit(".", 1)[-1].lower()
                for h in ("pool", "executor", "ex")
            ):
                reg_entry("executor", n.args[0])
            elif tail == "signal" and len(n.args) >= 2 and (
                recv.split(".")[0] in ("signal",)
                or mod.module_aliases.get(recv.split(".")[0])
                == "signal"
            ):
                reg_entry("signal", n.args[1])
            elif tail == "EventWriter":
                for kw in n.keywords:
                    if kw.arg == "observer":
                        reg_observers(kw.value)
            elif tail == "tee_observers":
                reg_observers(n)
            # -- resolution: group ops and analyzed-call edges
            res = self.base.resolve_call(n, mod, fi.classname)
            if res is None and fn and "." not in fn and fn in ldefs:
                res = ("fn", ldefs[fn])
            if res is not None:
                kind, obj = res
                if kind == "op":
                    if obj.blocking:
                        eff.blocking.append(
                            ("group_op", obj.name, site(line, held))
                        )
                    return
                if obj.is_op is not None:
                    if obj.is_op.blocking:
                        eff.blocking.append((
                            "group_op", obj.is_op.name,
                            site(line, held),
                        ))
                    return
                eff.calls.append((obj, frozenset(held), line))
                return
            if not fn:
                return
            # -- in-place mutators are writes to their receiver
            if tail in _MUTATOR_TAILS and recv:
                record_write(mutable_receiver_key(recv), line, held)
            # -- blocking operations
            root = recv.split(".")[0] if recv else ""
            if tail == "sleep":
                eff.blocking.append(("sleep", fn, site(line, held)))
            elif tail in _HTTP_TAILS:
                eff.blocking.append(("http", fn, site(line, held)))
            elif fn == "open":
                eff.blocking.append(("fs", fn, site(line, held)))
            elif tail in _FS_WRITE_TAILS and (
                root in mod.module_aliases or root in ("os", "np")
            ):
                eff.blocking.append(("fs", fn, site(line, held)))
            elif tail in _STREAM_W_TAILS and recv:
                eff.blocking.append(("fs", fn, site(line, held)))
                skey = mutable_receiver_key(recv)
                if skey is not None and not is_init:
                    eff.stream_w.setdefault(skey, []).append(
                        site(line, held)
                    )
            elif tail == "close" and recv:
                skey = mutable_receiver_key(recv)
                if skey is not None and not is_init:
                    eff.stream_c.setdefault(skey, []).append(
                        site(line, held)
                    )
            elif tail == "acquire" and isinstance(
                n.func, ast.Attribute
            ):
                lk = self._lock_key(n.func.value, fi, vt)
                if lk is not None:
                    s = site(line, held)
                    eff.acquires.append((lk, s))
                    for h in held:
                        if h != lk:
                            eff.pairs.append((h, lk, s))
            elif tail in ("wait", "join") and recv:
                key = self._shared_key(recv, fi, vt, globals_decl)
                if key is not None:
                    cls, _, attr = key.rpartition(".")
                    if (cls, attr) in self.sync_attrs | self.thread_attrs:
                        eff.blocking.append(
                            ("sync-wait", fn, site(line, held))
                        )

        def scan_expr(node, held) -> None:
            stack = [node]
            while stack:
                n = stack.pop()
                if isinstance(n, ast.Call):
                    handle_call(n, held)
                for c in ast.iter_child_nodes(n):
                    if not isinstance(c, (
                        ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda, ast.ClassDef,
                    )):
                        stack.append(c)

        def write_target(t, line: int, held) -> None:
            if isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    write_target(e, line, held)
            elif isinstance(t, ast.Starred):
                write_target(t.value, line, held)
            elif isinstance(t, ast.Attribute):
                d = _dotted(t)
                if d is not None:
                    record_write(
                        self._shared_key(
                            d, fi, vt, globals_decl, local_ctors
                        ),
                        line, held,
                    )
            elif isinstance(t, ast.Subscript):
                d = _dotted(t.value)
                if d is not None:
                    record_write(
                        self._shared_key(
                            d, fi, vt, globals_decl, local_ctors
                        ),
                        line, held,
                    )
            elif isinstance(t, ast.Name):
                if t.id in globals_decl:
                    record_write(
                        f"{_modtail(mod)}.{t.id}", line, held
                    )

        def visit(stmts, held) -> None:
            for stmt in stmts:
                if isinstance(stmt, (
                    ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                )):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    newheld = list(held)
                    for item in stmt.items:
                        scan_expr(item.context_expr, tuple(newheld))
                        lk = self._lock_key(item.context_expr, fi, vt)
                        if lk is not None:
                            s = site(stmt.lineno, newheld)
                            eff.acquires.append((lk, s))
                            for h in newheld:
                                if h != lk:
                                    eff.pairs.append((h, lk, s))
                            newheld.append(lk)
                    visit(stmt.body, tuple(newheld))
                    continue
                if isinstance(stmt, ast.If):
                    scan_expr(stmt.test, held)
                    visit(stmt.body, held)
                    visit(stmt.orelse, held)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    scan_expr(stmt.iter, held)
                    visit(stmt.body, held)
                    visit(stmt.orelse, held)
                    continue
                if isinstance(stmt, ast.While):
                    scan_expr(stmt.test, held)
                    visit(stmt.body, held)
                    visit(stmt.orelse, held)
                    continue
                if isinstance(stmt, ast.Try):
                    visit(stmt.body, held)
                    for h in stmt.handlers:
                        visit(h.body, held)
                    visit(stmt.orelse, held)
                    visit(stmt.finalbody, held)
                    continue
                if hasattr(ast, "Match") and isinstance(
                    stmt, ast.Match
                ):
                    scan_expr(stmt.subject, held)
                    for case in stmt.cases:
                        visit(case.body, held)
                    continue
                # simple statement: calls anywhere inside, then targets
                scan_expr(stmt, held)
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        write_target(t, stmt.lineno, held)
                        if (
                            isinstance(t, ast.Attribute)
                            and t.attr == "observer"
                        ):
                            reg_observers(stmt.value)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    write_target(stmt.target, stmt.lineno, held)

        visit(fi.node.body, ())

    # -- interprocedural fixpoints ------------------------------------
    def _build_graph(self) -> None:
        edges: dict[int, list[tuple[int, frozenset]]] = {}
        callers: dict[int, set[int]] = {}
        for fi in self.all_funcs:
            for callee, held, _line in self.eff[id(fi)].calls:
                if id(callee) not in self.fns:
                    continue
                edges.setdefault(id(fi), []).append((id(callee), held))
                callers.setdefault(id(callee), set()).add(id(fi))
        entry_ids = {id(fi) for _l, fi, _ in self.entries}
        # public-API assumption: an analyzed function nobody analyzed
        # calls and that is not a thread entry runs on the main thread
        main_seeds = [
            fi for fi in self.all_funcs
            if id(fi) not in entry_ids and not callers.get(id(fi))
            and fi.is_op is None
        ]
        # main-reachability fixpoint (to merge synchronous _watch polls)
        reach_main: set[int] = {id(fi) for fi in main_seeds}
        changed = True
        while changed:
            changed = False
            for src, outs in edges.items():
                if src in reach_main:
                    for dst, _h in outs:
                        if dst not in reach_main:
                            reach_main.add(dst)
                            changed = True
        live_entries = list(self.entries)
        for label, fi, line in self.poll_entries:
            if id(fi) in reach_main or id(fi) in entry_ids:
                self.merged_polls.add(label)
            else:
                live_entries.append((label, fi, line))
        self.entries = live_entries
        # context fixpoint: labels flow down call edges
        ctx: dict[int, set] = {}
        for fi in main_seeds:
            ctx.setdefault(id(fi), set()).add("main")
        for label, fi, _line in self.entries:
            ctx.setdefault(id(fi), set()).add(label)
        changed = True
        while changed:
            changed = False
            for src, outs in edges.items():
                src_ctx = ctx.get(src)
                if not src_ctx:
                    continue
                for dst, _h in outs:
                    d = ctx.setdefault(dst, set())
                    if not src_ctx <= d:
                        d |= src_ctx
                        changed = True
        self.ctx = ctx
        # must-hold inherited locks: intersection over analyzed call
        # sites of (caller's inherited | locks lexically held at the
        # call); entries and main seeds start lock-free
        inh: dict[int, Optional[frozenset]] = {
            id(fi): None for fi in self.all_funcs
        }
        for fi in main_seeds:
            inh[id(fi)] = frozenset()
        for _label, fi, _line in self.entries:
            inh[id(fi)] = frozenset()
        for _ in range(24):
            changed = False
            for src, outs in edges.items():
                got = inh.get(src)
                if got is None:
                    continue
                for dst, held in outs:
                    cand = got | held
                    prev = inh.get(dst)
                    new = cand if prev is None else prev & cand
                    if new != prev:
                        inh[dst] = new
                        changed = True
            if not changed:
                break
        self.inherited = inh

    def _eff_locks(self, s: _Site) -> frozenset:
        return s.locks | (self.inherited.get(s.fnid) or frozenset())

    def _site_ctx(self, s: _Site) -> set:
        return self.ctx.get(s.fnid, set())

    # -- thread-safe pins ---------------------------------------------
    def _pin_line(self, mod: ModuleInfo, lineno: int) -> Optional[int]:
        own = mod.comments.get(lineno)
        if own is not None and has_thread_safe_marker(own):
            return lineno
        # a contiguous comment block directly above the line: reasons
        # long enough to be honest rarely fit one line, so the marker
        # may open a multi-line block
        ln = lineno - 1
        while (
            2 <= ln <= len(mod.lines)
            and mod.lines[ln - 1].strip().startswith("#")
        ):
            cm = mod.comments.get(ln)
            if cm is not None and has_thread_safe_marker(cm):
                return ln
            ln -= 1
        return None

    def _find_pin(
        self, sites: Iterable[_Site]
    ) -> Optional[tuple[str, int]]:
        """A `# mgwfbp: thread-safe` marker covering any of `sites`: on
        the access line, the comment line directly above it, or on/above
        the enclosing `def` (a function-level pin)."""
        for s in sites:
            mod = self._mod_by_path.get(s.path)
            if mod is None:
                continue
            fi = self.fns.get(s.fnid)
            cands = [s.line]
            if fi is not None:
                cands.append(fi.node.lineno)
            for line in cands:
                ml = self._pin_line(mod, line)
                if ml is not None:
                    return (s.path, ml)
        return None

    def _report(
        self, s: _Site, rule: str, msg: str,
        pin_sites: Iterable[_Site],
    ) -> None:
        key = (s.path, s.line, rule)
        if key in self._reported:
            return
        pin = self._find_pin(pin_sites)
        if pin is not None:
            self._reported.add(key)
            if self.tracker is not None:
                self.tracker.note_threadsafe_used(*pin)
                # retained for --json: the finding existed and a
                # documented pin hid it (same contract as noqa)
                self.tracker.suppressed_findings.append(
                    Finding(s.path, s.line, rule, msg)
                )
            return
        self._reported.add(key)
        self.findings.append(Finding(s.path, s.line, rule, msg))

    # -- rule evaluation ----------------------------------------------
    def _evaluate(self) -> None:
        self._eval_thr001()
        self._eval_thr002()
        self._eval_thr003()
        self._eval_thr004()
        self._eval_thr005()

    def _live(self, sites: Iterable[_Site]) -> list[_Site]:
        return [s for s in sites if self._site_ctx(s)]

    def _eval_thr001(self) -> None:
        agg: dict[str, list[_Site]] = {}
        for fi in self.all_funcs:
            for key, sites in self.eff[id(fi)].writes.items():
                dst = agg.setdefault(key, [])
                for s in sites:
                    if len(dst) < 24:
                        dst.append(s)
        for key in sorted(agg):
            live = self._live(agg[key])
            hit = None
            for i, a in enumerate(live):
                for b in live[i:]:
                    if not _concurrent(
                        self._site_ctx(a), self._site_ctx(b)
                    ):
                        continue
                    if self._eff_locks(a) & self._eff_locks(b):
                        continue
                    hit = (a, b)
                    break
                if hit:
                    break
            if hit is None:
                continue
            a, b = hit
            labels = sorted(self._site_ctx(a) | self._site_ctx(b))
            other = (
                f"also written at {os.path.basename(a.path)}:{a.line}"
                if a is not b else "a single site two contexts reach"
            )
            self._report(
                b, "THR001",
                f"shared state '{key}' written from concurrency "
                f"contexts {{{', '.join(labels)}}} with no common lock "
                f"({other}) — torn/lost update; add locking or pin "
                "with '# mgwfbp: thread-safe -- <reason>'",
                live,
            )

    def _eval_thr002(self) -> None:
        ordered: dict[tuple[str, str], list[_Site]] = {}
        for fi in self.all_funcs:
            e = self.eff[id(fi)]
            pairs = list(e.pairs)
            inherited = self.inherited.get(id(fi)) or frozenset()
            for lk, s in e.acquires:
                for h in inherited:
                    if h != lk and h not in s.locks:
                        pairs.append((h, lk, s))
            for a, b, s in pairs:
                dst = ordered.setdefault((a, b), [])
                if len(dst) < 4:
                    dst.append(s)
        seen: set[frozenset] = set()
        for (a, b), sites in sorted(ordered.items()):
            rev = ordered.get((b, a))
            if rev is None or frozenset((a, b)) in seen:
                continue
            hit = None
            for s1 in self._live(sites):
                for s2 in self._live(rev):
                    if _concurrent(
                        self._site_ctx(s1), self._site_ctx(s2)
                    ):
                        hit = (s1, s2)
                        break
                if hit:
                    break
            if hit is None:
                continue
            seen.add(frozenset((a, b)))
            s1, s2 = hit
            self._report(
                s1, "THR002",
                f"lock-order inversion: '{a}' then '{b}' here, but "
                f"'{b}' then '{a}' at "
                f"{os.path.basename(s2.path)}:{s2.line} — concurrent "
                "contexts can deadlock (ABBA); pick one global order",
                [s1, s2],
            )

    def _eval_thr003(self) -> None:
        handler_locks: set[str] = set()
        for fi in self.all_funcs:
            if any(
                c.startswith("handler:")
                for c in self.ctx.get(id(fi), ())
            ):
                for lk, _s in self.eff[id(fi)].acquires:
                    handler_locks.add(lk)
        if not handler_locks:
            return
        for fi in self.all_funcs:
            for kind, name, s in self.eff[id(fi)].blocking:
                if not self._site_ctx(s):
                    continue
                inter = sorted(self._eff_locks(s) & handler_locks)
                if not inter:
                    continue
                self._report(
                    s, "THR003",
                    f"blocking {kind} '{name}' while holding "
                    f"'{inter[0]}', a lock the serving-plane handlers "
                    "also take — one slow or wedged call here freezes "
                    "the observability plane; move the call outside "
                    "the lock",
                    [s],
                )

    def _eval_thr004(self) -> None:
        for fi in self.all_funcs:
            sigs = sorted(
                c for c in self.ctx.get(id(fi), ())
                if c.startswith("signal:")
            )
            if not sigs:
                continue
            e = self.eff[id(fi)]
            for lk, s in e.acquires:
                self._report(
                    s, "THR004",
                    f"signal handler ({sigs[0]}) acquires '{lk}' — the "
                    "interrupted thread may already hold it (self-"
                    "deadlock); handlers must only set flags",
                    [s],
                )
            for kind, name, s in e.blocking:
                self._report(
                    s, "THR004",
                    f"signal handler ({sigs[0]}) performs {kind} "
                    f"'{name}' — not async-signal-safe; set a flag and "
                    "let the step loop act on it",
                    [s],
                )

    def _eval_thr005(self) -> None:
        agg_w: dict[str, list[_Site]] = {}
        agg_c: dict[str, list[_Site]] = {}
        for fi in self.all_funcs:
            e = self.eff[id(fi)]
            for key, sites in e.stream_w.items():
                agg_w.setdefault(key, []).extend(sites[:8])
            for key, sites in e.stream_c.items():
                agg_c.setdefault(key, []).extend(sites[:8])
        for key in sorted(set(agg_w) & set(agg_c)):
            hit = None
            for w in self._live(agg_w[key]):
                for c in self._live(agg_c[key]):
                    if not _concurrent(
                        self._site_ctx(w), self._site_ctx(c)
                    ):
                        continue
                    if self._eff_locks(w) & self._eff_locks(c):
                        continue
                    hit = (w, c)
                    break
                if hit:
                    break
            if hit is None:
                continue
            w, c = hit
            self._report(
                w, "THR005",
                f"stream '{key}' written without the lock its close() "
                f"holds (closed at {os.path.basename(c.path)}:{c.line})"
                " — a concurrent close can land mid-record or after "
                "the file is gone; take the same lock",
                [w, c],
            )

    # -- driver --------------------------------------------------------
    def run(self) -> list[Finding]:
        self._fill_types()
        self._collect_funcs()
        self._discover_class_entries()
        for fi in self.all_funcs:
            self._walk_fn(fi)
        self._build_graph()
        self._evaluate()
        out: list[Finding] = []
        by_mod: dict[str, list[Finding]] = {}
        for f in self.findings:
            by_mod.setdefault(f.file, []).append(f)
        if self.tracker is not None:
            self.tracker.note_value_pass(
                "thread-safe", (m.path for m in self.modules),
            )
        for mod in self.modules:
            if self.tracker is not None:
                self.tracker.scan_source(mod.path, mod.source)
            out.extend(filter_suppressed(
                sorted(
                    by_mod.get(mod.path, []),
                    key=lambda f: (f.line, f.rule_id),
                ),
                mod.lines, self.tracker,
            ))
        return out

    def discovered_contexts(self) -> list[tuple[str, str, str, int]]:
        """(label, qualname, path, line) per discovered entry, for the
        README's threading-model table and the tests; merged `_watch`
        polls are labelled explicitly."""
        out = []
        for label, fi, line in self.entries:
            out.append((label, fi.qualname, fi.module.path, line))
        for label, fi, line in self.poll_entries:
            if label in self.merged_polls:
                out.append((
                    f"{label} (merged into main)", fi.qualname,
                    fi.module.path, line,
                ))
        return sorted(set(out))


# --- entry points ----------------------------------------------------------

def _build(
    paths: Optional[Sequence[str]],
    transport_path: Optional[str],
    tracker: Optional[SuppressionTracker],
) -> RaceChecker:
    if paths is None:
        paths = [os.path.join(_PKG_ROOT, t) for t in DEFAULT_THR_TARGETS]
    ops = discover_group_ops(transport_path)
    modules = [
        m for m in (_load_module(p) for p in _expand_targets(paths))
        if m is not None
    ]
    return RaceChecker(
        modules, ops, tracker,
        transport_base=os.path.basename(
            transport_path or TRANSPORT_PATH
        ),
    )


def check_paths(
    paths: Optional[Sequence[str]] = None,
    transport_path: Optional[str] = None,
    tracker: Optional[SuppressionTracker] = None,
) -> list[Finding]:
    """Run the THR family over the host-concurrency surfaces
    (`DEFAULT_THR_TARGETS` when `paths` is None)."""
    return _build(paths, transport_path, tracker).run()


def check_sources(
    sources: dict[str, str],
    transport_path: Optional[str] = None,
    tracker: Optional[SuppressionTracker] = None,
) -> list[Finding]:
    """Test hook: run the checker over in-memory sources ({path: src})."""
    ops = discover_group_ops(transport_path)
    modules = [ModuleInfo(p, s) for p, s in sources.items()]
    return RaceChecker(
        modules, ops, tracker,
        transport_base=os.path.basename(
            transport_path or TRANSPORT_PATH
        ),
    ).run()


def discover_contexts(
    paths: Optional[Sequence[str]] = None,
    transport_path: Optional[str] = None,
) -> list[tuple[str, str, str, int]]:
    """Discovered concurrency contexts over `paths` (defaults to the
    shipped THR surfaces)."""
    rc = _build(paths, transport_path, None)
    rc._fill_types()
    rc._collect_funcs()
    rc._discover_class_entries()
    for fi in rc.all_funcs:
        rc._walk_fn(fi)
    rc._build_graph()
    return rc.discovered_contexts()

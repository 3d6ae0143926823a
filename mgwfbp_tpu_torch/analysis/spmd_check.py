"""SPMD lockstep checker: static deadlock-freedom for the host protocol
(the port's copy of ``mgwfbp_tpu/analysis/spmd_check.py``, retargeted at
the port's tree and at torch's process identity).

The schedule verifier proves the observed step realizes the merge
schedule; this pass proves the HOST-side multi-process protocol around it
stays in lockstep. MG-WFBP's wait-free scheduling (arXiv:1811.11141) and the
DeAR-style cross-step pipelining it composes with (arXiv:2302.12445)
both assume synchronous data-parallel SGD: every process executes the
IDENTICAL sequence of group operations (`agree_any` / `agree_all` /
`barrier` / `broadcast_flag` / `gather_*` / `all_argmin` /
`agree_uniform` — anything `runtime/coordination.py` decorates with
``@group_op``). A group op reached by only SOME processes deadlocks the
group; until this pass the only gate was the 2-process live smoke's
hard timeout. This pass catches the divergence in seconds, statically.

Model
-----
Per analyzed function the checker enumerates the possible group-op
SEQUENCES along control-flow paths (branches, loops 0-or-1 unrolled,
early exits), expanding calls through per-function *effect signatures*
(a real interprocedural pass: wrappers like ``Trainer._agreed_preempt``
or ``Checkpointer._commit_barrier`` carry their callee's ops, one
fixpoint over the whole target set). Conditions are classified on a
three-point lattice:

  UNIFORM  provably identical on every process: constants, static
           config, ``process_count()``, results of group ops whose
           ``uniform_result`` is declared (the agreement sanitizers),
           env vars (the supervisor exports ONE environment — except
           the per-process identity vars), and anything annotated
           ``# mgwfbp: group-uniform -- reason``;
  LOCAL    provably process-local: ``process_index()`` /
           ``is_primary()``, ``dist.get_rank()``, the identity
           variables (MGWFBP_PROCESS_ID, RANK, LOCAL_RANK, SLURM_LOCALID,
           OMPI_COMM_WORLD_LOCAL_RANK and the launchers'), local
           RNG, wall clocks, local-filesystem probes, and
           ``self._preempt``-style flags (attributes ever assigned from
           a local source);
  UNKNOWN  everything else.

Branches explicitly comparing ``process_count()`` against 1 are
resolved to their MULTI-HOST arm — the single-process short-circuits
are not part of the protocol. In the port the same holds for the torch
world size (``dist.get_world_size()``, ``parallel.mesh.world_size()``),
for a ``self.X`` the class only ever assigns one of those (the trainer's
``self.world``: one process per rank), and for ``dist.is_initialized()``
(True in a group).

Rules
-----
  RUN001  a group op control-dependent on a LOCAL condition;
  RUN002  branch arms executing different group-op sequences under a
          condition not proven UNIFORM (join-point sequence mismatch);
  RUN003  an early ``return``/``raise``/``continue`` that skips a group
          op another path still executes (the skipped-barrier hang);
  RUN004  a primary-only (process-0-gated) filesystem side effect not
          followed by a group op (commit barrier) on all paths;
  RUN005  a group op inside a ``try`` whose broad handler swallows the
          exception and proceeds (one process drops out of lockstep);
  RUN006  a group op reachable while holding a lock the serving plane
          (telemetry/serve.py, telemetry/fleet.py) also takes — the
          HTTP-handler <-> step-loop deadlock.

Suppression: the shared ``# mgwfbp: noqa[RUNnnn] -- reason`` grammar;
``# mgwfbp: group-uniform -- reason`` on a condition or assignment
declares a fact the analysis cannot see (both accounted by ANA001, so a
dead annotation cannot mask a future regression).

Deliberate limits (documented, not accidental): nested ``def``/lambda
bodies are not entered (the protocol surfaces keep group ops at
function level), implicit exceptions (an OSError out of ``np.save``)
are not modeled as edges — RUN005 covers the swallow side and the
commit protocol itself must agree on success (see
``Checkpointer.save_sharded``), and attribute types are inferred only
from ``self.x = ClassName(...)`` construction sites.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Any, Iterable, Optional, Sequence

from mgwfbp_tpu_torch.analysis.rules import (
    Finding,
    SuppressionTracker,
    comment_lines,
    filter_suppressed,
    has_group_uniform_marker,
    parse_source,
    tree_nodes,
)

# --- lattice ---------------------------------------------------------------
UNIFORM, UNKNOWN, LOCAL = 0, 1, 2


def _join(*states: int) -> int:
    return max(states) if states else UNIFORM


# --- group-op discovery ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupOp:
    name: str
    blocking: bool = True
    uniform_result: bool = True


_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSPORT_PATH = os.path.join(_PKG_ROOT, "runtime", "coordination.py")

# the protocol surfaces (package-relative); runtime/ is scanned whole
DEFAULT_TARGETS = (
    "runtime",
    os.path.join("train", "trainer.py"),
    "checkpoint.py",
    os.path.join("parallel", "autotune.py"),
    os.path.join("telemetry", "drift.py"),
)
# scanned for serving-plane lock acquisitions (RUN006) only
DEFAULT_SERVING = (
    os.path.join("telemetry", "serve.py"),
    os.path.join("telemetry", "fleet.py"),
)


def discover_group_ops(
    transport_path: Optional[str] = None,
) -> dict[str, GroupOp]:
    """AST-discover ``@group_op``-decorated functions in the transport
    module. Discovery is static on purpose: the op list is read from the
    same decorations that register the runtime registry
    (`coordination.GROUP_OPS`), so neither can drift from the other —
    a new primitive is discovered the moment it is decorated."""
    path = transport_path or TRANSPORT_PATH
    with open(path, "r", encoding="utf-8") as f:
        tree = parse_source(f.read(), path)
    ops: dict[str, GroupOp] = {}
    for node in tree_nodes(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = _dotted(target)
            if name is None or name.rsplit(".", 1)[-1] != "group_op":
                continue
            kw = {"blocking": True, "uniform_result": True}
            if isinstance(dec, ast.Call):
                for k in dec.keywords:
                    if k.arg in kw and isinstance(k.value, ast.Constant):
                        kw[k.arg] = bool(k.value.value)
            ops[node.name] = GroupOp(node.name, **kw)
    return ops


# --- small AST helpers -----------------------------------------------------

def _dotted(node: ast.AST) -> Optional[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_WALLCLOCK_TAILS = {
    "time", "perf_counter", "monotonic", "process_time", "time_ns",
    "perf_counter_ns", "monotonic_ns", "now", "utcnow",
}
_WALLCLOCK_ROOTS = {"time", "datetime"}
_FS_PROBE_TAILS = {
    "exists", "isfile", "isdir", "listdir", "stat", "scandir", "getsize",
    "getmtime", "glob", "iglob", "walk", "load", "loadtxt", "read_text",
    "read_bytes",
}
_FS_WRITE_TAILS = {
    "save", "savez", "dump", "replace", "rename", "makedirs", "mkdir",
    "rmtree", "remove", "unlink", "move", "copy", "copyfile", "copytree",
    "write_text", "write_bytes", "fsync",
}
# the per-process identity variables: the launcher's rank and the
# port's local-card selection (parallel/mesh.py)
_LOCAL_ENV_KEYS = {
    "MGWFBP_PROCESS_ID", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK",
    "LOCAL_RANK", "RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK",
}
# process-count calls: the JAX package's ``process_count`` and the torch
# world size (``dist.get_world_size``, ``parallel.mesh.world_size``)
_COUNT_TAILS = {"process_count", "get_world_size", "world_size"}
_PASSTHROUGH_BUILTINS = {
    "int", "float", "bool", "str", "len", "min", "max", "abs", "sum",
    "sorted", "tuple", "list", "dict", "set", "frozenset", "round",
    "any", "all", "repr", "zip", "enumerate", "range", "isinstance",
    "getattr", "hasattr", "type", "divmod",
}
_PASSTHROUGH_METHODS = {
    "get", "copy", "items", "keys", "values", "strip", "split", "lower",
    "upper", "format", "join", "startswith", "endswith", "rsplit",
    "popleft", "pop",
}
_BUILTIN_NAMES = {
    "dict", "list", "tuple", "set", "str", "int", "float", "bool",
    "bytes", "object", "type", "len", "Exception", "ValueError",
    "TypeError", "KeyError", "RuntimeError", "OSError",
}
_BROAD_EXC = {
    "Exception", "BaseException", "RuntimeError", "OSError", "IOError",
    "TimeoutError", "EnvironmentError",
}
_NORETURN_CALLS = {"exit", "_exit", "abort"}  # sys.exit / os._exit / os.abort


def _is_lock_expr(node: ast.AST) -> Optional[str]:
    """A with-item context manager that looks like a lock; returns its
    token (last name segment) or None."""
    name = _dotted(node)
    if name is None and isinstance(node, ast.Call):
        name = _dotted(node.func)
    if name is None:
        return None
    tail = name.rsplit(".", 1)[-1].lower()
    if "lock" in tail or "mutex" in tail or tail in ("cond", "condition"):
        return name.rsplit(".", 1)[-1]
    return None


def _env_key_of(call: ast.Call, fn: str) -> Optional[str]:
    """The env-var name read by os.environ.get / os.getenv, when constant."""
    tail = fn.rsplit(".", 1)[-1]
    if tail not in ("get", "getenv"):
        return None
    if "environ" not in fn and tail != "getenv":
        return None
    if call.args and isinstance(call.args[0], ast.Constant) and isinstance(
        call.args[0].value, str
    ):
        return call.args[0].value
    return None


# --- per-module model ------------------------------------------------------

class ModuleInfo:
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = parse_source(source, path)
        self.coord_aliases: set[str] = set()
        self.op_imports: dict[str, str] = {}  # local name -> op name
        self.module_aliases: dict[str, str] = {}  # alias -> module tail
        # bare name -> (source module tail, original name), from
        # `from pkg.mod import name [as alias]`
        self.from_imports: dict[str, tuple[str, str]] = {}
        self.consts: dict[str, int] = {}
        self.functions: dict[str, "FuncInfo"] = {}  # qualname
        self.classes: dict[str, "ClassInfo"] = {}
        # real comment tokens only — docstrings quoting the grammar are
        # not annotations
        self.comments: dict[int, str] = comment_lines(source) or {}
        self._scan_imports()
        self._scan_consts()

    def _scan_imports(self) -> None:
        for node in tree_nodes(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    tail = a.name.rsplit(".", 1)[-1]
                    bound = a.asname or a.name.split(".", 1)[0]
                    if a.name.endswith("coordination"):
                        self.coord_aliases.add(bound)
                    else:
                        self.module_aliases[bound] = tail
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    bound = a.asname or a.name
                    if a.name == "coordination":
                        self.coord_aliases.add(bound)
                    elif mod.endswith("coordination"):
                        self.op_imports[bound] = a.name
                    else:
                        self.module_aliases[bound] = a.name
                        self.from_imports[bound] = (
                            mod.rsplit(".", 1)[-1], a.name
                        )

    def _scan_consts(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    self.consts[t.id] = UNIFORM

    def uniform_marker_line(self, lineno: int) -> Optional[int]:
        """The line carrying a ``# mgwfbp: group-uniform`` marker for the
        statement starting at `lineno`: the line itself, or — the
        own-line convention for statements too long to tag inline — the
        comment line directly above it. Returns the MARKER's line (for
        ANA001 usage accounting) or None."""
        own = self.comments.get(lineno)
        if own is not None and has_group_uniform_marker(own):
            return lineno
        prev = self.comments.get(lineno - 1)
        if prev is not None and has_group_uniform_marker(prev) and (
            2 <= lineno <= len(self.lines) + 1
            and self.lines[lineno - 2].strip().startswith("#")
        ):
            return lineno - 1
        return None

    def line_has_uniform_marker(self, lineno: int) -> bool:
        return self.uniform_marker_line(lineno) is not None


class ClassInfo:
    def __init__(self, name: str, node: ast.ClassDef):
        self.name = name
        self.node = node
        self.attr_state: dict[str, int] = {}
        self.attr_pinned: set[str] = set()  # group-uniform annotated
        # attr -> (module path, marker line): consumed when a READ would
        # otherwise classify non-uniform (a redundant pin stays unused
        # and ANA001 flags it)
        self.attr_pin_lines: dict[str, tuple[str, int]] = {}
        self.attr_types: dict[str, str] = {}  # attr -> ClassName
        self.methods: dict[str, ast.FunctionDef] = {}
        # attributes only ever assigned a process count (the trainer's
        # ``self.world = world_size()``): compared against a constant they
        # resolve like ``process_count()``
        self.count_attrs: set[str] = set()


@dataclasses.dataclass
class FuncInfo:
    qualname: str
    node: Any
    module: ModuleInfo
    classname: Optional[str]
    seq: tuple = ()  # representative group-op sequence (callee-expanded)
    guaranteed: bool = False  # >= 1 op on EVERY multi-host path
    returns: int = UNKNOWN
    fs_write: bool = False
    is_op: Optional[GroupOp] = None  # the transport primitives themselves
    env: dict = dataclasses.field(default_factory=dict)
    primary_vars: set = dataclasses.field(default_factory=set)
    # param name -> joined lattice state over every ANALYZED call site
    # (a param nobody calls stays absent -> UNKNOWN)
    param_states: dict = dataclasses.field(default_factory=dict)


# --- the checker -----------------------------------------------------------

_SEQ_CAP = 40          # ops kept per path sequence
_SET_CAP = 48          # path sequences kept per program point


class _SeqSet:
    """A bounded set of group-op sequences; `overflow` poisons
    comparisons (never report on truncated evidence)."""

    __slots__ = ("seqs", "overflow")

    def __init__(self, seqs: frozenset, overflow: bool = False):
        self.seqs = seqs
        self.overflow = overflow or len(seqs) > _SET_CAP
        if len(seqs) > _SET_CAP:
            self.seqs = frozenset(sorted(seqs)[:_SET_CAP])

    @staticmethod
    def single(seq: tuple = ()) -> "_SeqSet":
        return _SeqSet(frozenset([seq]))

    def prepend(self, ops: Sequence[str]) -> "_SeqSet":
        if not ops:
            return self
        ops = tuple(ops)
        return _SeqSet(
            frozenset((ops + s)[:_SEQ_CAP] for s in self.seqs),
            self.overflow,
        )

    def union(self, other: "_SeqSet") -> "_SeqSet":
        return _SeqSet(
            self.seqs | other.seqs, self.overflow or other.overflow
        )

    def all_contain_op(self) -> bool:
        return not self.overflow and all(len(s) > 0 for s in self.seqs)

    def comparable(self, other: "_SeqSet") -> bool:
        return not (self.overflow or other.overflow)


class _Cont:
    """Interned continuation: execute stmts[i:] (with loop context), then
    `nxt`. Loop contexts are (break_cont, continue_cont) pairs."""

    __slots__ = ("stmts", "i", "lctx", "nxt")

    def __init__(self, stmts, i, lctx, nxt):
        self.stmts = stmts
        self.i = i
        self.lctx = lctx
        self.nxt = nxt


class Checker:
    def __init__(
        self,
        modules: Sequence[ModuleInfo],
        ops: dict[str, GroupOp],
        serving_modules: Sequence[ModuleInfo] = (),
        tracker: Optional[SuppressionTracker] = None,
        transport_base: str = "coordination.py",
    ):
        self.modules = list(modules)
        self.ops = ops
        self.serving_modules = list(serving_modules)
        self.tracker = tracker
        self.transport_base = transport_base
        self.findings: list[Finding] = []
        self._reported: set[tuple] = set()
        # RUN004 is two-phase: candidates recorded during the per-function
        # walks, then exonerated when EVERY analyzed call site of the
        # containing helper is followed by a guaranteed group op (the
        # `_write_index` pattern: the p0 write commits at the caller)
        self._run004: list[tuple[FuncInfo, int]] = []
        self._callsites: dict[int, list[bool]] = {}  # id(FuncInfo) -> flags
        self.class_index: dict[str, tuple[ModuleInfo, ClassInfo]] = {}
        self.func_index: dict[str, FuncInfo] = {}  # "modtail.qualname"
        self.serving_locks: set[str] = set()
        self._collect()

    # -- model construction -------------------------------------------
    def _collect(self) -> None:
        for mod in self.modules:
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    ci = ClassInfo(node.name, node)
                    mod.classes[node.name] = ci
                    self.class_index.setdefault(node.name, (mod, ci))
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            ci.methods[item.name] = item
                            q = f"{node.name}.{item.name}"
                            fi = FuncInfo(q, item, mod, node.name)
                            mod.functions[q] = fi
                    ci.count_attrs = _count_attrs(node)
                elif isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    fi = FuncInfo(node.name, node, mod, None)
                    mod.functions[node.name] = fi
        for mod in self.modules:
            is_transport = (
                os.path.basename(mod.path) == self.transport_base
            )
            for q, fi in mod.functions.items():
                if (
                    is_transport
                    and fi.classname is None
                    and fi.node.name in self.ops
                ):
                    # the decorated primitives ARE the atomic ops: their
                    # summary is themselves, and their single-process
                    # short-circuit bodies are not re-derived
                    fi.is_op = self.ops[fi.node.name]
                    fi.seq = (fi.node.name,)
                    fi.guaranteed = True
                    fi.returns = UNIFORM
                key = self._func_key(mod, q)
                self.func_index[key] = fi
        self._collect_serving_locks()

    def _func_key(self, mod: ModuleInfo, qualname: str) -> str:
        tail = os.path.basename(mod.path)
        return f"{tail}:{qualname}"

    def _collect_serving_locks(self) -> None:
        for mod in self.serving_modules:
            for node in tree_nodes(mod.tree):
                if isinstance(node, ast.With):
                    for item in node.items:
                        tok = _is_lock_expr(item.context_expr)
                        if tok:
                            self.serving_locks.add(tok)

    # -- call resolution ----------------------------------------------
    def resolve_call(
        self, call: ast.Call, mod: ModuleInfo, classname: Optional[str]
    ):
        """('op', GroupOp) | ('fn', FuncInfo) | None."""
        fn = _dotted(call.func)
        if fn is None:
            return None
        parts = fn.split(".")
        if parts[0] in mod.coord_aliases and len(parts) == 2:
            op = self.ops.get(parts[1])
            if op:
                return ("op", op)
            return None
        if len(parts) == 1 and parts[0] in mod.op_imports:
            op = self.ops.get(mod.op_imports[parts[0]])
            if op:
                return ("op", op)
        if parts[0] == "self" and classname:
            _m, ci = self.class_index.get(classname, (None, None))
            if ci is not None:
                if len(parts) == 2 and parts[1] in ci.methods:
                    return ("fn", self._lookup_method(classname, parts[1]))
                if len(parts) == 3 and parts[1] in ci.attr_types:
                    target_cls = ci.attr_types[parts[1]]
                    m = self._lookup_method(target_cls, parts[2])
                    if m is not None:
                        return ("fn", m)
            return None
        if len(parts) == 1:
            fi = mod.functions.get(parts[0])
            if fi is not None:
                return ("fn", fi)
            cls = self.class_index.get(parts[0])
            if cls is not None:
                init = self._lookup_method(parts[0], "__init__")
                if init is not None:
                    return ("fn", init)
            src = mod.from_imports.get(parts[0])
            if src is not None:
                mod_tail, orig = src
                target = self._find_module_func(mod_tail, orig)
                if target is not None:
                    return ("fn", target)
        if len(parts) == 2:
            target_mod_tail = mod.module_aliases.get(parts[0])
            if target_mod_tail:
                target = self._find_module_func(target_mod_tail, parts[1])
                if target is not None:
                    return ("fn", target)
        return None

    def _find_module_func(
        self, mod_tail: str, name: str
    ) -> Optional[FuncInfo]:
        for m2 in self.modules:
            if os.path.basename(m2.path) == mod_tail + ".py":
                return m2.functions.get(name)
        return None

    def _lookup_method(
        self, classname: str, method: str
    ) -> Optional[FuncInfo]:
        entry = self.class_index.get(classname)
        if entry is None:
            return None
        mod, _ci = entry
        return mod.functions.get(f"{classname}.{method}")

    def _consume_uniform_marker(self, mod: ModuleInfo, lineno: int) -> bool:
        ml = mod.uniform_marker_line(lineno)
        if ml is None:
            return False
        if self.tracker is not None:
            self.tracker.note_uniform_used(mod.path, ml)
        return True

    # -- expression classification ------------------------------------
    def classify(
        self, node: ast.AST, fi: FuncInfo, _depth: int = 0
    ) -> int:
        state = self._classify_inner(node, fi, _depth)
        if state != UNIFORM:
            # a group-uniform marker is consumed only when it actually
            # FLIPS a classification — a marker on an already-uniform
            # value is dead and ANA001 reports it
            line = getattr(node, "lineno", 0)
            if line and self._consume_uniform_marker(fi.module, line):
                return UNIFORM
        return state

    def _classify_inner(
        self, node: ast.AST, fi: FuncInfo, _depth: int = 0
    ) -> int:
        if node is None or _depth > 25:
            return UNIFORM if node is None else UNKNOWN
        mod = fi.module
        if isinstance(node, ast.Constant):
            return UNIFORM
        if isinstance(node, ast.Name):
            if node.id in fi.env:
                return fi.env[node.id]
            if node.id in mod.consts:
                return UNIFORM
            if node.id.isupper():  # imported ALL_CAPS constant
                return UNIFORM
            if node.id in _BUILTIN_NAMES:
                return UNIFORM
            return UNKNOWN
        if isinstance(node, ast.Attribute):
            full = _dotted(node)
            if full is not None:
                parts = full.split(".")
                if any(p in ("config", "cfg") for p in parts):
                    return UNIFORM
                if parts[0] == "self" and fi.classname:
                    entry = self.class_index.get(fi.classname)
                    if entry is not None:
                        _m, ci = entry
                        if parts[1] in ci.attr_pinned:
                            raw = ci.attr_state.get(parts[1], UNKNOWN)
                            if raw != UNIFORM and self.tracker is not None:
                                pin = ci.attr_pin_lines.get(parts[1])
                                if pin is not None:
                                    self.tracker.note_uniform_used(*pin)
                            return UNIFORM
                        # `self._preempt*`-style flags are set by signal
                        # handlers — the canonical process-local source
                        if "preempt" in parts[1]:
                            return LOCAL
                        st = ci.attr_state.get(parts[1])
                        if st is not None:
                            return st
                    return UNKNOWN
            return self.classify(node.value, fi, _depth + 1)
        if isinstance(node, ast.Subscript):
            return self.classify(node.value, fi, _depth + 1)
        if isinstance(node, ast.UnaryOp):
            return self.classify(node.operand, fi, _depth + 1)
        if isinstance(node, ast.BoolOp):
            return _join(*[
                self.classify(v, fi, _depth + 1) for v in node.values
            ])
        if isinstance(node, ast.BinOp):
            return _join(
                self.classify(node.left, fi, _depth + 1),
                self.classify(node.right, fi, _depth + 1),
            )
        if isinstance(node, ast.Compare):
            return _join(
                self.classify(node.left, fi, _depth + 1),
                *[self.classify(c, fi, _depth + 1) for c in node.comparators]
            )
        if isinstance(node, ast.IfExp):
            return _join(
                self.classify(node.test, fi, _depth + 1),
                self.classify(node.body, fi, _depth + 1),
                self.classify(node.orelse, fi, _depth + 1),
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _join(*[
                self.classify(e, fi, _depth + 1) for e in node.elts
            ])
        if isinstance(node, ast.Call):
            return self._classify_call(node, fi, _depth)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            it_state = _join(*[
                self.classify(g.iter, fi, _depth + 1)
                for g in node.generators
            ])
            # comprehension targets carry the iterable's state while the
            # element expression is classified
            names = [
                n.id for g in node.generators
                for n in ast.walk(g.target) if isinstance(n, ast.Name)
            ]
            saved = {n: fi.env.get(n) for n in names}
            for n in names:
                fi.env[n] = it_state
            try:
                parts = (
                    [node.key, node.value]
                    if isinstance(node, ast.DictComp) else [node.elt]
                )
                return _join(it_state, *[
                    self.classify(p, fi, _depth + 1) for p in parts
                ])
            finally:
                for n, st in saved.items():
                    if st is None:
                        fi.env.pop(n, None)
                    else:
                        fi.env[n] = st
        if isinstance(node, ast.Lambda):
            return UNIFORM
        return UNKNOWN

    def _classify_call(
        self, call: ast.Call, fi: FuncInfo, _depth: int
    ) -> int:
        fn = _dotted(call.func)
        if fn is None:
            # `(expr or "").strip()`-style: method on a non-Name chain
            if isinstance(call.func, ast.Attribute) and (
                call.func.attr in _PASSTHROUGH_METHODS
            ):
                return _join(
                    self.classify(call.func.value, fi, _depth + 1),
                    *[self.classify(a, fi, _depth + 1) for a in call.args]
                )
            return UNKNOWN
        tail = fn.rsplit(".", 1)[-1]
        root = fn.split(".", 1)[0]
        if tail in _COUNT_TAILS or tail == "is_initialized":
            return UNIFORM
        if tail in ("process_index", "is_primary", "getpid", "gethostname",
                    "get_rank"):
            return LOCAL
        if root in _WALLCLOCK_ROOTS and tail in _WALLCLOCK_TAILS:
            return LOCAL
        if root in ("random",) or fn.startswith(
            ("np.random.", "numpy.random.")
        ):
            return LOCAL
        key = _env_key_of(call, fn)
        if key is not None:
            return LOCAL if key in _LOCAL_ENV_KEYS else UNIFORM
        if "environ" in fn:
            return UNKNOWN
        if fn == "open" or tail in _FS_PROBE_TAILS and root in (
            "os", "glob", "np", "numpy", "json", "shutil"
        ):
            return LOCAL
        res = self.resolve_call(call, fi.module, fi.classname)
        if res is not None:
            kind, target = res
            if kind == "op":
                # only ops DECLARED uniform_result sanitize — a future
                # primitive without the declaration must not silently
                # launder a non-uniform value into a branch condition
                return UNIFORM if target.uniform_result else UNKNOWN
            return target.returns
        args_state = _join(*[
            self.classify(a, fi, _depth + 1) for a in call.args
        ]) if call.args else UNIFORM
        if fn in _PASSTHROUGH_BUILTINS:
            return args_state
        if tail in _PASSTHROUGH_METHODS:
            return _join(
                self.classify(call.func, fi, _depth + 1), args_state
            )
        return UNKNOWN

    # -- multi-host resolution of process_count() comparisons ----------
    def _is_count(self, node: ast.AST, fi: Optional[FuncInfo]) -> bool:
        """``process_count()`` / ``dist.get_world_size()`` /
        ``world_size()``, or ``self.X`` where the class only ever assigns
        X one of those (the port's one-process-per-rank world)."""
        if isinstance(node, ast.Call):
            return (_dotted(node.func) or "").rsplit(".", 1)[-1] in (
                _COUNT_TAILS
            )
        full = _dotted(node)
        if full is None or fi is None or fi.classname is None:
            return False
        parts = full.split(".")
        if len(parts) != 2 or parts[0] != "self":
            return False
        entry = self.class_index.get(fi.classname)
        return entry is not None and parts[1] in entry[1].count_attrs

    def _strip_mh(self, test: ast.AST, fi: Optional[FuncInfo] = None):
        """('const', bool) when the test is decided by multi-host
        (process_count() vs 1 comparisons; ``dist.is_initialized()``,
        True in a group), ('nodes', [remaining]) otherwise — remaining
        terms classify the residual condition."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            kind, payload = self._strip_mh(test.operand, fi)
            if kind == "const":
                return ("const", not payload)
            return ("nodes", [test])
        if isinstance(test, ast.Call) and (
            (_dotted(test.func) or "").rsplit(".", 1)[-1] == "is_initialized"
        ):
            return ("const", True)
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            left, right = test.left, test.comparators[0]
            pc_left = self._is_count(left, fi)
            pc_right = self._is_count(right, fi)
            const = None
            if pc_left and isinstance(right, ast.Constant):
                const = right.value
                op = test.ops[0]
            elif pc_right and isinstance(left, ast.Constant):
                const = left.value
                op = {
                    ast.Gt: ast.Lt, ast.Lt: ast.Gt, ast.GtE: ast.LtE,
                    ast.LtE: ast.GtE,
                }.get(type(test.ops[0]), type(test.ops[0]))()
            if const is not None and isinstance(const, int):
                # evaluate with process_count >= 2
                if isinstance(op, ast.Eq):
                    return ("const", False) if const <= 1 else (
                        "nodes", [test]
                    )
                if isinstance(op, ast.NotEq):
                    return ("const", True) if const <= 1 else (
                        "nodes", [test]
                    )
                if isinstance(op, ast.Gt):
                    return ("const", True) if const <= 1 else (
                        "nodes", [test]
                    )
                if isinstance(op, ast.GtE):
                    return ("const", True) if const <= 2 else (
                        "nodes", [test]
                    )
                if isinstance(op, ast.Lt):
                    return ("const", False) if const <= 2 else (
                        "nodes", [test]
                    )
                if isinstance(op, ast.LtE):
                    return ("const", False) if const <= 1 else (
                        "nodes", [test]
                    )
        if isinstance(test, ast.BoolOp):
            is_and = isinstance(test.op, ast.And)
            remaining: list[ast.AST] = []
            for v in test.values:
                kind, payload = self._strip_mh(v, fi)
                if kind == "const":
                    if is_and and payload is False:
                        return ("const", False)
                    if not is_and and payload is True:
                        return ("const", True)
                    continue  # neutral term drops out
                remaining.extend(payload)
            if not remaining:
                return ("const", is_and)
            return ("nodes", remaining)
        return ("nodes", [test])

    def _classify_test(self, test: ast.AST, fi: FuncInfo) -> Optional[int]:
        """None when multi-host-resolved (caller already pruned);
        otherwise lattice state of the residual condition."""
        kind, payload = self._strip_mh(test, fi)
        if kind == "const":
            return None
        return _join(*[self.classify(n, fi) for n in payload])

    # -- env / attribute passes ----------------------------------------
    def _env_pass(self, fi: FuncInfo, ci: Optional[ClassInfo]) -> None:
        """Variable environment (last-write-wins, so the canonical
        sanitize-rebind `x = coord.agree_all(x)` lowers x to UNIFORM) +
        self.X attribute joins + call-site-inferred parameter states."""
        fi.env = {}
        for p, st in fi.param_states.items():
            fi.env[p] = st
        fi.primary_vars = set()
        mod = fi.module

        def is_primary_expr(expr) -> bool:
            if isinstance(expr, ast.Call):
                t = (_dotted(expr.func) or "").rsplit(".", 1)[-1]
                return t == "is_primary"
            if isinstance(expr, ast.Compare) and len(expr.ops) == 1:
                if isinstance(expr.ops[0], ast.Eq):
                    sides = [expr.left, expr.comparators[0]]
                    has_zero = any(
                        isinstance(s, ast.Constant) and s.value == 0
                        for s in sides
                    )
                    has_pidx = any(
                        isinstance(s, ast.Call)
                        and (_dotted(s.func) or "").endswith("process_index")
                        for s in sides
                    )
                    return has_zero and has_pidx
            return False

        for node in _walk_no_defs(fi.node, skip_root_def=True):
            if isinstance(node, ast.Assign):
                state = self.classify(node.value, fi)
                if mod.uniform_marker_line(node.lineno) is not None:
                    state = UNIFORM
                for t in node.targets:
                    self._bind_target(t, state, fi, ci, node)
                if is_primary_expr(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            fi.primary_vars.add(t.id)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                state = self.classify(node.value, fi)
                if mod.uniform_marker_line(node.lineno) is not None:
                    state = UNIFORM
                self._bind_target(node.target, state, fi, ci, node)
            elif isinstance(node, ast.AugAssign):
                state = _join(
                    self.classify(node.target, fi),
                    self.classify(node.value, fi),
                )
                if mod.uniform_marker_line(node.lineno) is not None:
                    state = UNIFORM
                self._bind_target(node.target, state, fi, ci, node)
            elif isinstance(node, ast.For):
                state = self.classify(node.iter, fi)
                self._bind_target(node.target, state, fi, ci, node)

    def _bind_target(
        self, target, state: int, fi: FuncInfo,
        ci: Optional[ClassInfo], stmt,
    ) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind_target(e, state, fi, ci, stmt)
            return
        if isinstance(target, ast.Name):
            fi.env[target.id] = state  # last write wins (see _env_pass)
            return
        if isinstance(target, ast.Attribute) and ci is not None:
            full = _dotted(target)
            if full and full.startswith("self.") and full.count(".") == 1:
                attr = full.split(".", 1)[1]
                ml = fi.module.uniform_marker_line(stmt.lineno)
                if ml is not None:
                    ci.attr_pinned.add(attr)
                    ci.attr_pin_lines.setdefault(
                        attr, (fi.module.path, ml)
                    )
                    state = UNIFORM  # the marker asserts THIS value too
                prev = ci.attr_state.get(attr, UNIFORM)
                ci.attr_state[attr] = _join(prev, state)
                # constructor-based attribute type inference
                if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call
                ):
                    cname = (_dotted(stmt.value.func) or "").rsplit(
                        ".", 1
                    )[-1]
                    if cname in self.class_index:
                        ci.attr_types[attr] = cname

    # -- effect summaries (fixpoint) -----------------------------------
    def compute_summaries(self, rounds: int = 4) -> None:
        funcs = [
            fi for mod in self.modules for fi in mod.functions.values()
        ]
        for _ in range(rounds):
            changed = False
            for fi in funcs:
                ci = (
                    self.class_index[fi.classname][1]
                    if fi.classname else None
                )
                self._env_pass(fi, ci)
                if fi.is_op is not None:
                    continue
                seq = tuple(self._struct_seq(fi.node.body, fi))[:_SEQ_CAP]
                guaranteed = self._guaranteed(list(fi.node.body), fi)
                returns = self._returns_state(fi)
                fs_write = self._has_fs_write(fi.node.body, fi)
                new = (seq, guaranteed, returns, fs_write)
                if new != (fi.seq, fi.guaranteed, fi.returns, fi.fs_write):
                    fi.seq, fi.guaranteed = seq, guaranteed
                    fi.returns, fi.fs_write = returns, fs_write
                    changed = True
            if self._infer_param_states(funcs):
                changed = True
            if not changed:
                break

    def _infer_param_states(self, funcs: Sequence[FuncInfo]) -> bool:
        """Join every ANALYZED call site's argument states into the
        callee's parameter states (interprocedural taint: a cadence flag
        passed only as a literal is group-uniform at the callee too).
        Joins are monotone, so the enclosing fixpoint converges."""
        changed = False
        for fi in funcs:
            for call in _walk_no_defs(fi.node, skip_root_def=True):
                if not isinstance(call, ast.Call):
                    continue
                res = self.resolve_call(call, fi.module, fi.classname)
                if res is None or res[0] != "fn":
                    continue
                callee = res[1]
                a = callee.node.args
                params = [p.arg for p in [*a.posonlyargs, *a.args]]
                if callee.classname is not None and params[:1] == ["self"]:
                    params = params[1:]
                bound: dict[str, int] = {}
                for i, arg in enumerate(call.args):
                    if isinstance(arg, ast.Starred):
                        break
                    if i < len(params):
                        bound[params[i]] = self.classify(arg, fi)
                for kw in call.keywords:
                    if kw.arg is not None:
                        bound[kw.arg] = self.classify(kw.value, fi)
                # unpassed params take their default's state
                defaults = a.defaults
                if defaults:
                    for p, d in zip(params[-len(defaults):], defaults):
                        if p not in bound:
                            bound[p] = self.classify(d, callee)
                for p, kwd in zip(
                    [k.arg for k in a.kwonlyargs], a.kw_defaults
                ):
                    if p not in bound and kwd is not None:
                        bound[p] = self.classify(kwd, callee)
                for p, st in bound.items():
                    prev = callee.param_states.get(p)
                    nxt = st if prev is None else _join(prev, st)
                    if nxt != prev:
                        callee.param_states[p] = nxt
                        changed = True
        return changed

    def _call_ops(self, call: ast.Call, fi: FuncInfo) -> tuple:
        res = self.resolve_call(call, fi.module, fi.classname)
        if res is None:
            return ()
        kind, target = res
        if kind == "op":
            return (target.name,)
        return tuple(target.seq)

    def _stmt_ops(self, stmt, fi: FuncInfo) -> list[str]:
        """Group ops issued by the statement's OWN expressions (compound
        bodies excluded — they flow through continuations)."""
        out: list[str] = []
        for expr in _own_exprs(stmt):
            if expr is None:
                continue
            for sub in _walk_no_defs(expr):
                if isinstance(sub, ast.Call):
                    out.extend(self._call_ops(sub, fi))
        return out

    def _struct_seq(self, stmts, fi: FuncInfo, depth: int = 0) -> list[str]:
        """Representative op sequence (for call-site expansion)."""
        if depth > 40:
            return []
        out: list[str] = []
        for stmt in stmts:
            out.extend(self._stmt_ops(stmt, fi))
            if isinstance(stmt, ast.If):
                kind, _ = self._strip_mh(stmt.test, fi)
                if kind == "const":
                    arm = stmt.body if _ else stmt.orelse
                    out.extend(self._struct_seq(arm, fi, depth + 1))
                else:
                    t = self._struct_seq(stmt.body, fi, depth + 1)
                    e = self._struct_seq(stmt.orelse, fi, depth + 1)
                    out.extend(t if len(t) >= len(e) else e)
            elif isinstance(stmt, (ast.For, ast.While)):
                out.extend(self._struct_seq(stmt.body, fi, depth + 1))
                out.extend(self._struct_seq(stmt.orelse, fi, depth + 1))
            elif isinstance(stmt, ast.Try):
                out.extend(self._struct_seq(stmt.body, fi, depth + 1))
                out.extend(self._struct_seq(stmt.orelse, fi, depth + 1))
                out.extend(self._struct_seq(stmt.finalbody, fi, depth + 1))
            elif isinstance(stmt, ast.With):
                out.extend(self._struct_seq(stmt.body, fi, depth + 1))
            if isinstance(stmt, (ast.Return, ast.Raise)):
                break
            if len(out) >= _SEQ_CAP:
                break
        return out[:_SEQ_CAP]

    def _stmt_guaranteed(self, stmt, fi: FuncInfo) -> bool:
        for expr in _own_exprs(stmt):
            if expr is None:
                continue
            for sub in _walk_no_defs(expr):
                if isinstance(sub, ast.Call):
                    res = self.resolve_call(sub, fi.module, fi.classname)
                    if res is None:
                        continue
                    kind, target = res
                    if kind == "op" or target.guaranteed:
                        return True
        return False

    def _guaranteed(self, stmts: list, fi: FuncInfo, depth: int = 0) -> bool:
        """>= 1 group op on every path through `stmts` (multi-host arms)."""
        if depth > 60:
            return False
        for i, stmt in enumerate(stmts):
            rest = stmts[i + 1:]
            if self._stmt_guaranteed(stmt, fi):
                return True
            if isinstance(stmt, (ast.Return, ast.Raise)):
                return False
            if isinstance(stmt, ast.If):
                kind, _ = self._strip_mh(stmt.test, fi)
                if kind == "const":
                    arm = stmt.body if _ else stmt.orelse
                    return self._guaranteed(
                        list(arm) + rest, fi, depth + 1
                    )
                return self._guaranteed(
                    list(stmt.body) + rest, fi, depth + 1
                ) and self._guaranteed(
                    list(stmt.orelse) + rest, fi, depth + 1
                )
            if isinstance(stmt, ast.With):
                return self._guaranteed(
                    list(stmt.body) + rest, fi, depth + 1
                )
            if isinstance(stmt, ast.Try):
                return self._guaranteed(
                    list(stmt.body) + list(stmt.orelse)
                    + list(stmt.finalbody) + rest, fi, depth + 1,
                )
            if isinstance(stmt, (ast.For, ast.While)):
                continue  # loop may run zero times; scan the rest
            if isinstance(stmt, (ast.Break, ast.Continue)):
                return False
        return False

    def _returns_state(self, fi: FuncInfo) -> int:
        """Join of reachable MULTI-HOST return expressions — returns
        inside `process_count() == 1` short-circuits are not part of the
        protocol (`_agreed_preempt` returns its raw local flag there but
        the agreed value on every multi-host path)."""
        states: list[int] = []

        def visit(stmts) -> None:
            for stmt in stmts:
                if isinstance(stmt, ast.Return):
                    states.append(
                        self.classify(stmt.value, fi)
                        if stmt.value is not None else UNIFORM
                    )
                elif isinstance(stmt, ast.If):
                    kind, payload = self._strip_mh(stmt.test, fi)
                    if kind == "const":
                        visit(stmt.body if payload else stmt.orelse)
                    else:
                        visit(stmt.body)
                        visit(stmt.orelse)
                elif isinstance(stmt, (ast.For, ast.While)):
                    visit(stmt.body)
                    visit(stmt.orelse)
                elif isinstance(stmt, ast.Try):
                    visit(stmt.body)
                    for h in stmt.handlers:
                        visit(h.body)
                    visit(stmt.orelse)
                    visit(stmt.finalbody)
                elif isinstance(stmt, ast.With):
                    visit(stmt.body)

        visit(list(fi.node.body))
        if not states:
            return UNIFORM  # implicit None
        return _join(*states)

    def _has_fs_write(self, stmts, fi: FuncInfo) -> bool:
        for stmt in stmts:
            for node in _walk_no_defs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                fn = _dotted(node.func)
                if fn is None:
                    continue
                tail = fn.rsplit(".", 1)[-1]
                if tail in _FS_WRITE_TAILS:
                    return True
                if fn == "open":
                    mode = None
                    if len(node.args) >= 2 and isinstance(
                        node.args[1], ast.Constant
                    ):
                        mode = node.args[1].value
                    for k in node.keywords:
                        if k.arg == "mode" and isinstance(
                            k.value, ast.Constant
                        ):
                            mode = k.value.value
                    if isinstance(mode, str) and any(
                        c in mode for c in "wax+"
                    ):
                        return True
                res = self.resolve_call(node, fi.module, fi.classname)
                if res is not None and res[0] == "fn" and res[1].fs_write:
                    return True
        return False

    # -- findings ------------------------------------------------------
    def _report(
        self, fi: FuncInfo, line: int, rule: str, msg: str
    ) -> None:
        key = (fi.module.path, line, rule)
        if key in self._reported:
            return
        self._reported.add(key)
        self.findings.append(Finding(fi.module.path, line, rule, msg))

    def check(self) -> list[Finding]:
        self.compute_summaries()
        for mod in self.modules:
            for fi in mod.functions.values():
                if fi.is_op is not None:
                    continue
                self._check_function(fi)
                self._check_locks(fi)
        self._resolve_run004()
        out: list[Finding] = []
        by_mod: dict[str, list[Finding]] = {}
        for f in self.findings:
            by_mod.setdefault(f.file, []).append(f)
        if self.tracker is not None:
            self.tracker.note_value_pass(
                "group-uniform", (m.path for m in self.modules),
            )
        for mod in self.modules:
            fs = by_mod.get(mod.path, [])
            if self.tracker is not None:
                self.tracker.scan_source(mod.path, mod.source)
            out.extend(filter_suppressed(
                sorted(fs, key=lambda f: (f.line, f.rule_id)),
                mod.lines, self.tracker,
            ))
        for mod in self.serving_modules:
            if self.tracker is not None:
                self.tracker.scan_source(mod.path, mod.source)
        return out

    # continuation machinery ------------------------------------------
    def _check_function(self, fi: FuncInfo) -> None:
        memo: dict[tuple, _SeqSet] = {}
        conts: dict[tuple, _Cont] = {}

        def make_cont(stmts, i, lctx, nxt) -> Optional[_Cont]:
            key = (id(stmts), i, lctx, id(nxt) if nxt else 0)
            c = conts.get(key)
            if c is None:
                c = _Cont(tuple(stmts), i, lctx, nxt)
                conts[key] = c
            return c

        def seqs(cont: Optional[_Cont]) -> _SeqSet:
            if cont is None:
                return _SeqSet.single()
            key = (id(cont.stmts), cont.i, cont.lctx,
                   id(cont.nxt) if cont.nxt else 0)
            hit = memo.get(key)
            if hit is not None:
                return hit
            memo[key] = _SeqSet.single()  # cycle guard (shouldn't occur)
            result = self._seqs_step(fi, cont, seqs, make_cont)
            memo[key] = result
            return result

        body = list(fi.node.body)
        seqs(make_cont(body, 0, (), None))

    def _seqs_step(self, fi, cont, seqs, make_cont) -> _SeqSet:
        stmts, i, lctx, nxt = cont.stmts, cont.i, cont.lctx, cont.nxt
        if i >= len(stmts):
            return seqs(nxt)
        stmt = stmts[i]
        rest = make_cont(stmts, i + 1, lctx, nxt)
        ops = self._stmt_ops(stmt, fi)

        if isinstance(stmt, (ast.Return, ast.Raise)):
            self._record_callsites(fi, stmt, _SeqSet.single())
            return _SeqSet.single(tuple(ops))
        if isinstance(stmt, ast.Break):
            return seqs(lctx[-1][0]).prepend(ops) if lctx else (
                _SeqSet.single(tuple(ops))
            )
        if isinstance(stmt, ast.Continue):
            return seqs(lctx[-1][1]).prepend(ops) if lctx else (
                _SeqSet.single(tuple(ops))
            )
        if isinstance(stmt, ast.If):
            return self._seqs_if(fi, stmt, ops, rest, lctx, seqs, make_cont)
        if isinstance(stmt, (ast.For, ast.While)):
            after = (
                make_cont(stmt.orelse, 0, lctx, rest)
                if stmt.orelse else rest
            )
            lctx2 = lctx + ((rest, after),)
            body_c = make_cont(stmt.body, 0, lctx2, after)
            return seqs(after).union(seqs(body_c)).prepend(ops)
        if isinstance(stmt, ast.Try):
            return self._seqs_try(fi, stmt, ops, rest, lctx, seqs, make_cont)
        if isinstance(stmt, ast.With):
            return seqs(make_cont(stmt.body, 0, lctx, rest)).prepend(ops)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return seqs(rest)
        self._record_callsites(fi, stmt, seqs(rest))
        return seqs(rest).prepend(ops)

    def _seqs_if(
        self, fi, stmt, ops, rest, lctx, seqs, make_cont
    ) -> _SeqSet:
        kind, _payload = self._strip_mh(stmt.test, fi)
        if kind == "const":
            arm = stmt.body if _payload else stmt.orelse
            c = make_cont(arm, 0, lctx, rest) if arm else rest
            return seqs(c).prepend(ops)
        t = seqs(make_cont(stmt.body, 0, lctx, rest))
        e = (
            seqs(make_cont(stmt.orelse, 0, lctx, rest))
            if stmt.orelse else seqs(rest)
        )
        if t.comparable(e) and t.seqs != e.seqs:
            state = self._classify_test(stmt.test, fi)
            if state is not None and state != UNIFORM and (
                self._consume_uniform_marker(fi.module, stmt.lineno)
            ):
                # marker on the `if` line of a multi-line condition whose
                # non-uniform term sits on a continuation line
                state = UNIFORM
            if state == LOCAL:
                diff = _diff_ops(t.seqs, e.seqs)
                self._report(
                    fi, stmt.lineno, "RUN001",
                    f"in '{fi.qualname}': group op(s) {diff} are "
                    "control-dependent on a process-local condition — "
                    "processes will take different arms and issue "
                    "mismatched collectives (agree on the decision "
                    "first: agree_any/agree_all/broadcast_flag)",
                )
            elif state == UNKNOWN:
                exit_stmt = _trailing_exit(stmt.body) or (
                    _trailing_exit(stmt.orelse) if stmt.orelse else None
                )
                if exit_stmt is not None:
                    diff = _diff_ops(t.seqs, e.seqs)
                    self._report(
                        fi, exit_stmt.lineno, "RUN003",
                        f"in '{fi.qualname}': this early "
                        f"{_exit_kind(exit_stmt)} skips group op(s) "
                        f"{diff} that another path still executes — a "
                        "process leaving here deadlocks peers waiting in "
                        "the op (prove the condition group-uniform or "
                        "restructure so every path balances)",
                    )
                else:
                    diff = _diff_ops(t.seqs, e.seqs)
                    self._report(
                        fi, stmt.lineno, "RUN002",
                        f"in '{fi.qualname}': branch arms execute "
                        f"different group-op sequences ({diff}) under a "
                        "condition not proven group-uniform — annotate "
                        "'# mgwfbp: group-uniform -- reason' if it is, or "
                        "agree on it first",
                    )
        # RUN004: primary-gated filesystem side effect needs a commit
        # barrier (any group op) downstream on every path
        self._check_primary_write(fi, stmt, rest, seqs)
        return t.union(e).prepend(ops)

    def _record_callsites(self, fi, stmt, rest_seqs: _SeqSet) -> None:
        """Note, for every resolved function call in this statement,
        whether a guaranteed group op follows at THIS call site (feeds
        RUN004 exoneration)."""
        follows = (not rest_seqs.overflow) and rest_seqs.all_contain_op()
        for expr in _own_exprs(stmt):
            if expr is None:
                continue
            for sub in _walk_no_defs(expr):
                if isinstance(sub, ast.Call):
                    res = self.resolve_call(sub, fi.module, fi.classname)
                    if res is not None and res[0] == "fn":
                        self._callsites.setdefault(
                            id(res[1]), []
                        ).append(follows)

    def _check_primary_write(self, fi, stmt, rest, seqs) -> None:
        arm = self._primary_arm(stmt, fi)
        if arm is None:
            return
        if arm == "rest":
            # `if not is_primary(): return` — the p0 side is the block
            # remainder
            arm_stmts = list(rest.stmts[rest.i:])
        else:
            arm_stmts = list(arm)
        if not self._has_fs_write(arm_stmts, fi):
            return
        if self._arm_has_op(arm_stmts, fi):
            return  # RUN001's territory (op inside a local-gated arm)
        cont_seqs = seqs(rest)
        if cont_seqs.overflow:
            return
        if arm != "rest" and self._guaranteed(arm_stmts, fi):
            return
        if arm == "rest" or not cont_seqs.all_contain_op():
            if arm == "rest" and self._guaranteed(arm_stmts, fi):
                return
            self._run004.append((fi, stmt.lineno))

    def _resolve_run004(self) -> None:
        for fi, line in self._run004:
            flags = self._callsites.get(id(fi))
            if flags and all(flags):
                continue  # every analyzed caller commits after the call
            self._report(
                fi, line, "RUN004",
                f"in '{fi.qualname}': primary-only side effect "
                "(process-0-gated write) is not followed by a commit "
                "barrier / group op on every path — peers can race past "
                "the uncommitted write (or exit before it is durable)",
            )

    def _primary_arm(self, stmt: ast.If, fi: FuncInfo):
        """The statements executed ONLY on process 0, when the branch is
        primary-gated; None otherwise."""
        def test_primary(test) -> Optional[bool]:
            # True -> body is the p0 arm; False -> orelse is
            if isinstance(test, ast.UnaryOp) and isinstance(
                test.op, ast.Not
            ):
                inner = test_primary(test.operand)
                return None if inner is None else (not inner)
            if isinstance(test, ast.Call):
                t = (_dotted(test.func) or "").rsplit(".", 1)[-1]
                if t == "is_primary":
                    return True
            if isinstance(test, ast.Name) and test.id in fi.primary_vars:
                return True
            if isinstance(test, ast.Compare) and len(test.ops) == 1:
                sides = [test.left, test.comparators[0]]
                has_zero = any(
                    isinstance(s, ast.Constant) and s.value == 0
                    for s in sides
                )
                has_pidx = any(
                    isinstance(s, ast.Call)
                    and (_dotted(s.func) or "").endswith("process_index")
                    for s in sides
                )
                if has_zero and has_pidx:
                    if isinstance(test.ops[0], ast.Eq):
                        return True
                    if isinstance(test.ops[0], ast.NotEq):
                        return False
            if isinstance(test, ast.BoolOp) and isinstance(
                test.op, ast.And
            ):
                for v in test.values:
                    r = test_primary(v)
                    if r is True:
                        return True
            return None

        which = test_primary(stmt.test)
        if which is True:
            return stmt.body
        if which is False and stmt.orelse:
            return stmt.orelse
        if which is False and not stmt.orelse and (
            _trailing_exit(stmt.body) is not None
        ):
            return "rest"  # `if not is_primary(): return` guard form
        return None

    def _arm_has_op(self, stmts, fi: FuncInfo) -> bool:
        return len(self._struct_seq(list(stmts), fi)) > 0

    def _seqs_try(
        self, fi, stmt, ops, rest, lctx, seqs, make_cont
    ) -> _SeqSet:
        final_c = (
            make_cont(stmt.finalbody, 0, lctx, rest)
            if stmt.finalbody else rest
        )
        orelse_c = (
            make_cont(stmt.orelse, 0, lctx, final_c)
            if stmt.orelse else final_c
        )
        body_c = make_cont(stmt.body, 0, lctx, orelse_c)
        body_ops = self._struct_seq(list(stmt.body), fi)
        for handler in stmt.handlers:
            # analyze the handler flow for nested findings (results are
            # not unioned into the main flow: the no-exception path is
            # the protocol path)
            seqs(make_cont(handler.body, 0, lctx, final_c))
            if body_ops and self._broad_handler(handler) and (
                self._handler_swallows(handler)
            ):
                self._report(
                    fi, handler.lineno, "RUN005",
                    f"in '{fi.qualname}': this handler swallows a "
                    f"failure around group op(s) "
                    f"{sorted(set(body_ops))} and proceeds — the "
                    "failing process drops out of lockstep while peers "
                    "wait in the op (re-raise, or exit so the "
                    "supervisor tears the group down)",
                )
        return seqs(body_c).prepend(ops)

    def _broad_handler(self, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        types = (
            handler.type.elts
            if isinstance(handler.type, ast.Tuple) else [handler.type]
        )
        for t in types:
            name = _dotted(t)
            if name is not None and name.rsplit(".", 1)[-1] in _BROAD_EXC:
                return True
        return False

    def _handler_swallows(self, handler: ast.ExceptHandler) -> bool:
        for node in _walk_no_defs_stmts(handler.body):
            if isinstance(node, ast.Raise):
                return False
            if isinstance(node, ast.Call):
                fn = _dotted(node.func) or ""
                tail = fn.rsplit(".", 1)[-1]
                if tail in _NORETURN_CALLS and fn.split(".", 1)[0] in (
                    "sys", "os", tail
                ):
                    return False
        return True

    # RUN006 ----------------------------------------------------------
    def _check_locks(self, fi: FuncInfo) -> None:
        if not self.serving_locks:
            return

        def walk(stmts, held: tuple):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if held:
                    for expr in _own_exprs(stmt):
                        if expr is None:
                            continue
                        for sub in _walk_no_defs(expr):
                            if isinstance(sub, ast.Call):
                                opseq = self._call_ops(sub, fi)
                                if opseq:
                                    shared = [
                                        t for t in held
                                        if t in self.serving_locks
                                    ]
                                    if shared:
                                        self._report(
                                            fi, stmt.lineno, "RUN006",
                                            f"in '{fi.qualname}': group "
                                            f"op(s) {sorted(set(opseq))} "
                                            "issued while holding lock "
                                            f"'{shared[0]}', which the "
                                            "serving plane also takes — "
                                            "an HTTP handler blocking on "
                                            "it deadlocks against a "
                                            "process parked in the "
                                            "collective",
                                        )
                if isinstance(stmt, ast.With):
                    toks = tuple(
                        t for t in (
                            _is_lock_expr(it.context_expr)
                            for it in stmt.items
                        ) if t
                    )
                    walk(stmt.body, held + toks)
                elif isinstance(stmt, ast.If):
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, (ast.For, ast.While)):
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body, held)
                    for h in stmt.handlers:
                        walk(h.body, held)
                    walk(stmt.orelse, held)
                    walk(stmt.finalbody, held)

        walk(list(fi.node.body), ())


# --- statement/expression iteration helpers --------------------------------

def _count_attrs(cls: ast.ClassDef) -> set[str]:
    """``self.X`` attributes of ``cls`` whose every assignment is a
    process-count call (``self.world = world_size()``)."""
    counts: set[str] = set()
    other: set[str] = set()
    for node in tree_nodes(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                full = _dotted(t)
                if not (full and full.startswith("self.")
                        and full.count(".") == 1):
                    continue
                attr = full.split(".", 1)[1]
                v = node.value
                if (isinstance(node, ast.Assign) and isinstance(v, ast.Call)
                        and (_dotted(v.func) or "").rsplit(".", 1)[-1]
                        in _COUNT_TAILS):
                    counts.add(attr)
                else:
                    other.add(attr)
    return counts - other


def _own_exprs(stmt) -> Iterable[Optional[ast.AST]]:
    """The statement's own (non-body) expressions, in evaluation order."""
    if isinstance(stmt, ast.Expr):
        yield stmt.value
    elif isinstance(stmt, ast.Assign):
        yield stmt.value
    elif isinstance(stmt, ast.AnnAssign):
        yield stmt.value
    elif isinstance(stmt, ast.AugAssign):
        yield stmt.value
    elif isinstance(stmt, ast.Return):
        yield stmt.value
    elif isinstance(stmt, ast.Raise):
        yield stmt.exc
        yield stmt.cause
    elif isinstance(stmt, ast.If):
        yield stmt.test
    elif isinstance(stmt, ast.While):
        yield stmt.test
    elif isinstance(stmt, ast.For):
        yield stmt.iter
    elif isinstance(stmt, ast.With):
        for it in stmt.items:
            yield it.context_expr
    elif isinstance(stmt, ast.Assert):
        yield stmt.test
        yield stmt.msg
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            yield t


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _walk_no_defs(node, skip_root_def: bool = False) -> tuple:
    """ast.walk in DOCUMENT (preorder) order that does not descend into
    nested function/class defs — source order matters for the
    last-write-wins environment. The fixpoint asks for the same subtrees
    in every round, so each node keeps its walk (the trees are shared and
    never changed)."""
    if isinstance(node, _DEFS) and not skip_root_def:
        return ()
    cached = node.__dict__.get("_mgwfbp_walk")
    if cached is None:
        out = [node]
        stack = list(reversed(list(ast.iter_child_nodes(node))))
        while stack:
            n = stack.pop()
            if isinstance(n, _DEFS):
                continue
            out.append(n)
            stack.extend(reversed(list(ast.iter_child_nodes(n))))
        cached = node._mgwfbp_walk = tuple(out)
    return cached


def _walk_no_defs_stmts(stmts):
    for s in stmts:
        yield from _walk_no_defs(s)


def _trailing_exit(stmts) -> Optional[ast.AST]:
    """The exit statement when every path through `stmts` leaves the
    normal flow (return/raise/continue/break); None otherwise."""
    if not stmts:
        return None
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
        return last
    if isinstance(last, ast.If) and last.orelse:
        a = _trailing_exit(last.body)
        b = _trailing_exit(last.orelse)
        if a is not None and b is not None:
            return a
    if isinstance(last, ast.With):
        return _trailing_exit(last.body)
    return None


def _exit_kind(stmt) -> str:
    return {
        ast.Return: "return", ast.Raise: "raise",
        ast.Continue: "continue", ast.Break: "break",
    }.get(type(stmt), "exit")


def _diff_ops(a: frozenset, b: frozenset) -> list[str]:
    """Ops appearing in one side's sequences but not the other's — the
    human-readable core of a sequence mismatch."""
    ops_a = {op for s in a for op in s}
    ops_b = {op for s in b for op in s}
    d = sorted(ops_a ^ ops_b)
    if d:
        return d
    return sorted(ops_a | ops_b)


# --- entry points ----------------------------------------------------------

def _load_module(path: str) -> Optional[ModuleInfo]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return ModuleInfo(path, f.read())
    except (OSError, SyntaxError, UnicodeDecodeError):
        return None


def _expand_targets(roots: Sequence[str]) -> list[str]:
    files: list[str] = []
    for r in roots:
        if os.path.isdir(r):
            for base, _dirs, names in os.walk(r):
                files.extend(
                    os.path.join(base, n)
                    for n in sorted(names) if n.endswith(".py")
                )
        elif os.path.isfile(r):
            files.append(r)
    return files


def check_paths(
    paths: Optional[Sequence[str]] = None,
    transport_path: Optional[str] = None,
    serving_paths: Optional[Sequence[str]] = None,
    tracker: Optional[SuppressionTracker] = None,
) -> list[Finding]:
    """Run the RUN-family pass over the protocol surfaces.

    Defaults: `DEFAULT_TARGETS` under the installed package, ops
    discovered from `runtime/coordination.py`, serving-plane locks from
    `DEFAULT_SERVING`. Suppressed findings and consumed annotations are
    recorded on `tracker` for ANA001.
    """
    if paths is None:
        paths = [os.path.join(_PKG_ROOT, t) for t in DEFAULT_TARGETS]
    if serving_paths is None:
        serving_paths = [os.path.join(_PKG_ROOT, t) for t in DEFAULT_SERVING]
    ops = discover_group_ops(transport_path)
    modules = [
        m for m in (_load_module(p) for p in _expand_targets(paths))
        if m is not None
    ]
    serving = [
        m for m in (_load_module(p) for p in _expand_targets(serving_paths))
        if m is not None
    ]
    checker = Checker(
        modules, ops, serving, tracker,
        transport_base=os.path.basename(transport_path or TRANSPORT_PATH),
    )
    return checker.check()


def check_sources(
    sources: dict[str, str],
    transport_path: Optional[str] = None,
    serving_sources: Optional[dict[str, str]] = None,
    tracker: Optional[SuppressionTracker] = None,
) -> list[Finding]:
    """Test hook: run the checker over in-memory sources ({path: src})."""
    ops = discover_group_ops(transport_path)
    modules = [ModuleInfo(p, s) for p, s in sources.items()]
    serving = [
        ModuleInfo(p, s) for p, s in (serving_sources or {}).items()
    ]
    return Checker(
        modules, ops, serving, tracker,
        transport_base=os.path.basename(transport_path or TRANSPORT_PATH),
    ).check()

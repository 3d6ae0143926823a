"""AST lint for capture-unsafe Python inside captured torch code (the port's
copy of ``mgwfbp_tpu/analysis/ast_lint.py``, with the scope model moved
from JAX's tracing to torch's capture and compile scopes).

A function that ``torch.compile`` or ``torch.jit`` captures, the body of a
CUDA graph capture, and a ``torch.func`` transform's operand run their
Python once, at capture time: anything that reads the host environment
(clocks, numpy or ``random`` RNG) is frozen into the captured program, and
anything that forces a tensor to a Python value (``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float(t)``) breaks the graph,
synchronises the device, or is illegal inside a CUDA graph. These bugs
tend to survive review because the first (capturing) call looks correct.

Scope model, deliberately conservative to keep false positives near zero:
a function is CAPTURED when
  * it is decorated with ``torch.compile`` / ``torch.jit.script`` /
    ``torch.jit.trace`` (bare, called, or via ``partial(torch.compile,
    ...)``) or a ``torch.func`` transform, or
  * its name is passed as the first argument to a capturing call anywhere
    in the module (``torch.compile(f)``, ``torch.jit.script(f)``,
    ``torch.jit.trace(f, ...)``, ``torch.cuda.make_graphed_callables(f,
    ...)``, ``torch.func.grad/vmap/jacrev/jacfwd(f)``; not
    ``torch.func.functional_call``, which captures nothing), or
  * it is lexically nested inside a captured function.
The statements of a ``with torch.cuda.graph(...)`` block are captured code
too, checked against the enclosing function's parameters. Helpers merely
CALLED from captured code are not chased (no interprocedural taint); rule
JIT003's float()/int()/bool() form only fires when the argument is rooted
at one of the captured function's own tensor parameters (a parameter
annotated ``int``/``float``/``bool``/``str`` is a Python scalar, which
``torch.compile`` specialises on: the counterpart of a static argument)
or holds a ``torch.`` call.
"""

from __future__ import annotations

import ast
from typing import Optional, Sequence

from mgwfbp_tpu_torch.analysis.rules import (
    Finding,
    SuppressionTracker,
    filter_suppressed,
    parse_source,
    tree_nodes,
)

# capturing calls, by dotted name with any leading ``torch.`` removed; the
# first function-valued argument becomes captured code
_CAPTURING_CALLS = {
    "compile", "jit.script", "jit.trace", "cuda.make_graphed_callables",
    "func.grad", "func.grad_and_value", "func.vmap", "func.jacrev",
    "func.jacfwd", "vmap",
}
# the same, imported bare (``from torch.func import vmap``)
_CAPTURING_TAILS = {"make_graphed_callables", "vmap", "jacrev", "jacfwd"}

_WALLCLOCK_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

_TRACED_MODULE_ROOTS = ("torch.",)

# tensor methods that read a tensor back to the host
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}

# JIT006: telemetry/logging emitters: host I/O that a captured body would
# run exactly once (at capture time) instead of per step, silently
# dropping every later record; telemetry belongs OUTSIDE the captured step
# (telemetry/events.py). The sets are shaped like the project's emitters:
# logging-style method calls on a logger-ish receiver, the ScalarWriter
# surface, and EventWriter.emit on a telemetry-ish receiver. Only the bare
# Python ``print`` is matched.
_LOGGING_METHODS = {
    "debug", "info", "warning", "error", "critical", "exception", "log",
}
_LOGGING_ROOT_SEGMENTS = {"log", "logger", "logging"}
_TELEMETRY_METHODS = {"add_scalar", "add_scalars"}
_TELEMETRY_EMIT_SEGMENTS = {"telemetry", "tel", "writer", "events"}

# a tensor's STRUCTURE, not its values: a Python branch on these is static
# and legal (``if torch.zeros(3).shape[0] == 3:``)
_STRUCTURAL_ATTRS = {"shape", "dtype", "device", "ndim"}
_STRUCTURAL_METHODS = {"dim", "size"}
_STRUCTURAL_PREFIXES = (
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.finfo", "torch.iinfo", "torch.Size", "torch.get_default_dtype",
    "torch.promote_types",
)

_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_capturing(name: Optional[str]) -> bool:
    if name is None:
        return False
    bare = name[len("torch."):] if name.startswith("torch.") else name
    return bare in _CAPTURING_CALLS or (
        "." not in name and name in _CAPTURING_TAILS)


def _is_capture_decorator(dec: ast.AST) -> bool:
    """@torch.compile / @torch.compile(...) / @torch.jit.script /
    @partial(torch.compile, ...) / @functools.partial(torch.jit.script, ..)
    / @torch.func.grad ..."""
    name = _dotted(dec)
    if name is not None:
        return _is_capturing(name)
    if isinstance(dec, ast.Call):
        fn = _dotted(dec.func)
        if fn is not None:
            if _is_capturing(fn):
                return True
            if fn.rsplit(".", 1)[-1] == "partial" and dec.args:
                return _is_capturing(_dotted(dec.args[0]))
    return False


def _is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g):`` (or ``cuda.graph`` / a bare
    ``graph`` imported from torch.cuda)."""
    expr = item.context_expr
    fn = _dotted(expr.func) if isinstance(expr, ast.Call) else None
    return fn is not None and (fn.endswith("cuda.graph") or fn == "graph")


def _captured_names(nodes) -> set[str]:
    """Names passed by reference into capturing calls, module-wide."""
    names: set[str] = set()
    for node in nodes:
        if not (isinstance(node, ast.Call)
                and _is_capturing(_dotted(node.func))):
            continue
        for arg in node.args[:1]:  # the function operand is leading
            elts = arg.elts if isinstance(arg, ast.Tuple) else [arg]
            for e in elts:  # make_graphed_callables takes a tuple
                name = _dotted(e)
                if name is not None and "." not in name:
                    names.add(name)
    return names


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = fn.args
    params = [*a.posonlyargs, *a.args, *a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg)
    if a.kwarg:
        params.append(a.kwarg)
    return {p.arg for p in params}


def _static_param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    """Params annotated as Python scalars (``n: int``): concrete values
    that torch.compile specialises on, so host conversions of them are
    legal and must not trip JIT003."""
    a = fn.args
    static: set[str] = set()
    for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
        ann = _dotted(p.annotation) if p.annotation is not None else None
        if ann in _SCALAR_ANNOTATIONS:
            static.add(p.arg)
    return static


def _rooted_at(node: ast.AST, names: set[str]) -> bool:
    """Expression is a Name/Attribute/Subscript chain rooted at `names`."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id in names


def _structural_calls(node: ast.AST) -> set[int]:
    """ids of the ``torch.`` calls in the subtree that are read only for
    their structure (``torch.f(x).shape``, ``torch.f(x).dim()``)."""
    out: set[int] = set()
    for sub in ast.walk(node):
        inner = None
        if isinstance(sub, ast.Attribute) and sub.attr in _STRUCTURAL_ATTRS:
            inner = sub.value
        elif (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
              and sub.func.attr in _STRUCTURAL_METHODS):
            inner = sub.func.value
        if inner is not None:
            out.update(id(n) for n in ast.walk(inner))
    return out


def _contains_traced_call(node: ast.AST) -> bool:
    """Subtree contains a call into ``torch.``: a tensor producer."""
    structural = _structural_calls(node)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and id(sub) not in structural:
            fn = _dotted(sub.func)
            if (
                fn is not None
                and fn.startswith(_TRACED_MODULE_ROOTS)
                and not fn.startswith(_STRUCTURAL_PREFIXES)
            ):
                return True
    return False


class _TracedBodyChecker(ast.NodeVisitor):
    """Rule checks inside one captured body (without nested defs: those
    are visited as captured functions in their own right). ``fn`` names
    the function whose parameters root JIT003's conversions; ``what`` is
    the captured region's name in messages."""

    def __init__(self, path: str, fn, findings: list,
                 what: Optional[str] = None):
        self.path = path
        self.fn = fn
        self.what = what or fn.name
        self.params = (_param_names(fn) - _static_param_names(fn)
                       if fn is not None else set())
        self.findings = findings

    def _add(self, node: ast.AST, rule_id: str, msg: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0), rule_id, msg)
        )

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is not self.fn:
            return  # nested def: checked separately with its own params
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _is_telemetry_call(self, fn: str) -> bool:
        parts = fn.split(".")
        tail = parts[-1]
        receiver = parts[:-1]
        if fn == "print":
            return True
        if tail in _LOGGING_METHODS and any(
            p in _LOGGING_ROOT_SEGMENTS for p in receiver
        ):
            return True
        if tail in _TELEMETRY_METHODS:
            return True
        if tail == "emit" and any(
            p in _TELEMETRY_EMIT_SEGMENTS for p in receiver
        ):
            return True
        return False

    def visit_Call(self, node: ast.Call) -> None:
        fn = _dotted(node.func)
        if fn is not None:
            tail2 = ".".join(fn.split(".")[-2:])
            if fn in _WALLCLOCK_CALLS or tail2 in _WALLCLOCK_CALLS:
                self._add(node, "JIT001",
                          f"'{fn}()' inside traced '{self.what}'")
            elif fn.startswith(("np.random.", "numpy.random.", "random.")):
                self._add(node, "JIT002",
                          f"'{fn}()' inside traced '{self.what}'")
            elif self._is_telemetry_call(fn):
                self._add(
                    node, "JIT006",
                    f"'{fn}()' inside traced '{self.what}' — host I/O "
                    "runs once at capture time, not per step; emit "
                    "telemetry outside the captured code",
                )
            elif fn in ("float", "int", "bool") and node.args:
                if _rooted_at(node.args[0], self.params) or (
                    _contains_traced_call(node.args[0])
                ):
                    self._add(
                        node, "JIT003",
                        f"'{fn}()' forces a traced value to host in "
                        f"'{self.what}'",
                    )
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_READ_METHODS and not node.args):
            self._add(node, "JIT003",
                      f"'.{node.func.attr}()' forces a traced value to host "
                      f"in '{self.what}'")
        self.generic_visit(node)

    def _check_branch(self, node: ast.If | ast.While, kind: str) -> None:
        if _contains_traced_call(node.test):
            self._add(
                node, "JIT004",
                f"Python '{kind}' on a traced expression in "
                f"'{self.what}' — the branch is frozen at capture time",
            )

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, "while")
        self.generic_visit(node)


def _mutable_default_findings(
    path: str, fn: ast.FunctionDef, findings: list
) -> None:
    for default in [*fn.args.defaults, *fn.args.kw_defaults]:
        if default is None:
            continue
        mutable = isinstance(default, (ast.List, ast.Dict, ast.Set))
        if isinstance(default, ast.Call):
            callee = _dotted(default.func)
            mutable = callee in ("list", "dict", "set")
        if mutable:
            findings.append(Finding(
                path, default.lineno, "JIT005",
                f"mutable default argument on jitted '{fn.name}'",
            ))


def _graph_blocks(fn) -> list[ast.With]:
    """The ``with torch.cuda.graph(...)`` blocks of ``fn``'s own body (not
    of nested defs)."""
    out, stack = [], list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.With) and any(
                _is_graph_capture(it) for it in n.items):
            out.append(n)
            continue  # the block is checked whole
        stack.extend(ast.iter_child_nodes(n))
    return out


def lint_source(
    source: str, path: str = "<string>",
    tracker: Optional[SuppressionTracker] = None,
) -> list:
    """Lint one module's source; returns noqa-filtered findings.
    Consumed suppressions land on `tracker` (ANA001 accounting)."""
    if tracker is not None:
        tracker.scan_source(path, source)
    try:
        tree = parse_source(source, path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "JIT000",
                        f"unparseable module: {e.msg}")]
    nodes = tree_nodes(tree)
    captured_names = _captured_names(nodes)
    # most modules capture nothing: then no function is traced and no
    # graph block exists, and the walks below would find nothing
    graphs = any(isinstance(n, ast.With)
                 and any(_is_graph_capture(it) for it in n.items)
                 for n in nodes)
    any_decorated = any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and any(_is_capture_decorator(d)
                            for d in n.decorator_list)
                    for n in nodes)

    findings: list = []

    def check_graph_blocks(scope) -> None:
        if not graphs:
            return
        fn = scope if isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef)) else None
        for block in _graph_blocks(scope):
            checker = _TracedBodyChecker(path, fn, findings,
                                         what="torch.cuda.graph block")
            for stmt in block.body:
                checker.visit(stmt)

    def visit_functions(node: ast.AST, inside_traced: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                decorated = any(
                    _is_capture_decorator(d) for d in child.decorator_list
                )
                traced = (
                    inside_traced
                    or decorated
                    or child.name in captured_names
                )
                if traced:
                    _TracedBodyChecker(path, child, findings).visit(child)
                    if decorated:
                        _mutable_default_findings(path, child, findings)
                else:
                    check_graph_blocks(child)
                visit_functions(child, traced)
            else:
                visit_functions(child, inside_traced)

    check_graph_blocks(tree)
    if graphs or any_decorated or captured_names:
        visit_functions(tree, False)
    return filter_suppressed(findings, source.splitlines(), tracker)


def lint_file(
    path: str, tracker: Optional[SuppressionTracker] = None
) -> list:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except OSError as e:
        return [Finding(path, 0, "JIT000", f"cannot read lint target: {e}")]
    except UnicodeDecodeError as e:
        return [Finding(path, 0, "JIT000", f"cannot decode lint target: {e}")]
    return lint_source(source, path, tracker)


def lint_paths(
    paths: Sequence[str], tracker: Optional[SuppressionTracker] = None
) -> list:
    """Lint .py files (recursing into directories), sorted findings.

    A target that is neither a directory nor an existing .py file yields a
    JIT000 error finding rather than being dropped: a mistyped path must
    not turn the CI gate green by linting nothing.
    """
    import os

    files: list[str] = []
    findings: list = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(
                    os.path.join(root, n) for n in names if n.endswith(".py")
                )
        elif p.endswith(".py") and os.path.isfile(p):
            files.append(p)
        else:
            findings.append(Finding(
                p, 0, "JIT000",
                "lint target is not a directory or existing .py file",
            ))
    for f in sorted(files):
        findings.extend(lint_file(f, tracker))
    return findings

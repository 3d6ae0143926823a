"""Rule registry, findings, and suppression of the port's static analysis
(a copy of ``mgwfbp_tpu/analysis/rules.py``, with the port's marker
prefix).

Five rule families share this framework:
  * JIT0xx: AST lint rules for capture-unsafe Python inside code that
    ``torch.compile``, ``torch.jit``, a CUDA graph or a ``torch.func``
    transform captures (``analysis.ast_lint``);
  * SCH0xx: merge-schedule invariants checked against one OBSERVED train
    step (``analysis.schedule_check``): its collectives, host
    synchronisations, state storages, guard and health footprint;
  * RUN0xx: SPMD lockstep rules for the host-side multi-process
    coordination protocol (``analysis.spmd_check``): every process must
    execute the identical group-operation sequence, statically;
  * THR0xx: host-concurrency race rules (``analysis.race_check``): shared
    state and lock discipline across the discovered thread / executor /
    HTTP-handler / observer / signal contexts;
  * ANA0xx: meta rules about the analysis annotations themselves
    (a suppression that suppresses nothing, a suppression without a
    reason).
TRC000 is the odd one out: not a protocol violation but the step pass
failing to BUILD or RUN the observed step at all, kept separate so CI can
distinguish "the protocol is broken" from "the model failed to build".

Ids, severities and family bits are the JAX registry's. The summaries are
too, except where a rule's meaning moves to torch: ``TORCH_SUMMARIES``
lists those, each with its reason.

Findings print as ``file:line RULE message``. A finding on a source line
carrying ``# mgwfbp: noqa`` (all rules) or ``# mgwfbp: noqa[JIT001]`` /
``# mgwfbp: noqa[JIT001,SCH004]`` (listed rules only) is suppressed;
step-level findings have no meaningful source line and cannot be noqa'd.
A suppression should carry a reason: ``# mgwfbp: noqa[RUN003] -- cadence
vars are group-uniform (supervisor exports one env)``.

Exit codes are stable per family (``FAMILY_BITS`` / ``exit_code``): CI can
tell WHICH family failed from the code alone.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import re
from typing import Iterable, Optional, Sequence

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str  # ERROR | WARNING
    summary: str


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int  # 1-based; 0 = whole-step finding (the step pass)
    rule_id: str
    message: str

    @property
    def rule(self) -> Rule:
        return RULES[self.rule_id]

    @property
    def severity(self) -> str:
        return self.rule.severity

    def format(self) -> str:
        return f"{self.file}:{self.line} {self.rule_id} {self.message}"


RULES: dict[str, Rule] = {}


def _register(id: str, severity: str, summary: str) -> Rule:
    if id in RULES:
        raise ValueError(f"duplicate rule id {id!r}")
    r = Rule(id, severity, summary)
    RULES[id] = r
    return r


# --- AST lint rules (capture-unsafe Python in captured code) ---------------
_register("JIT000", ERROR,
          "lint target missing, unreadable, or unparseable")
_register("JIT001", ERROR,
          "wall-clock call inside traced code (runs once at trace time)")
_register("JIT002", ERROR,
          "numpy RNG inside traced code (frozen at trace time; use torch's "
          "generator-backed RNG)")
_register("JIT003", ERROR,
          "host round-trip on a traced value (.item()/float()/int()/bool())")
_register("JIT004", WARNING,
          "Python-level branch on a traced value (use torch.where/torch.cond)")
_register("JIT005", ERROR,
          "mutable default argument on a jitted function (shared across traces)")
_register("JIT006", ERROR,
          "telemetry/logging call inside traced code (host I/O runs once at "
          "trace time and never per step — emit spans outside jit)")

# --- schedule-verifier rules (one observed step) ---------------------------
_register("SCH001", ERROR,
          "merged-collective count differs from MergeSchedule.num_groups")
_register("SCH002", ERROR,
          "bucket collective dtype differs from the layout's bucket dtype")
_register("SCH003", ERROR,
          "bucket layout does not cover every gradient leaf exactly once")
_register("SCH004", ERROR,
          "unexpected collective in the hot path")
_register("SCH005", ERROR,
          "host synchronisation in the hot path")
_register("SCH006", ERROR,
          "state not updated in place")
_register("SCH007", ERROR,
          "bucket collective payload size differs from the layout's group size")
_register("SCH008", ERROR,
          "non-finite-gradient guard presence differs from the step's "
          "configuration (is_finite check missing, or present when disabled)")
_register("SCH009", ERROR,
          "hierarchical (hier) nested-schedule contract violated: inner "
          "RS/AG leg shape, DCN-group collective count/payload/dtype, or "
          "a cross-pod collective outside its declared scope")
_register("SCH010", ERROR,
          "training-health statistics changed the step's collective "
          "footprint (the stats must ride the EXISTING metrics psum — "
          "zero new collectives or host callbacks)")

# --- SPMD lockstep rules (host-side multi-host protocol) --------------------
_register("RUN001", ERROR,
          "group operation control-dependent on a process-local value "
          "(process identity, local RNG/clock/filesystem, a local flag) — "
          "processes take different arms and the group deadlocks")
_register("RUN002", ERROR,
          "branch arms execute different group-operation sequences under a "
          "condition not proven group-uniform (join-point sequence "
          "mismatch)")
_register("RUN003", ERROR,
          "early return/raise/continue skips a group operation another "
          "path still executes (the skipped-barrier hang)")
_register("RUN004", ERROR,
          "primary-only side effect (process-0-gated write) not followed "
          "by a commit barrier / group operation on all paths — peers can "
          "proceed before the commit is durable")
_register("RUN005", ERROR,
          "group operation inside a try whose handler swallows the "
          "exception and proceeds — one process drops out of lockstep "
          "while its peers wait")
_register("RUN006", ERROR,
          "blocking group operation reachable while holding a lock the "
          "serving plane also takes (HTTP handler <-> step-loop deadlock)")

# --- host-concurrency race rules (analysis.race_check) ----------------------
_register("THR001", ERROR,
          "shared attribute written from two or more concurrency contexts "
          "with no common lock held across the writes (torn/lost update)")
_register("THR002", ERROR,
          "lock-order inversion: two locks acquired in opposite orders by "
          "concurrent contexts (classic ABBA deadlock)")
_register("THR003", ERROR,
          "blocking operation (group op / file I/O / sleep / HTTP) while "
          "holding a lock a serving-plane handler also takes — one slow "
          "or wedged call freezes the observability plane (generalizes "
          "RUN006 beyond group ops)")
_register("THR004", ERROR,
          "signal handler doing non-async-signal-safe work (lock "
          "acquisition, blocking I/O, group op) — the handler can run "
          "while the interrupted thread holds the very lock it wants")
_register("THR005", ERROR,
          "stream written without the lock its close() holds — a "
          "daemon-thread write can race close() and land on a closed "
          "file (or be torn mid-record)")

# --- annotation meta rules --------------------------------------------------
_register("ANA001", ERROR,
          "dead or reason-less suppression: a '# mgwfbp: noqa[...]' that "
          "suppresses nothing, a '# mgwfbp: group-uniform' the checker "
          "never consulted, a '# mgwfbp: thread-safe' the race checker "
          "never consulted, or a RUN-family / value-annotation "
          "suppression without a '-- reason' string")

# --- trace failures (not a protocol violation) ------------------------------
_register("TRC000", ERROR,
          "the step pass could not build or run the observed step "
          "(model/build failure — distinct from a lint or schedule "
          "violation)")


# The summaries that differ from the JAX registry's, and why; every other
# summary is the JAX text (ANA001's with the port's marker prefix).
TORCH_SUMMARIES = {
    "JIT002": "torch has no functional key: the fix is torch's RNG, not "
              "jax.random",
    "JIT004": "torch's tensor branch is torch.where / torch.cond, not "
              "lax.cond / jnp.where",
    "SCH005": "a torch step has no host callbacks; what stalls it is a "
              "device-to-host read (.item(), float(t), .cpu(), a branch "
              "on a tensor) anywhere inside the step",
    "SCH006": "torch has no buffer donation; its counterpart is that the "
              "step updates parameters, optimizer state and buffers in "
              "their own storages",
    "TRC000": "the port observes a real step instead of tracing one, so "
              "the failure is to build or run it",
}


# exit-code bits, one per family: CI distinguishes WHICH gate failed from
# the exit code alone (documented in README "Static analysis of the port")
FAMILY_BITS = {"JIT": 1, "SCH": 2, "RUN": 4, "ANA": 8, "TRC": 16, "THR": 32}


def family(rule_id: str) -> str:
    return rule_id.rstrip("0123456789")


def exit_code(
    findings: Iterable[Finding], warnings_as_errors: bool = False
) -> int:
    """Bitwise-OR of the FAMILY_BITS of every error finding (warnings too
    under `warnings_as_errors`); 0 when nothing qualifies."""
    code = 0
    for f in findings:
        if f.severity == ERROR or warnings_as_errors:
            code |= FAMILY_BITS.get(family(f.rule_id), 1)
    return code


_NOQA = re.compile(r"#\s*mgwfbp:\s*noqa(?:\[(?P<ids>[A-Za-z0-9_,\s]+)\])?")
# value annotation: the fact on this line the analysis cannot see — the
# condition/assigned value IS group-uniform (see spmd_check). A reason
# string after ' -- ' is required for RUN-family noqa and group-uniform
# markers (ANA001 enforces it).
_GROUP_UNIFORM = re.compile(r"#\s*mgwfbp:\s*group-uniform\b")
# value annotation for the race checker: the shared state / blocking
# call on (or under the `def` carrying) this line is DELIBERATELY
# lock-free and the author accepts the interleavings — e.g. the
# watchdog's torn-read-tolerant heartbeat. Always requires a reason.
_THREAD_SAFE = re.compile(r"#\s*mgwfbp:\s*thread-safe\b")
_REASON = re.compile(
    r"#\s*mgwfbp:\s*(?:noqa(?:\[[^\]]*\])?|group-uniform|thread-safe)"
    r"\s*--\s*\S"
)


def suppressed_ids(source_line: str) -> Optional[frozenset[str]]:
    """Rule ids a ``# mgwfbp: noqa`` comment on this line suppresses.

    Returns None when the line has no noqa marker; an EMPTY frozenset means
    a bare marker (suppress every rule); otherwise the listed ids.
    """
    m = _NOQA.search(source_line)
    if m is None:
        return None
    ids = m.group("ids")
    if ids is None:
        return frozenset()
    return frozenset(s.strip() for s in ids.split(",") if s.strip())


def has_group_uniform_marker(source_line: str) -> bool:
    """True when the line carries a ``# mgwfbp: group-uniform`` value
    annotation (spmd_check treats the condition/assigned value on that
    line as group-uniform)."""
    return _GROUP_UNIFORM.search(source_line) is not None


def has_thread_safe_marker(source_line: str) -> bool:
    """True when the line carries a ``# mgwfbp: thread-safe`` annotation
    (race_check accepts the lock-free access/blocking call it marks)."""
    return _THREAD_SAFE.search(source_line) is not None


def has_reason(source_line: str) -> bool:
    """True when the line's mgwfbp marker carries a ``-- reason`` string."""
    return _REASON.search(source_line) is not None


@functools.lru_cache(maxsize=512)
def parse_source(source: str, path: str = "<string>") -> ast.Module:
    """The module's tree, parsed once per process for each (path, source)
    and shared by every pass (lint, THR, RUN): the passes read trees and
    never change them."""
    return ast.parse(source, filename=path)


def tree_nodes(tree: ast.AST) -> tuple:
    """Every node of ``tree`` (``ast.walk`` order), walked once and kept on
    the shared tree."""
    cached = tree.__dict__.get("_mgwfbp_nodes")
    if cached is None:
        cached = tree._mgwfbp_nodes = tuple(ast.walk(tree))
    return cached


def comment_lines(source: str) -> Optional[dict[int, str]]:
    """{lineno: comment_text} for every REAL comment token — docstrings
    quoting the annotation grammar must not register as markers. None
    when the source does not tokenize (caller falls back to line scan).
    Tokenized once per source text (the lint, the passes and the tracker
    all ask)."""
    found = _comment_lines(source)
    return None if found is None else dict(found)


@functools.lru_cache(maxsize=512)
def _comment_lines(source: str) -> Optional[dict[int, str]]:
    import io
    import tokenize

    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError,
            UnicodeDecodeError):
        return None
    return out


class SuppressionTracker:
    """Accounting for the annotation surface, feeding ANA001.

    The passes report every suppression they CONSUME (`note_used`) and
    every suppressed finding (kept, marked, for ``--json``); the tracker
    independently scans the analyzed files for markers, so after all
    passes ran, a marker nobody consumed is dead (`unused_findings`).
    `note_uniform_used` is the same contract for ``group-uniform`` value
    annotations (consumed by spmd_check when one actually informs a
    classification).
    """

    def __init__(self) -> None:
        # (file, line) -> frozenset of listed ids (empty = bare noqa)
        self.markers: dict[tuple[str, int], frozenset[str]] = {}
        # (file, line) of group-uniform value annotations
        self.uniform_markers: set[tuple[str, int]] = set()
        # (file, line) of thread-safe value annotations (race_check)
        self.threadsafe_markers: set[tuple[str, int]] = set()
        # (file, line) lines whose marker carries a reason string
        self._reasoned: set[tuple[str, int]] = set()
        # consumed: (file, line, rule_id) for noqa, (file, line) for uniform
        self.used: set[tuple[str, int, str]] = set()
        self.uniform_used: set[tuple[str, int]] = set()
        self.threadsafe_used: set[tuple[str, int]] = set()
        self.suppressed_findings: list[Finding] = []
        self._scanned: set[str] = set()
        # grammar -> files its consuming pass actually analyzed this run.
        # A value annotation is only provably DEAD when the pass that
        # could consume it ran over the file it sits in — an SPMD-only
        # run must not call the race checker's thread-safe pins dead
        # (and vice versa), and a paths-restricted run must not condemn
        # pins in files it never analyzed.
        self._value_pass_files: dict[str, set[str]] = {}

    def scan_source(self, path: str, source: str) -> None:
        if path in self._scanned:
            return
        self._scanned.add(path)
        comments = comment_lines(source)
        if comments is None:  # unparseable: every line is fair game
            comments = dict(enumerate(source.splitlines(), start=1))
        for i, line in comments.items():
            ids = suppressed_ids(line)
            if ids is not None:
                self.markers[(path, i)] = ids
            if has_group_uniform_marker(line):
                self.uniform_markers.add((path, i))
            if has_thread_safe_marker(line):
                self.threadsafe_markers.add((path, i))
            if has_reason(line):
                self._reasoned.add((path, i))

    def scan_lines(self, path: str, source_lines: Sequence[str]) -> None:
        self.scan_source(path, "\n".join(source_lines))

    def scan_file(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                self.scan_source(path, f.read())
        except (OSError, UnicodeDecodeError):
            pass

    def note_used(self, finding: Finding) -> None:
        self.used.add((finding.file, finding.line, finding.rule_id))
        self.suppressed_findings.append(finding)

    def note_uniform_used(self, path: str, line: int) -> None:
        self.uniform_used.add((path, line))

    def note_threadsafe_used(self, path: str, line: int) -> None:
        self.threadsafe_used.add((path, line))

    def note_value_pass(self, grammar: str, paths: Iterable[str]) -> None:
        """Record that `grammar`'s consuming pass analyzed `paths`."""
        self._value_pass_files.setdefault(grammar, set()).update(paths)

    def unused_findings(self) -> list[Finding]:
        """ANA001 findings: dead noqa ids, dead group-uniform markers, and
        RUN-family / group-uniform markers without a reason string."""
        out: list[Finding] = []
        for (path, line), ids in sorted(self.markers.items()):
            if ids:
                dead = [
                    rid for rid in sorted(ids)
                    if (path, line, rid) not in self.used
                ]
                if dead:
                    out.append(Finding(
                        path, line, "ANA001",
                        "noqa[" + ",".join(dead) + "] suppresses nothing "
                        "on this line — remove the dead suppression",
                    ))
                if any(
                    family(rid) == "RUN" for rid in ids
                ) and (path, line) not in self._reasoned:
                    out.append(Finding(
                        path, line, "ANA001",
                        "RUN-family suppression without a reason — append "
                        "'-- <why this is safe>'",
                    ))
            else:
                if not any(
                    (f, ln) == (path, line) for (f, ln, _r) in self.used
                ):
                    out.append(Finding(
                        path, line, "ANA001",
                        "bare noqa suppresses nothing on this line — "
                        "remove the dead suppression",
                    ))
        uniform_scope = self._value_pass_files.get("group-uniform", set())
        for (path, line) in sorted(self.uniform_markers):
            if path not in uniform_scope:
                continue
            if (path, line) not in self.uniform_used:
                out.append(Finding(
                    path, line, "ANA001",
                    "group-uniform annotation the checker never consulted "
                    "— remove it or move it to the condition/assignment "
                    "it describes",
                ))
            elif (path, line) not in self._reasoned:
                out.append(Finding(
                    path, line, "ANA001",
                    "group-uniform annotation without a reason — append "
                    "'-- <why this value is identical on every process>'",
                ))
        threadsafe_scope = self._value_pass_files.get("thread-safe", set())
        for (path, line) in sorted(self.threadsafe_markers):
            if path not in threadsafe_scope:
                continue
            if (path, line) not in self.threadsafe_used:
                out.append(Finding(
                    path, line, "ANA001",
                    "thread-safe annotation the race checker never "
                    "consulted — remove it or move it to the access / "
                    "blocking call (or its enclosing def) it describes",
                ))
            elif (path, line) not in self._reasoned:
                out.append(Finding(
                    path, line, "ANA001",
                    "thread-safe annotation without a reason — append "
                    "'-- <why the lock-free interleaving is acceptable>'",
                ))
        return out


def filter_suppressed(
    findings: Iterable[Finding],
    source_lines: Sequence[str],
    tracker: Optional[SuppressionTracker] = None,
) -> list[Finding]:
    """Drop findings whose source line carries a matching noqa marker;
    consumed suppressions (and the findings they hid) are recorded on
    `tracker` when given, so ANA001 can prove the rest dead."""
    out = []
    for f in findings:
        if 1 <= f.line <= len(source_lines):
            ids = suppressed_ids(source_lines[f.line - 1])
            if ids is not None and (not ids or f.rule_id in ids):
                if tracker is not None:
                    tracker.note_used(f)
                continue
        out.append(f)
    return out


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)

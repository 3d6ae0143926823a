"""CLI: run the port's analysis passes and exit with a family-coded status
(the counterpart of ``python -m mgwfbp_tpu.analysis``).

    python -m mgwfbp_tpu_torch.analysis                 # all passes, card
    python -m mgwfbp_tpu_torch.analysis --device cpu    # step pass on CPU
    python -m mgwfbp_tpu_torch.analysis --skip-step     # static passes only
    python -m mgwfbp_tpu_torch.analysis --json          # machine-readable
    python -m mgwfbp_tpu_torch.analysis path/to/file.py # lint given targets

Pass order is cheapest-first so protocol bugs fail in seconds: the AST
capture-safety lint (JIT000..JIT006), then the host-concurrency race
checker (THR001..THR005 over the thread/handler/observer/signal surfaces:
runtime/, serving/, train/trainer.py, checkpoint.py,
telemetry/{serve,fleet,events,recorder}.py, utils/watchdog.py,
data/loader.py), then the SPMD lockstep checker (RUN001..RUN006 over the
multi-process protocol surfaces: runtime/, train/trainer.py,
checkpoint.py, parallel/autotune.py, telemetry/drift.py), then ANA001
(dead-suppression accounting over everything the earlier passes saw),
then the step pass (``analysis.step_pass``), which OBSERVES real train
steps of ``--model`` in one group of two gloo ranks, once per merge policy
and lowering, plus a guard-off step and the health statistics off and on
(SCH001..SCH010). The step pass runs on the card unless ``--device cpu``
asks for the CPU; without a card the default is TRC000.

Exit codes are stable per rule family (CI can tell WHICH gate failed):
bit 1 = JIT lint errors, bit 2 = SCH schedule-verifier errors, bit 4 =
RUN lockstep errors, bit 8 = ANA annotation errors, bit 16 = the step pass
failed to BUILD or RUN its steps (TRC000: a model/build failure, not a
protocol violation), bit 32 = THR host-concurrency race errors. 0 = clean.

``--json`` prints one JSON document on stdout: every finding (including
suppressed ones, marked) with rule id, severity, file, line, message,
and suppression state, plus the per-family error counts and the exit
code the process will return.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.analysis",
        description="MG-WFBP static analysis of the port: capture-safety "
        "lint + race checker + SPMD lockstep checker + observed-step "
        "merge-schedule verification",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the mgwfbp_tpu_torch "
        "package)",
    )
    parser.add_argument("--skip-lint", action="store_true",
                        help="skip the AST lint pass")
    parser.add_argument("--skip-spmd", action="store_true",
                        help="skip the SPMD lockstep pass (RUN rules)")
    parser.add_argument("--skip-thr", action="store_true",
                        help="skip the host-concurrency race pass "
                        "(THR rules)")
    parser.add_argument("--skip-step", action="store_true",
                        help="skip the observed-step schedule pass")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable findings on stdout "
                        "(suppressed findings included, marked)")
    parser.add_argument("--model", default="lenet",
                        help="model whose steps the step pass observes")
    parser.add_argument(
        "--policies", default="wfbp,single,mgwfbp",
        help="comma-separated merge policies to verify (step pass)",
    )
    parser.add_argument(
        "--comm-ops", dest="comm_ops",
        default="all_reduce,rs_opt_ag,rs_fwd_ag,hier",
        help="comma-separated bucket lowerings to verify; each policy is "
        "observed under each (rs_opt_ag/rs_fwd_ag with global-norm "
        "clipping on, so the cross-group clip all-reduce is covered too; "
        "the rs_fwd_ag window takes in the next forward's gathers — the "
        "cross-step contract; hier runs over two slices of one rank under "
        "a slow-DCN two-level cost model — the SCH009 nested contract)",
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the step pass runs its steps (the "
                        "card unless asked for the CPU)")
    parser.add_argument("--warnings-as-errors", action="store_true",
                        help="exit non-zero on warnings too")
    args = parser.parse_args(argv)

    from mgwfbp_tpu_torch.analysis.rules import (
        ERROR,
        WARNING,
        SuppressionTracker,
        exit_code,
        family,
    )

    tracker = SuppressionTracker()
    findings = []

    if not args.skip_lint:
        from mgwfbp_tpu_torch.analysis.ast_lint import lint_paths

        targets = args.paths or [os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))]
        findings.extend(lint_paths(targets, tracker))

    if not args.skip_thr:
        from mgwfbp_tpu_torch.analysis.race_check import (
            check_paths as thr_check_paths,
        )

        # explicit paths narrow the race pass too (like the lint), so a
        # seeded single-file probe exercises THR alone in milliseconds
        findings.extend(thr_check_paths(
            paths=args.paths or None, tracker=tracker,
        ))

    if not args.skip_spmd:
        from mgwfbp_tpu_torch.analysis.spmd_check import check_paths

        findings.extend(check_paths(tracker=tracker))

    # ANA001 runs only when EVERY consuming pass ran: lint consumes JIT
    # noqas, the race pass THR noqas + thread-safe pins, spmd RUN noqas
    # + group-uniform markers — skipping any would misreport that pass's
    # live markers as dead
    if not args.skip_lint and not args.skip_spmd and not args.skip_thr:
        findings.extend(tracker.unused_findings())

    if not args.skip_step:
        from mgwfbp_tpu_torch.analysis import step_pass

        findings.extend(step_pass.run(
            args.model,
            policies=[p.strip() for p in args.policies.split(",")
                      if p.strip()],
            comm_ops=[c.strip() for c in args.comm_ops.split(",")
                      if c.strip()],
            device=args.device,
        ))

    errors = sum(1 for f in findings if f.severity == ERROR)
    warnings = sum(1 for f in findings if f.severity == WARNING)
    rc = exit_code(findings, args.warnings_as_errors)

    if args.as_json:
        def doc(f, suppressed):
            return {
                "rule": f.rule_id,
                "family": family(f.rule_id),
                "severity": f.severity,
                "file": f.file,
                "line": f.line,
                "message": f.message,
                "suppressed": suppressed,
            }

        by_family: dict[str, int] = {}
        for f in findings:
            if f.severity == ERROR:
                fam = family(f.rule_id)
                by_family[fam] = by_family.get(fam, 0) + 1
        print(json.dumps({
            "findings": (
                [doc(f, False) for f in findings]
                + [doc(f, True) for f in tracker.suppressed_findings]
            ),
            "errors": errors,
            "warnings": warnings,
            "errors_by_family": by_family,
            "exit_code": rc,
        }, indent=2))
    else:
        for f in findings:
            print(f.format())
    print(
        f"mgwfbp_tpu_torch.analysis: {errors} error(s), {warnings} "
        f"warning(s)" + (f", exit {rc}" if rc else ""),
        file=sys.stderr,
    )
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

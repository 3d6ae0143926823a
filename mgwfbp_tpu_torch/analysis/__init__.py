"""Static analysis of the port (the counterpart of the ``mgwfbp_tpu.analysis``
package): the MG-WFBP hot path AND the host-side protocol.

Five passes, one CLI (``python -m mgwfbp_tpu_torch.analysis``), cheapest
first:

  * ``ast_lint``: AST rules for capture-unsafe Python inside code that
    ``torch.compile``, ``torch.jit``, a CUDA graph or a ``torch.func``
    transform captures (wall clocks, numpy RNG, host round-trips, Python
    branches on tensors, mutable defaults, telemetry in captured code).
    Rule ids JIT000..JIT006.
  * ``race_check``: the host-concurrency race checker over the thread,
    executor, HTTP-handler, observer and signal contexts. THR001..THR005.
  * ``spmd_check``: the SPMD lockstep checker: statically proves the
    host-side multi-process coordination protocol deadlock-free. Group
    operations are discovered from the ``@group_op`` decorations in
    ``runtime/coordination.py``. RUN001..RUN006.
  * ANA001: annotation accounting: a suppression or ``group-uniform`` /
    ``thread-safe`` marker that changes nothing, or a RUN-family
    suppression without a reason, is itself an error.
  * ``step_pass`` (``schedule_check``): observe real train steps at two
    gloo ranks and verify that each realizes the merge schedule (group
    count, bucket sizes/dtypes, no stray collectives), synchronises the
    host only in its declared metrics read-back, updates its state in
    place, carries the guard exactly when configured, and that the health
    statistics add no collective or synchronisation. SCH001..SCH010; a
    failure to build or run at all is TRC000 (exit bit 16). The
    autotuner gates every raced candidate on ``schedule_check``.

The AST passes import no torch. Exit codes are family-stable
(``rules.FAMILY_BITS``): JIT=1, SCH=2, RUN=4, ANA=8, TRC=16, THR=32.
Findings print as ``file:line RULE message``; suppress in-line with
``# mgwfbp: noqa[RULE] -- reason``. See README "Static analysis of the
port".
"""

from mgwfbp_tpu_torch.analysis.rules import (  # noqa: F401
    ERROR,
    FAMILY_BITS,
    RULES,
    WARNING,
    Finding,
    Rule,
    SuppressionTracker,
    exit_code,
    filter_suppressed,
    has_errors,
    suppressed_ids,
)
from mgwfbp_tpu_torch.analysis.ast_lint import (  # noqa: F401
    lint_file,
    lint_paths,
    lint_source,
)
from mgwfbp_tpu_torch.analysis.spmd_check import (  # noqa: F401
    check_paths,
    check_sources,
    discover_group_ops,
)

"""Multi-process runtime (counterpart of ``mgwfbp_tpu/runtime/``).

  coordination  agreement primitives every cross-process decision of the
                trainer goes through (drain, rollback, commits, the
                cross-world resume's choice), plus ``gather_values``,
                ``gather_vectors`` and ``all_argmin``;
  supervisor    the process-group launcher and its rc policy: rc 75
                resubmits, rc 86 stops, hard failures heal (relaunch, or
                shrink to the survivors), a wedged child is found by its
                frozen ``/status`` step; serving replicas respawn;
  supervise     its CLI, ``python -m mgwfbp_tpu_torch.runtime.supervise``.
"""

from __future__ import annotations


class ResizeUnsupported(RuntimeError):
    """Elastic resize was asked for where only resize-by-relaunch exists.

    A torch process drives one card, so a world of N processes cannot
    re-mesh in place to M: drain it (checkpoints are step-indexed and
    resume bit for bit), then relaunch the group at M processes. The
    message carries the recipe."""

    def __init__(self, reason: str, nworkers: int):
        super().__init__(
            f"{reason}. Elastic resize is resize-by-relaunch, and the "
            "supervisor automates it: launch with\n"
            "  python -m mgwfbp_tpu_torch.runtime.supervise --processes <N> "
            "--resize-to <M> -- <same train args>\n"
            "— the group drains through the agreed-preempt path (rc 75), "
            "relaunches at <M> processes with MGWFBP_ELASTIC_RESUME=1, and "
            "the run continues from the exact step (the shard-native "
            "checkpoint is read at the new world; the LR schedule continues "
            "from its anchor). Manual recipe: SIGTERM the group, then "
            "relaunch at the new size with MGWFBP_ELASTIC_RESUME=1 "
            f"(requested worker count: {nworkers})."
        )
        self.nworkers = nworkers


__all__ = ["ResizeUnsupported"]

"""Serving model plane: the forward + a hot-reloadable parameter snapshot.

Counterpart of ``mgwfbp_tpu/serving/model.py``. The load path is the
manifest-addressed ``ShardSource`` reader of the shard-native checkpoint
format: one full leaf at a time off the memmapped shard files, whether the
saver stored params sharded (``rs_opt_ag`` / ``rs_fwd_ag``) or replicated.
Leaves are matched to the module's parameters by their manifest path, and
each shape is checked, so a checkpoint of another model fails loudly.

Each ``LiveSnapshot`` owns its own copy of the module with the step's
weights on the device; the swap is one reference store behind a lock. A
request that grabbed the old snapshot keeps computing on the old weights,
a request after the swap sees the new ones — there is no state in between.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import threading
import time
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from mgwfbp_tpu_torch.checkpoint import (
    MANIFEST_FILE,
    SHARD_FORMAT_VERSION,
    SHARD_SUBDIR,
    CheckpointRestoreError,
    ShardSource,
    leaf_to_tensor,
)
from mgwfbp_tpu_torch.convert import flatten_flax, flax_path, params_from_flax, params_to_flax
from mgwfbp_tpu_torch.utils.device import resolve_device
from mgwfbp_tpu_torch.utils.logging import get_logger

SERVE_MAX_BATCH_ENV = "MGWFBP_SERVE_MAX_BATCH"
DEFAULT_MAX_BATCH = 8

log = get_logger("mgwfbp.serving.model")


def committed_sharded_steps(directory: str) -> list[int]:
    """Committed shard-native steps under a checkpoint directory, sorted.
    Commit is the atomic manifest rename, so manifest-present == safely
    readable; orbax-format steps are NOT listed."""
    shard_root = os.path.join(directory, SHARD_SUBDIR)
    out = []
    try:
        names = os.listdir(shard_root)
    except OSError:
        return []
    for name in names:
        if name.isdigit() and os.path.exists(
            os.path.join(shard_root, name, MANIFEST_FILE)
        ):
            out.append(int(name))
    return sorted(out)


def open_committed_step(directory: str, step: int) -> tuple[ShardSource, float]:
    """Validated reader over one committed shard-native step. Returns
    (source, commit wall time) where the commit time is the manifest's
    mtime — the atomic-rename instant that made the step visible, i.e. the
    start of the reload-lag clock."""
    step_dir = os.path.join(directory, SHARD_SUBDIR, f"{int(step):08d}")
    path = os.path.join(step_dir, MANIFEST_FILE)
    try:
        with open(path) as f:
            manifest = json.load(f)
        commit_wall = os.path.getmtime(path)
    except (OSError, ValueError) as e:
        raise CheckpointRestoreError(
            f"shard-native checkpoint step {step} in {directory!r} has no "
            f"readable manifest ({e}) — the save never committed or the "
            "directory is torn"
        ) from e
    if manifest.get("format_version") != SHARD_FORMAT_VERSION:
        raise CheckpointRestoreError(
            f"shard-native checkpoint step {step} in {directory!r} has "
            f"format_version {manifest.get('format_version')!r}; this "
            f"build reads version {SHARD_FORMAT_VERSION}"
        )
    src = ShardSource(step_dir, manifest)
    src.validate()
    return src, commit_wall


@dataclasses.dataclass(frozen=True)
class LiveSnapshot:
    """One served checkpoint: immutable by construction, swapped whole.
    `module` is this step's own copy of the model, in eval mode on the
    serving device; `step` is the train step the weights came from — every
    response built against this snapshot reports it as ``served_step``."""

    module: nn.Module
    step: int
    commit_wall: float  # manifest commit instant (wall clock)
    loaded_wall: float  # when the swap landed


class ServingModel:
    """The forward on one device + the hot-reload seam.

    ``run_padded`` is the ONLY compute path: the dispatcher packs every
    flush into the same fixed ``max_batch`` slot, and tests call it
    directly with the same padding, so a served answer and a direct
    forward on the same checkpoint cannot differ.
    """

    def __init__(
        self,
        module: nn.Module,
        meta,
        device: Optional[Union[str, torch.device]] = None,
        max_batch: Optional[int] = None,
    ):
        if meta.has_carry:
            raise ValueError(
                f"model {meta.name!r} carries BPTT state; stateful "
                "serving is not supported (serve a carry-free model)"
            )
        if meta.task == "ctc":
            raise ValueError(
                f"model {meta.name!r} is a CTC audio model; /predict "
                "serves classify and carry-free lm tasks only"
            )
        if max_batch is None:
            max_batch = int(
                os.environ.get(SERVE_MAX_BATCH_ENV) or DEFAULT_MAX_BATCH
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.module = module
        self.meta = meta
        self.max_batch = int(max_batch)
        self.input_np_dtype = np.dtype(meta.input_dtype)
        # the template every checkpoint must match: dotted Flax leaf path
        # -> Flax-layout shape, in the order jax flattens the tree
        self._template = {
            path: tuple(leaf.shape)
            for path, leaf in flatten_flax(params_to_flax(module)).items()
        }
        self._lock = threading.Lock()
        self._live: Optional[LiveSnapshot] = None

    # -- hot-reload seam ---------------------------------------------------
    def snapshot(self) -> Optional[LiveSnapshot]:
        with self._lock:
            return self._live

    def served_step(self) -> Optional[int]:
        snap = self.snapshot()
        return None if snap is None else snap.step

    def install_source(
        self, src: ShardSource, step: int, commit_wall: float
    ) -> LiveSnapshot:
        """Load one committed step's params off the manifest reader and
        swap it live."""
        bs_docs = (
            src.section_docs("batch_stats")
            if src.section_kind("batch_stats") != "none" else []
        )
        if bs_docs:
            raise CheckpointRestoreError(
                f"checkpoint step {step}: the manifest carries "
                f"{len(bs_docs)} batch_stats leaves, model "
                f"{self.meta.name!r} has none — saved from a different model"
            )
        state = params_from_flax(self._read_params(src))
        module = copy.deepcopy(self.module)
        module.load_state_dict(state, strict=True)
        module.to(self.device).eval()
        snap = LiveSnapshot(
            module=module,
            step=int(step),
            commit_wall=float(commit_wall),
            loaded_wall=time.time(),
        )
        with self._lock:
            self._live = snap
        return snap

    def load_step(self, directory: str, step: int) -> LiveSnapshot:
        src, commit_wall = open_committed_step(directory, step)
        return self.install_source(src, step, commit_wall)

    def _read_params(self, src: ShardSource) -> dict[str, torch.Tensor]:
        docs = src.section_docs("params")
        index = {flax_path(str(doc.get("path", ""))): j for j, doc in enumerate(docs)}
        missing = [p for p in self._template if p not in index]
        extra = [p for p in index if p not in self._template]
        if len(docs) != len(self._template) or missing or extra:
            raise CheckpointRestoreError(
                f"checkpoint {src.step_dir!r}: params has {len(docs)} "
                f"leaves, model {self.meta.name!r} expects "
                f"{len(self._template)} — saved from a different model "
                f"(missing {missing[:5]}, unexpected {extra[:5]})",
                mismatches=missing + extra,
            )
        out = {}
        for path, want in self._template.items():
            j = index[path]
            doc = docs[j]
            got = tuple(doc.get("shape", ()))
            if got != want:
                raise CheckpointRestoreError(
                    f"checkpoint {src.step_dir!r}: params leaf {j} ({path}) "
                    f"has shape {got}, model expects {want} — saved from a "
                    "different model"
                )
            host = src.read_leaf("params", j)
            out[path] = leaf_to_tensor(host, doc["dtype"]).to(torch.float32)
        return out

    # -- the one compute path ----------------------------------------------
    def check_inputs(self, x: np.ndarray) -> None:
        """Raise ValueError for inputs the forward must not see: token ids
        outside the vocabulary would index past the embedding table (a
        device-side fault on the card, sticky for the process)."""
        if self.meta.task == "lm" and x.size:
            lo, hi = int(x.min()), int(x.max())
            if lo < 0 or hi >= self.meta.num_classes:
                raise ValueError(
                    f"token ids must lie in [0, {self.meta.num_classes}), "
                    f"got range [{lo}, {hi}]"
                )

    def run_padded(self, x: np.ndarray) -> tuple[np.ndarray, int]:
        """Forward `x` (n <= max_batch examples) through the live
        snapshot: pads to the fixed slot, runs the forward, slices the
        padding back off. Returns (outputs, the served train step). The
        snapshot is read ONCE — every example in the call is answered by
        the same checkpoint."""
        snap = self.snapshot()
        if snap is None:
            raise RuntimeError("no checkpoint served yet")
        x = np.asarray(x, self.input_np_dtype)
        want = tuple(self.meta.input_shape)
        if x.ndim != len(want) + 1 or tuple(x.shape[1:]) != want:
            raise ValueError(
                f"inputs must be (n, {', '.join(map(str, want))}), "
                f"got {tuple(x.shape)}"
            )
        n = int(x.shape[0])
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"batch of {n} examples exceeds the serve slot "
                f"({self.max_batch}); split the request"
            )
        self.check_inputs(x)
        if n < self.max_batch:
            pad = np.zeros(
                (self.max_batch - n,) + want, self.input_np_dtype
            )
            x = np.concatenate([x, pad], axis=0)
        with torch.inference_mode():
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            out = snap.module(xd)
            if isinstance(out, tuple):  # aux-logit heads (googlenet style)
                out = out[0]
            host = out[:n].float().cpu().numpy()
        return host, snap.step

"""Shard-native checkpoints (counterpart of the shard-native part of
``mgwfbp_tpu/checkpoint.py``).

The format is plain numpy: per step, ``<dir>/sharded/<step:08d>/`` holds one
``p<i>/`` subtree of ``.npy`` files per process plus one ``manifest.json``
that records the world size, the per-leaf layout and, for sharded
sections, which merge group and offset each parameter leaf packs into. The
manifest is renamed into place last, so its presence is the commit marker.
A ``steps_index.json`` sidecar beside ``sharded/`` (replaced atomically)
maps each step to its epoch bookkeeping; a lost sidecar entry is healed
from the manifest's own ``meta``.

``Checkpointer`` is the JAX package's manager for this format, copied (this
package does not import that one): synchronous saves
(``save_sharded``), the asynchronous single-slot writer (``submit_sharded``,
``poll_async``, ``drain_async``, ``abandon_async``), the commit barrier of a
multi-process group (``runtime.coordination``), class-aware garbage
collection that keeps epoch boundaries, the listings (``latest_step``,
``latest_epoch``, ``all_epochs``) and ``restore`` into a template, which
diffs every saved leaf against it and names the offending leaf on a
mismatch (config drift). A sharded optimizer section (each rank's rows of
``opt.s{slot}.g{gi}`` under the manifest's ``layout``, written by an
``rs_opt_ag`` or ``rs_fwd_ag`` run of either package) and a sharded
parameter section (each rank's rows of ``params.g{gi}``, the ``rs_fwd_ag``
carry) restore like replicated ones: each leaf is re-sliced out of the
shard rows through ``ShardSource.leaf_slice_reader``, whatever the world
and the merge schedule that wrote them, so every lowering restores every
other's steps (the trainer re-scatters the result onto its own layout).
What the port cannot read it refuses by name: the orbax ("replicated",
legacy epoch-keyed) format, which needs orbax (ROADMAP Queue 1 item 2 keeps
it refused). A restore hands back a ``Snapshot`` whose ``TrainState`` holds
host numpy arrays in Flax form; the trainer installs them on its modules.

``ShardSource`` is a copy of the JAX package's reader: it reads replicated
and sharded sections alike, one leaf or one element range at a time off
numpy memmaps; ``read_step`` reads a step's params and batch statistics.
``save_replicated_step`` commits, through ``Checkpointer``, what the JAX
trainer writes for a single-process ``all_reduce`` run without an
optimizer section.

numpy has no bfloat16 without the ``ml_dtypes`` package, which this package
does not need: a bfloat16 leaf is carried as its raw 16-bit patterns
(``uint16``) and ``leaf_to_tensor`` turns it into a torch bfloat16 tensor.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from mgwfbp_tpu_torch.convert import flatten_flax, flax_path, keystr
from mgwfbp_tpu_torch.runtime import coordination as coord

INDEX_FILE = "steps_index.json"
INDEX_VERSION = 1
SHARD_SUBDIR = "sharded"
MANIFEST_FILE = "manifest.json"
SHARD_FORMAT_VERSION = 1

_BF16_STORAGE = np.dtype(np.uint16)


class CheckpointRestoreError(RuntimeError):
    """A checkpoint exists but cannot be restored into the current model
    structure. Carries the offending leaves (shape/dtype/structure diffs)
    and names the likely cause: config drift between the saving and
    restoring run."""

    def __init__(self, message: str, mismatches: Optional[list[str]] = None):
        super().__init__(message)
        self.mismatches = list(mismatches or [])


@dataclasses.dataclass
class TrainState:
    """The train state a checkpoint holds, in host form (the JAX
    ``TrainState``'s fields): ``params`` and ``batch_stats`` map dotted Flax
    leaf paths to numpy arrays in Flax layout and flatten order;
    ``opt_state`` maps the optax tree's ``keystr`` paths to its leaves in
    optax's flatten order (None: no optimizer section, the optimizer keeps
    its own state); ``step`` is the optimizer updates applied; ``rng`` the
    JAX train-state key the manifest carries."""

    step: int
    params: dict
    batch_stats: dict
    opt_state: Optional[dict] = None
    rng: Optional[list] = None


@dataclasses.dataclass
class Snapshot:
    state: TrainState
    epoch: int
    iteration: int
    # optimizer steps already completed INSIDE `epoch`; 0 on an epoch
    # boundary. The loader is a pure function of (seed, epoch, batch
    # index), so (epoch, epoch_step) is the whole data-iterator position.
    epoch_step: int = 0
    mid_epoch: bool = False
    # the BPTT carry's leaves in Flax's flatten order (a tuple over layers
    # of (c, h)), global batch rows; None for a model without one
    carry: Optional[list] = None
    # the manifest's meta section (saved world, steps_per_epoch, the
    # schedule's anchor, opt_count)
    manifest_meta: Optional[dict] = None
    # this package's own generator states of the saving process
    # ({"cpu": uint8 array, "cuda": uint8 array}), which the JAX reader
    # ignores; None when the saver was not this package
    torch_rng: Optional[dict] = None


def shape_only(shape, dtype) -> np.ndarray:
    """A zero-byte array of ``shape`` and ``dtype``: a restore template's
    leaf, which only its shape and dtype describe."""
    return np.broadcast_to(np.empty((), np.dtype(dtype)), tuple(shape))


def _np_dtype(name: str) -> np.dtype:
    """Resolve a manifest dtype string. bfloat16 resolves to its 16-bit
    storage type (see the module docstring)."""
    name = str(name)
    if name == "bfloat16":
        return _BF16_STORAGE
    return np.dtype(name)


def _viewed(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Reinterpret raw bytes as `dtype`. np.load round-trips extended
    dtypes (bfloat16) as void records of the same itemsize; the manifest
    dtype is authoritative, so view the bytes back."""
    arr = np.asarray(arr)
    if arr.dtype == dtype:
        return arr
    if arr.dtype.itemsize != dtype.itemsize:
        raise ValueError(
            f"cannot view {arr.dtype} as {dtype}: itemsize "
            f"{arr.dtype.itemsize} != {dtype.itemsize}"
        )
    return arr.view(dtype)


def leaf_to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A leaf read off a manifest (numpy, in the storage type of its
    manifest dtype) as a CPU tensor of that dtype."""
    arr = np.ascontiguousarray(arr)
    if str(dtype_name) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


class ShardSource:
    """Reader over one committed shard-native step directory.

    All file access is through numpy memmaps sliced per element range, so
    a consumer re-slicing an N-way layout onto M shard rows touches only
    the bytes those rows need — never a world-sized buffer, never a full
    replicated leaf unless `read_leaf` (the replicated-target path) is
    called explicitly.
    """

    def __init__(self, step_dir: str, manifest: dict):
        self.step_dir = step_dir
        self.manifest = manifest
        self._mmaps: dict[str, np.ndarray] = {}
        # row -> owning process (lowest-index owner wins, mirroring the
        # save-side dedup rule)
        self._row_owner: dict[int, tuple[int, int]] = {}
        for p, doc in sorted(
            (int(k), v) for k, v in (manifest.get("processes") or {}).items()
        ):
            for pos, r in enumerate(doc.get("rows", ())):
                self._row_owner.setdefault(int(r), (p, pos))

    # -- raw file access ---------------------------------------------------
    def _file(self, proc: int, name: str) -> str:
        return os.path.join(self.step_dir, f"p{proc:05d}", name + ".npy")

    def _mmap(self, proc: int, name: str, shape, dtype: np.dtype):
        key = f"{proc}/{name}"
        mm = self._mmaps.get(key)
        if mm is None:
            path = self._file(proc, name)
            try:
                mm = np.load(path, mmap_mode="r")
            except (OSError, ValueError) as e:
                raise CheckpointRestoreError(
                    f"shard-native checkpoint {self.step_dir!r} is missing "
                    f"or corrupt: process {proc} file {name}.npy "
                    f"({e})"
                ) from e
            self._mmaps[key] = mm
        want = tuple(int(s) for s in shape)
        if tuple(mm.shape) != want:
            raise CheckpointRestoreError(
                f"shard-native checkpoint {self.step_dir!r}: process "
                f"{proc} file {name}.npy has shape {tuple(mm.shape)}, "
                f"manifest expects {want} {np.dtype(dtype).name} — the "
                "payload is truncated or was written by a different run"
            )
        return mm

    # -- manifest accessors ------------------------------------------------
    @property
    def world(self) -> int:
        return int(self.manifest["world"])

    @property
    def meta(self) -> dict:
        return dict(self.manifest.get("meta") or {})

    @property
    def leaves(self) -> list[dict]:
        return list(self.manifest.get("leaves") or [])

    def section_kind(self, section: str) -> str:
        return str((self.manifest.get(section) or {}).get("kind", "none"))

    def section_docs(self, section: str) -> list[dict]:
        """Per-leaf docs of a section. `params` (sharded or replicated)
        and sharded `opt` slots mirror the parameter tree; replicated
        `opt`/`batch_stats` carry their own flattened leaf lists."""
        if section == "params":
            return self.leaves
        doc = self.manifest.get(section) or {}
        if section == "opt" and doc.get("kind") == "sharded":
            return self.leaves
        return list(doc.get("leaves") or [])

    def opt_slots(self) -> int:
        return int((self.manifest.get("opt") or {}).get("slots", 0))

    # -- sharded-section readers -------------------------------------------
    def leaf_slice_reader(
        self, section: str, slot: Optional[int] = None
    ) -> Callable[[int, int, int], np.ndarray]:
        """Returns read(leaf_index, start, stop) -> flat array of that
        element range of tree leaf `leaf_index`, regardless of whether the
        source section is stored sharded (group-row files) or replicated
        (per-leaf files). For the replicated `opt` section a `slot`
        addresses the optax tree through the saver-recorded
        slot_leaf_index map (slot s of params-tree leaf j -> flat optax
        leaf), so a sharded target can re-slice a replicated-opt source."""
        kind = self.section_kind(section)
        prefix = section if slot is None else f"{section}.s{slot}"
        if kind == "replicated":
            docs = self.section_docs(section)
            remap = None
            if section == "opt" and slot is not None:
                idx_map = (self.manifest.get("opt") or {}).get(
                    "slot_leaf_index"
                )
                if idx_map is None:
                    raise CheckpointRestoreError(
                        f"checkpoint {self.step_dir!r}: replicated "
                        "optimizer section has no slot_leaf_index map — "
                        "cannot re-slice it onto a sharded optimizer"
                    )
                remap = [int(x) for x in idx_map[int(slot)]]

            def read_rep(j: int, a: int, b: int) -> np.ndarray:
                k = remap[j] if remap is not None else j
                doc = docs[k]
                dt = _np_dtype(doc["dtype"])
                mm = self._mmap(0, f"{section}.l{k}", doc["shape"], dt)
                flat = np.asarray(mm).reshape(-1)
                return _viewed(flat[a:b], dt)

            return read_rep
        if kind != "sharded":
            raise CheckpointRestoreError(
                f"checkpoint {self.step_dir!r} has no {section!r} section "
                f"(kind={kind!r}) — saved under a different configuration"
            )
        layout = self.manifest["layout"]
        shard_sizes = [int(s) for s in layout["shard_sizes"]]
        dtypes = [_np_dtype(d) for d in layout["group_dtypes"]]
        slots = [tuple(int(x) for x in s) for s in layout["leaf_slots"]]

        def read(j: int, a: int, b: int) -> np.ndarray:
            gi, off = slots[j]
            s = shard_sizes[gi]
            dt = dtypes[gi]
            out = np.empty((b - a,), dt)
            lo = off + a
            hi = off + b
            pos = lo
            while pos < hi:
                r = pos // s
                owner = self._row_owner.get(r)
                if owner is None:
                    raise CheckpointRestoreError(
                        f"checkpoint {self.step_dir!r}: shard row {r} of "
                        f"group {gi} belongs to no process in the manifest"
                    )
                proc, local = owner
                nrows = len(self.manifest["processes"][str(proc)]["rows"])
                mm = self._mmap(proc, f"{prefix}.g{gi}", (nrows, s), dt)
                c0 = pos - r * s
                c1 = min(hi - r * s, s)
                seg = _viewed(mm[local, c0:c1], dt)
                out[pos - lo : pos - lo + (c1 - c0)] = seg
                pos = r * s + c1
            return out

        return read

    def read_leaf(self, section: str, j: int, slot: Optional[int] = None):
        """One FULL leaf (replicated-target path — materializes the
        leaf, by design). With `slot`, `j` indexes the parameter tree
        (slot subtrees mirror it); otherwise the section's own docs."""
        docs = self.leaves if slot is not None else self.section_docs(section)
        doc = docs[j]
        n = int(np.prod(doc["shape"])) if doc["shape"] else 1
        read = self.leaf_slice_reader(section, slot=slot)
        return read(j, 0, n).reshape([int(s) for s in doc["shape"]])

    def read_rows(
        self,
        section: str,
        slot: Optional[int],
        dst_leaf_slots: list[tuple[int, int]],
        dst_shard_sizes: list[int],
        dst_group_dtypes: list[np.dtype],
        rows: list[int],
    ) -> list[np.ndarray]:
        """Re-slice the source section onto a DESTINATION padded-bucket
        layout: returns, per destination group, the (len(rows), shard)
        buffer holding exactly `rows` of the destination's (world, shard)
        global buffer. Padding regions are zero (bitwise-identical to what
        a fresh scatter packs). Only the source bytes those rows cover are
        read — no world-sized intermediate, no full leaf."""
        read = self.leaf_slice_reader(section, slot=slot)
        leaves = self.leaves
        sizes = [
            int(np.prod(doc["shape"])) if doc["shape"] else 1
            for doc in leaves
        ]
        # destination group -> [(leaf j, offset)] members
        members: dict[int, list[tuple[int, int]]] = {}
        for j, (gi, off) in enumerate(dst_leaf_slots):
            members.setdefault(int(gi), []).append((j, int(off)))
        out = []
        row_pos = {r: k for k, r in enumerate(rows)}
        for gi, s in enumerate(dst_shard_sizes):
            buf = np.zeros((len(rows), int(s)), dst_group_dtypes[gi])
            for j, off in members.get(gi, ()):
                n = sizes[j]
                for r in rows:
                    lo = max(off, r * s)
                    hi = min(off + n, (r + 1) * s)
                    if lo >= hi:
                        continue
                    seg = read(j, lo - off, hi - off)
                    buf[row_pos[r], lo - r * s : hi - r * s] = seg
            out.append(buf)
        return out

    # -- carry -------------------------------------------------------------
    def carry_doc(self) -> Optional[dict]:
        return self.manifest.get("carry") or None

    def _carry_runs(self) -> list[tuple[int, int, int, int]]:
        """(start, stop, process, offset-in-file) per saved run: each
        process's file concatenates its runs in manifest order, so the
        file offset of a run is the length of that process's earlier
        runs. Runs may interleave across processes (multi-slice data
        shardings do); the reader never assumes contiguity."""
        out = []
        for p, runs in (self.carry_doc().get("runs") or {}).items():
            off = 0
            for a, b in runs:
                out.append((int(a), int(b), int(p), off))
                off += int(b) - int(a)
        return sorted(out)

    def read_carry_range(self, li: int, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) of carry leaf `li` along dim 0, assembled
        from whichever processes' local blocks cover them."""
        doc = self.carry_doc()
        leaf = doc["leaves"][li]
        dt = _np_dtype(leaf["dtype"])
        gshape = [int(s) for s in leaf["shape"]]
        runs = self._carry_runs()
        file_rows = {}
        for a, b, p, _ in runs:
            file_rows[p] = file_rows.get(p, 0) + (b - a)
        pieces = []
        pos = start
        while pos < stop:
            hit = None
            for a, b, p, off in runs:
                if a <= pos < b:
                    hit = (a, b, p, off)
                    break
            if hit is None:
                raise CheckpointRestoreError(
                    f"checkpoint {self.step_dir!r}: carry rows "
                    f"[{pos}, {stop}) of leaf {li} are covered by no "
                    "process in the manifest"
                )
            a, b, p, off = hit
            mm = self._mmap(
                p, f"carry.l{li}", [file_rows[p]] + gshape[1:], dt
            )
            hi = min(b, stop)
            lo_f = off + (pos - a)
            hi_f = off + (hi - a)
            pieces.append(_viewed(mm[lo_f:hi_f], dt))
            pos = hi
        return np.concatenate(pieces) if len(pieces) > 1 else np.array(
            pieces[0]
        )

    # -- validation (satellite: fail fast, named) ---------------------------
    def validate(self) -> None:
        """Probe every file the manifest promises; a missing/truncated/
        mis-shaped shard fails HERE with the process, section, and
        expected-vs-found layout — never a raw numpy traceback deep in a
        restore."""
        problems: list[str] = []
        m = self.manifest
        layout = m.get("layout") or {}
        shard_sizes = [int(s) for s in layout.get("shard_sizes", ())]
        dtypes = [str(d) for d in layout.get("group_dtypes", ())]
        sharded_sections: list[tuple[str, Optional[int]]] = []
        if self.section_kind("params") == "sharded":
            sharded_sections.append(("params", None))
        if self.section_kind("opt") == "sharded":
            for s in range(self.opt_slots()):
                sharded_sections.append(("opt", s))
        for p_str, doc in sorted((m.get("processes") or {}).items()):
            p = int(p_str)
            rows = list(doc.get("rows", ()))
            for section, slot in sharded_sections:
                prefix = section if slot is None else f"{section}.s{slot}"
                for gi, s in enumerate(shard_sizes):
                    name = f"{prefix}.g{gi}"
                    want = (len(rows), s)
                    problems.extend(
                        self._check_file(p, name, want, dtypes[gi])
                    )
            carry = m.get("carry") or None
            if carry and p_str in (carry.get("runs") or {}):
                nrows = sum(
                    int(b) - int(a) for a, b in carry["runs"][p_str]
                )
                for li, leaf in enumerate(carry["leaves"]):
                    want = tuple(
                        [nrows] + [int(x) for x in leaf["shape"][1:]]
                    )
                    problems.extend(self._check_file(
                        p, f"carry.l{li}", want, leaf["dtype"],
                    ))
        for section in ("params", "opt", "batch_stats"):
            kind = self.section_kind(section)
            if kind != "replicated":
                continue
            docs = (
                self.leaves if section == "params"
                else (self.manifest.get(section) or {}).get("leaves") or []
            )
            for j, doc in enumerate(docs):
                problems.extend(self._check_file(
                    0, f"{section}.l{j}", tuple(doc["shape"]), doc["dtype"],
                    leaf=doc.get("path"),
                ))
        if problems:
            raise CheckpointRestoreError(
                f"shard-native checkpoint step {m.get('step')} in "
                f"{self.step_dir!r} failed validation; offending "
                "shard(s):\n  " + "\n  ".join(problems[:20]),
                mismatches=problems,
            )

    def _check_file(
        self, proc: int, name: str, want_shape, want_dtype,
        leaf: Optional[str] = None,
    ) -> list[str]:
        where = f"process {proc}, file {name}.npy"
        if leaf:
            where += f" (leaf {leaf})"
        path = self._file(proc, name)
        try:
            mm = np.load(path, mmap_mode="r")
        except FileNotFoundError:
            return [f"{where}: missing (expected "
                    f"{tuple(want_shape)} {want_dtype})"]
        except (OSError, ValueError) as e:
            return [f"{where}: unreadable ({e}); expected "
                    f"{tuple(want_shape)} {want_dtype}"]
        if tuple(mm.shape) != tuple(want_shape):
            return [f"{where}: found shape {tuple(mm.shape)}, expected "
                    f"{tuple(want_shape)} {want_dtype}"]
        if mm.dtype.itemsize != _np_dtype(want_dtype).itemsize:
            return [f"{where}: found dtype {mm.dtype}, expected "
                    f"{want_dtype}"]
        return []


def save_replicated_step(
    directory: str, step: int, params: Mapping[str, Any],
    *, batch_stats: Optional[Mapping[str, Any]] = None,
    meta: Optional[dict] = None,
) -> str:
    """Commit one step of ``params`` and ``batch_stats`` (Flax-form trees,
    nested or flat dotted dicts of numpy arrays, e.g. from
    ``convert.variables_to_flax(module)``) through ``Checkpointer`` (no
    garbage collection), as a single-process ``all_reduce`` run of the JAX
    trainer writes it: no optimizer section, so a restore keeps its own
    optimizer state. A step already committed is left as it is (the
    manager's dedup). Returns the step directory."""
    files: dict[str, np.ndarray] = {}
    docs: dict[str, list[dict]] = {}
    for section, tree in (("params", params), ("batch_stats", batch_stats)):
        docs[section] = []
        for j, (path, leaf) in enumerate(flatten_flax(tree or {}).items()):
            arr = np.ascontiguousarray(leaf)
            docs[section].append(_leaf_doc(keystr(path), arr))
            files[f"{section}.l{j}"] = arr
    manifest = {
        "format_version": SHARD_FORMAT_VERSION,
        "step": int(step),
        "world": 1,
        "process_count": 1,
        "mesh_axes": {"data": 1, "seq": 1},
        "comm_op": "all_reduce",
        "leaves": docs["params"],
        "rng": [],
        "meta": dict(meta or {"iteration": int(step)}),
        "params": {"kind": "replicated"},
        "batch_stats": {"kind": "replicated", "leaves": docs["batch_stats"]},
    }
    ckpt = Checkpointer(directory, max_to_keep=0)
    ckpt.save_sharded(manifest, files)
    return ckpt._shard_step_dir(step)


def open_step(step_dir: str) -> ShardSource:
    """Validated reader over a committed shard-native step directory."""
    try:
        with open(os.path.join(step_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointRestoreError(
            f"shard-native checkpoint {step_dir!r} has no readable manifest "
            f"({e}) — the save never committed or the directory is torn"
        ) from e
    if manifest.get("format_version") != SHARD_FORMAT_VERSION:
        raise CheckpointRestoreError(
            f"shard-native checkpoint {step_dir!r} has format_version "
            f"{manifest.get('format_version')!r}; this build reads version "
            f"{SHARD_FORMAT_VERSION}"
        )
    src = ShardSource(step_dir, manifest)
    src.validate()
    return src


def read_step(directory: str, step: int) -> tuple[dict, dict, dict]:
    """(params, batch_stats, meta) of a committed step, whichever package
    wrote it: flat dicts of dotted Flax path -> numpy array (the storage
    type of the manifest dtype) and the manifest's ``meta``."""
    src = open_step(os.path.join(directory, SHARD_SUBDIR, f"{int(step):08d}"))

    def section(name: str) -> dict:
        if src.section_kind(name) == "none":
            return {}
        return {
            flax_path(doc["path"]): np.asarray(src.read_leaf(name, j))
            for j, doc in enumerate(src.section_docs(name))
        }

    return section("params"), section("batch_stats"), src.meta


# ---------------------------------------------------------------------------
# the manager: sidecar index, commits, async writer, GC, restore
# ---------------------------------------------------------------------------


def _leaf_doc(path: str, arr: Any) -> dict:
    return {
        "path": str(path),
        "shape": [int(x) for x in np.shape(arr)],
        "dtype": np.dtype(arr.dtype).name,
    }


def _doc_matches(doc: dict, arr: Any) -> bool:
    return (
        tuple(doc.get("shape", ())) == tuple(np.shape(arr))
        and _np_dtype(doc.get("dtype", "float32")) == np.dtype(arr.dtype)
    )


def _leaf_desc(arr: Any) -> str:
    if arr is None:
        return "nothing"
    return f"{np.dtype(arr.dtype).name}{tuple(np.shape(arr))}"


def _fsync_dir_files(directory: str) -> None:
    """fsync every regular file under ``directory`` and the directory
    entry itself (best effort where directories cannot be fsynced)."""
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _orbax_steps(directory: str) -> list[int]:
    """Step directories of the orbax format (a digit-named directory at the
    top of the run directory)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        int(n) for n in names
        if n.isdigit() and os.path.isdir(os.path.join(directory, n))
    )


def peek_steps(directory: str) -> list[int]:
    """Committed-looking steps of either format under a checkpoint
    directory, without opening anything (a cheap probe)."""
    out = set(_orbax_steps(directory))
    shard_root = os.path.join(directory, SHARD_SUBDIR)
    try:
        names = os.listdir(shard_root)
    except OSError:
        names = []
    for name in names:
        if name.isdigit() and os.path.exists(
            os.path.join(shard_root, name, MANIFEST_FILE)
        ):
            out.add(int(name))
    return sorted(out)


ORBAX_REFUSAL = (
    "the orbax checkpoint format ('--ckpt-format replicated' and the legacy "
    "epoch-keyed payloads) needs orbax, which the PyTorch port does not "
    "use; it reads and writes the shard-native format only (ROADMAP Queue "
    "1 item 2: the orbax format stays refused)"
)


class _AsyncShardSave:
    """One in-flight asynchronous shard-native save (single slot).

    The submitting (step-loop) thread fills every field, hands the slot to
    the writer thread and touches nothing but ``done`` until it is set;
    the writer owns ``error`` and ``final`` until then. Every group
    operation (step agreement, dedup vote, payload barrier, manifest
    commit) runs on the submitting thread; the writer does local file I/O
    only, so the collectives keep one thread and one program order."""

    def __init__(self, step: int, manifest: dict, entry: dict, nbytes: int):
        self.step = step
        self.manifest = manifest
        self.entry = entry
        self.nbytes = nbytes
        self.t0 = time.perf_counter()
        self.final: Optional[str] = None
        self.error: Optional[str] = None
        self.done = threading.Event()
        self.thread: Optional[threading.Thread] = None


class Checkpointer:
    """Step-indexed checkpoint manager over one run directory (the
    shard-native format)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)
        self._index = self._load_index()
        self._async: Optional[_AsyncShardSave] = None

    # -- sidecar index ----------------------------------------------------
    def _index_path(self) -> str:
        return os.path.join(self._dir, INDEX_FILE)

    def _load_index(self) -> dict:
        try:
            with open(self._index_path()) as f:
                idx = json.load(f)
        except (OSError, ValueError):
            return {}
        if idx.get("version") != INDEX_VERSION:
            return {}
        return dict(idx.get("steps", {}))

    def _write_index(self) -> None:
        # drop entries whose payload was collected, then write-temp +
        # rename, so a kill mid-write never corrupts the index; one writer
        # (process 0): the commit barrier orders everyone behind it
        live = {str(s) for s in self.all_steps()}
        self._index = {k: v for k, v in self._index.items() if k in live}
        if not coord.is_primary():
            return
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": INDEX_VERSION, "steps": self._index}, f)
        os.replace(tmp, self._index_path())

    # -- listing ----------------------------------------------------------
    def _shard_root(self) -> str:
        return os.path.join(self._dir, SHARD_SUBDIR)

    def _shard_step_dir(self, step: int) -> str:
        return os.path.join(self._shard_root(), f"{int(step):08d}")

    def _sharded_steps(self) -> list[int]:
        """Committed (manifest present) shard-native steps."""
        try:
            names = os.listdir(self._shard_root())
        except OSError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.exists(
                os.path.join(self._shard_root(), n, MANIFEST_FILE)
            )
        )

    def all_steps(self) -> list[int]:
        """Every committed step, both formats (an orbax step is listed so
        that a restore of it is refused by name, not skipped)."""
        return sorted(set(_orbax_steps(self._dir)) | set(self._sharded_steps()))

    def entry_format(self, step: int) -> Optional[str]:
        """'sharded' | 'orbax' | None for an uncommitted step."""
        if os.path.exists(os.path.join(self._shard_step_dir(step),
                                       MANIFEST_FILE)):
            return "sharded"
        if step in _orbax_steps(self._dir):
            return "orbax"
        return None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def _epoch_boundaries(self) -> dict[int, int]:
        """{epoch: step} for every epoch-boundary snapshot; an orbax step
        absent from the index is a legacy epoch-keyed save (step == epoch)."""
        out: dict[int, int] = {}
        sharded = set(self._sharded_steps())
        for step in self.all_steps():
            entry = self._index.get(str(step))
            if entry is None and step in sharded:
                entry = self._heal_sharded_entry(step)
            if entry is None:
                out[int(step)] = int(step)
            elif not entry.get("mid_epoch", False):
                out[int(entry["epoch"])] = int(step)
        return out

    def _heal_sharded_entry(self, step: int) -> dict:
        """Index entry rebuilt from a committed manifest (the sidecar write
        was killed between the commit and its rename). Repairs the
        in-memory index; the next save persists it."""
        try:
            with open(os.path.join(self._shard_step_dir(step),
                                   MANIFEST_FILE)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        meta = doc.get("meta") or {}
        entry = {
            "format": "sharded",
            "epoch": int(meta.get("epoch", 0)),
            "epoch_step": int(meta.get("epoch_step", 0)),
            "mid_epoch": bool(meta.get("mid_epoch", False)),
            "has_carry": bool(doc.get("carry")),
        }
        self._index[str(step)] = entry
        return entry

    def latest_epoch(self) -> Optional[int]:
        bounds = self._epoch_boundaries()
        return max(bounds) if bounds else None

    def all_epochs(self) -> list[int]:
        return sorted(self._epoch_boundaries())

    def open_sharded(self, step: int) -> ShardSource:
        """Validated reader over a committed shard-native step."""
        return open_step(self._shard_step_dir(step))

    # -- save -------------------------------------------------------------
    def save_sharded(self, manifest: dict, files: dict[str, np.ndarray],
                     wait: bool = False) -> dict:
        """Write THIS process's ``files`` under its own subtree, then commit
        through the manifest and the sidecar (process 0) behind the group's
        barriers. Saving onto an already-committed step only promotes the
        index entry (an epoch boundary landing on a fresh step save).
        ``wait`` fsyncs the payload and the commit record (the drain's
        durability). Returns {"duration_s", "bytes"}."""
        self.drain_async(durable=wait)
        t0 = time.perf_counter()
        step, entry, nbytes, already = self._sharded_head(manifest, files)
        # mgwfbp: group-uniform -- 'already' is the agree_all dedup vote from _sharded_head: every process holds the same value
        if already:
            self._promote_sharded(step, manifest, entry)
            return {"duration_s": time.perf_counter() - t0, "bytes": 0}
        self._write_shard_payload(step, files, wait=wait)
        self._commit_sharded(step, manifest, entry, wait=wait)
        return {"duration_s": time.perf_counter() - t0, "bytes": nbytes}

    def _sharded_head(self, manifest: dict, files: dict
                      ) -> tuple[int, dict, int, bool]:
        """The group-agreed preamble of every save: the step key's
        uniformity, the sidecar entry, the payload size and the dedup
        vote (on the submitting thread, for the async path too)."""
        step = int(manifest["step"])
        if coord.process_count() > 1 and not coord.agree_uniform(float(step)):
            raise RuntimeError(
                f"shard-native save: processes disagree on the step key "
                f"(this process: {step}) — the group diverged; refusing to "
                "commit a torn checkpoint"
            )
        meta = manifest.get("meta") or {}
        entry = {
            "format": "sharded",
            "epoch": int(meta.get("epoch", 0)),
            "epoch_step": int(meta.get("epoch_step", 0)),
            "mid_epoch": bool(meta.get("mid_epoch", False)),
            "has_carry": bool(manifest.get("carry")),
        }
        nbytes = int(sum(np.asarray(a).nbytes for a in files.values()))
        already = step in self.all_steps()
        if coord.process_count() > 1:
            # promote only when EVERY process sees the step committed: a
            # split decision would be a split collective sequence
            already = coord.agree_all(already)
        return step, entry, nbytes, already

    def _promote_sharded(self, step: int, manifest: dict, entry: dict) -> None:
        """Index-entry promotion for an already-committed step: the payload
        is immutable, only the entry's epoch and boundary class may move,
        never from boundary back to mid-epoch."""
        meta = manifest.get("meta") or {}
        prev = self._index.get(str(step), {})
        if prev:
            entry = dict(prev)
            entry["epoch"] = int(meta.get("epoch", entry.get("epoch", 0)))
            if not meta.get("mid_epoch", False):
                entry["mid_epoch"] = False
        self._index[str(step)] = entry
        self._gc()
        self._write_index()
        self._commit_barrier(step)

    def _write_shard_payload(self, step: int, files: dict,
                             wait: bool) -> str:
        """THIS process's subtree: tmp dir, np.save, os.replace. Local file
        work only, which is what lets it run on the writer thread."""
        step_dir = self._shard_step_dir(step)
        pid = coord.process_index()
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, f".tmp.p{pid:05d}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        for name, arr in files.items():
            np.save(os.path.join(tmp, name + ".npy"), np.asarray(arr))
        final = os.path.join(step_dir, f"p{pid:05d}")
        if os.path.isdir(final):  # a torn earlier attempt never committed
            shutil.rmtree(final)
        os.replace(tmp, final)
        if wait:
            _fsync_dir_files(final)
        return final

    def _commit_sharded(self, step: int, manifest: dict, entry: dict,
                        wait: bool) -> None:
        """Payload barrier, process 0's manifest and sidecar, the group's
        success vote, the commit barrier. Collective: always on the
        submitting thread. A local failure becomes a group decision, so
        that no process waits out a barrier on one that already
        unwound."""
        if coord.process_count() > 1:
            coord.barrier(f"ckpt_shard_payload_{step}")
        step_dir = self._shard_step_dir(step)
        commit_err: Optional[str] = None
        try:
            if coord.is_primary():
                mpath = os.path.join(step_dir, MANIFEST_FILE)
                mtmp = mpath + ".tmp"
                with open(mtmp, "w") as f:
                    json.dump(manifest, f)
                    if wait:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(mtmp, mpath)
            self._index[str(step)] = entry
            self._gc()
            self._write_index()
            if wait and coord.is_primary():
                _fsync_dir_files(step_dir)
                try:
                    fd = os.open(self._index_path(), os.O_RDONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                except OSError:
                    pass
        except (OSError, ValueError, TypeError) as e:
            commit_err = f"{type(e).__name__}: {e}"
        ok = commit_err is None
        if coord.process_count() > 1:
            ok = coord.agree_all(ok)
        if not ok:
            raise RuntimeError(
                f"shard-native commit of step {step} failed "
                f"({commit_err or 'on a peer process'}); no process "
                "recorded the step as committed — restore falls back to the "
                "previous checkpoint"
            )
        self._commit_barrier(step)

    def _commit_barrier(self, step: int) -> None:
        if coord.process_count() > 1:
            coord.barrier(f"ckpt_commit_{step}")

    # -- async save -------------------------------------------------------
    def submit_sharded(self, manifest: dict,
                       files: dict[str, np.ndarray]) -> Optional[dict]:
        """Start a save without blocking the step loop on the payload
        write: the group-agreed preamble runs here, the np.save on a
        writer thread, the commit later on this thread (``poll_async`` /
        ``drain_async``).

        The caller hands ``files`` over: arrays it owns (host copies made
        for this save), never views of live state that a later step
        updates in place. Returns None while the save is in flight, or the
        sync stats when the step was already committed (promotion)."""
        self.drain_async()
        t0 = time.perf_counter()
        step, entry, nbytes, already = self._sharded_head(manifest, files)
        # mgwfbp: group-uniform -- 'already' is the agree_all dedup vote from _sharded_head: every process holds the same value
        if already:
            self._promote_sharded(step, manifest, entry)
            return {"duration_s": time.perf_counter() - t0, "bytes": 0}
        slot = _AsyncShardSave(step, manifest, entry, nbytes)
        slot.thread = threading.Thread(
            target=self._shard_payload_worker, args=(slot, files),
            name=f"ckpt-shard-writer-{step}", daemon=True,
        )
        self._async = slot
        slot.thread.start()
        return None

    def _shard_payload_worker(self, slot: _AsyncShardSave,
                              files: dict) -> None:
        try:
            slot.final = self._write_shard_payload(slot.step, files,
                                                   wait=False)
        except Exception as e:  # noqa: BLE001 — crosses the thread
            # boundary through the slot; poll_async raises it on the loop
            slot.error = f"{type(e).__name__}: {e}"
        finally:
            slot.done.set()

    def poll_async(self, block: bool = False,
                   durable: bool = False) -> Optional[dict]:
        """Commit the in-flight save if (at several processes: the whole
        group's) payload write finished; else None. Collective at several
        processes: every process calls it at the same point. ``block``
        waits for the local writer first; ``durable`` fsyncs the payload
        before the commit. Raises, on every process together, if any
        payload write failed. Returns the ``checkpoint`` event's fields
        once the save commits."""
        slot = self._async
        if slot is None:
            return None
        if block:
            slot.done.wait()
        done = slot.done.is_set()
        if coord.process_count() > 1:
            done = coord.agree_all(done)
        if not done:
            return None
        self._async = None
        if slot.thread is not None:
            slot.thread.join()
        ok = slot.error is None
        if coord.process_count() > 1:
            ok = coord.agree_all(ok)
        if not ok:
            raise RuntimeError(
                f"async shard payload write for step {slot.step} failed "
                f"({slot.error or 'on a peer process'}); no process "
                "committed the step — restore falls back to the previous "
                "checkpoint"
            )
        if durable and slot.final is not None:
            _fsync_dir_files(slot.final)
        self._commit_sharded(slot.step, slot.manifest, slot.entry,
                             wait=durable)
        return {
            "step": slot.step,
            "duration_s": time.perf_counter() - slot.t0,
            "bytes": slot.nbytes,
            "async": True,
            "meta": dict(slot.manifest.get("meta") or {}),
        }

    def drain_async(self, durable: bool = False) -> Optional[dict]:
        """Block until any in-flight save has committed (collective at
        several processes, like poll_async)."""
        return self.poll_async(block=True, durable=durable)

    def abandon_async(self) -> Optional[int]:
        """Drop the in-flight save uncommitted (the rollback path: it
        snapshots the suspect regime, and its step may be re-reached after
        the replay). Local only: every process takes the same decision
        because the rollback is agreed. Returns the abandoned step."""
        slot = self._async
        if slot is None:
            return None
        self._async = None
        if slot.thread is not None:
            slot.thread.join()
        return slot.step

    def pending_async_step(self) -> Optional[int]:
        slot = self._async
        return None if slot is None else slot.step

    # -- retention --------------------------------------------------------
    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` epoch-BOUNDARY checkpoints and,
        separately, the newest ``max_to_keep`` mid-epoch ones, so frequent
        step saves never evict the per-epoch history. Orbax steps are not
        this package's to delete."""
        if not self._max_to_keep or self._max_to_keep <= 0:
            return
        bounds: list[int] = []
        mids: list[int] = []
        for step in self._sharded_steps():
            e = self._index.get(str(step))
            if e is not None and e.get("mid_epoch", False):
                mids.append(step)
            else:
                bounds.append(step)
        keep = set(bounds[-self._max_to_keep:]) | set(mids[-self._max_to_keep:])
        if not coord.is_primary():
            return  # one deleter on the shared checkpoint file system
        for step in bounds + mids:
            if step not in keep:
                shutil.rmtree(self._shard_step_dir(step), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, template: TrainState, epoch: Optional[int] = None,
                step: Optional[int] = None,
                carry_template: Optional[list] = None) -> Optional[Snapshot]:
        """Restore into the structure of ``template`` (its leaves' shapes and
        dtypes; ``shape_only`` leaves will do). ``epoch`` picks that epoch's
        boundary snapshot, ``step`` an exact iteration, neither the latest
        snapshot of any kind. A mismatch raises CheckpointRestoreError
        naming the offending leaves. Returns None when there is nothing to
        restore."""
        if step is None:
            step = (self._epoch_boundaries().get(int(epoch))
                    if epoch is not None else self.latest_step())
        if step is None or step not in self.all_steps():
            return None
        if self.entry_format(step) != "sharded":
            raise CheckpointRestoreError(
                f"checkpoint step {step} in {self._dir!r}: {ORBAX_REFUSAL}"
            )
        return self._restore_sharded(int(step), template, carry_template)

    def _diff_leaf_docs(self, docs: list, template: Mapping[str, Any],
                        what: str) -> list[str]:
        """(path: saved vs expected) diffs between manifest leaf docs and a
        template's leaves (keyed by the manifest's path spelling)."""
        saved = {d["path"]: d for d in docs}
        out = []
        for path in sorted(set(saved) | set(template)):
            s, w = saved.get(path), template.get(path)
            if s is None:
                out.append(f"{what}{path}: missing in checkpoint (expected "
                           f"{_leaf_desc(w)})")
            elif w is None:
                out.append(f"{what}{path}: present in checkpoint "
                           f"({s['dtype']}{tuple(s['shape'])}) but not in "
                           "the current structure")
            elif not _doc_matches(s, w):
                out.append(f"{what}{path}: checkpoint has "
                           f"{s['dtype']}{tuple(s['shape'])}, current "
                           f"structure wants {_leaf_desc(w)}")
        return out

    def _drift_message(self, step: int, mismatches: list[str]) -> str:
        detail = ("; offending leaves:\n  " + "\n  ".join(mismatches[:20])
                  if mismatches else "")
        return (
            f"cannot restore checkpoint step {step} from {self._dir!r} into "
            "the current model/optimizer structure — likely config drift "
            "(the checkpoint was saved under a different --dnn / optimizer "
            f"/ precision configuration){detail}"
        )

    def _check(self, step: int, mismatches: list[str]) -> None:
        if mismatches:
            raise CheckpointRestoreError(self._drift_message(step, mismatches),
                                         mismatches=mismatches)

    def _restore_sharded(self, step: int, template: TrainState,
                         carry_template: Optional[list]) -> Snapshot:
        """The replicated form of a shard-native step, read leaf by leaf
        and checked against ``template`` (params, replicated or sharded,
        batch statistics, the optimizer section where the template has
        one, the carry)."""
        src = self.open_sharded(step)
        meta = src.meta

        def keyed(tree: Mapping[str, Any]) -> dict:
            return {keystr(p): a for p, a in tree.items()}

        self._check(step, self._diff_leaf_docs(
            src.leaves, keyed(template.params), "params"))
        bs_docs = src.section_docs("batch_stats")
        self._check(step, self._diff_leaf_docs(
            bs_docs, keyed(template.batch_stats), "batch_stats"))
        params = {flax_path(d["path"]): np.asarray(src.read_leaf("params", j))
                  for j, d in enumerate(src.leaves)}
        batch_stats = {
            flax_path(d["path"]): np.asarray(src.read_leaf("batch_stats", j))
            for j, d in enumerate(bs_docs)
        }
        opt_state = None
        if template.opt_state is not None and src.section_kind("opt") == \
                "replicated":
            o_docs = src.section_docs("opt")
            self._check(step, self._diff_leaf_docs(
                o_docs, template.opt_state, "opt_state"))
            opt_state = {d["path"]: np.asarray(src.read_leaf("opt", j))
                         for j, d in enumerate(o_docs)}
        elif template.opt_state is not None and src.section_kind("opt") == \
                "sharded":
            opt_state = self._read_sharded_opt(step, src, template.opt_state)
        rng = src.manifest.get("rng")
        state = TrainState(
            step=int(meta.get("train_step", meta.get("iteration", step))),
            params=params, batch_stats=batch_stats, opt_state=opt_state,
            rng=list(rng) if rng is not None else None,
        )
        carry = None
        if src.carry_doc():
            if carry_template is None:
                raise CheckpointRestoreError(
                    f"checkpoint step {step} in {self._dir!r} carries a "
                    "model carry (BPTT hidden state) but no carry template "
                    "was supplied — restore through a trainer built for "
                    "the same stateful model"
                )
            cdoc = src.carry_doc()
            want = [np.shape(a)[1:] for a in carry_template]
            have = [tuple(int(x) for x in d["shape"][1:])
                    for d in cdoc["leaves"]]
            if len(want) != len(have) or any(
                    tuple(w) != h for w, h in zip(want, have)):
                self._check(step, [f"carry: checkpoint has leaves {have} "
                                   f"(past the batch rows), the model's "
                                   f"carry wants {[tuple(w) for w in want]}"])
            carry = [
                src.read_carry_range(li, 0, int(d["shape"][0])).reshape(
                    [int(x) for x in d["shape"]])
                for li, d in enumerate(cdoc["leaves"])
            ]
        entry = self._index.get(str(step)) or self._heal_sharded_entry(step)
        return Snapshot(
            state=state,
            epoch=int(entry.get("epoch", meta.get("epoch", 0))),
            iteration=int(meta.get("iteration", step)),
            epoch_step=int(meta.get("epoch_step", 0)),
            mid_epoch=bool(entry.get("mid_epoch",
                                     meta.get("mid_epoch", False))),
            carry=carry,
            manifest_meta=meta,
            torch_rng=_read_torch_rng(src),
        )

    def _read_sharded_opt(self, step: int, src: "ShardSource",
                          template: Mapping[str, Any]) -> dict:
        """The replicated optimizer tree of a sharded ``opt`` section, keyed
        like ``template`` (the optax leaves in flatten order): its integer
        scalars take the manifest's ``opt_count``, and its other leaves, in
        order, are slot 0's parameter leaves, then slot 1's, each re-sliced
        out of the saved shard rows."""
        counts = [k for k, a in template.items()
                  if np.ndim(a) == 0 and np.issubdtype(
                      np.asarray(a).dtype, np.integer)]
        slot_keys = [k for k in template if k not in counts]
        n_leaves = len(src.leaves)
        want = len(slot_keys) // max(n_leaves, 1)
        if src.opt_slots() != want or len(slot_keys) != want * n_leaves:
            raise CheckpointRestoreError(
                f"cannot restore checkpoint step {step} from {self._dir!r}: "
                f"it carries {src.opt_slots()} sharded optimizer slot(s) "
                f"but the current optimizer uses {want} — optimizer config "
                "drift (momentum/adam changed between the saving and "
                "restoring run)")
        out: dict = {}
        for s in range(want):
            for j in range(n_leaves):
                key = slot_keys[s * n_leaves + j]
                leaf = np.asarray(src.read_leaf("opt", j, slot=s))
                if not _doc_matches(_leaf_doc(key, leaf), template[key]):
                    self._check(step, [
                        f"opt_state{key}: checkpoint slot {s} leaf {j} has "
                        f"{leaf.dtype}{leaf.shape}, current structure "
                        f"wants {_leaf_desc(template[key])}"])
                out[key] = leaf
        count = int(src.meta.get("opt_count", src.meta.get("train_step", 0)))
        for k in counts:
            out[k] = np.asarray(count, np.asarray(template[k]).dtype)
        return out

    def close(self) -> None:
        slot = self._async
        if slot is None:
            return
        if coord.process_count() == 1:
            # one process: finishing the save is local work and a commit
            try:
                self.drain_async()
            except RuntimeError:
                pass  # a failed payload write must not block close
            return
        # several processes: close is the disorderly path (orderly exits
        # drain at a boundary save first) and peers may be gone, so the
        # collective commit could hang; the manifest never appears, so
        # restore falls back to the last committed step
        self._async = None
        warnings.warn(
            f"close() with async shard save of step {slot.step} still in "
            "flight on a multi-process run: abandoning the uncommitted save "
            "(restore uses the previous committed step)",
            RuntimeWarning, stacklevel=2,
        )


TORCH_RNG_KEY = "torch_rng"


def _read_torch_rng(src: ShardSource) -> Optional[dict]:
    """This process's generator states from a step this package wrote (the
    manifest's ``torch_rng`` names the files), else None."""
    doc = src.manifest.get(TORCH_RNG_KEY)
    pid = coord.process_index()
    if not doc or int(doc.get("world", -1)) != coord.process_count():
        return None
    out = {}
    for kind in doc.get("kinds", ()):
        path = src._file(pid, f"{TORCH_RNG_KEY}.{kind}")
        if os.path.exists(path):
            out[kind] = np.load(path)
    return out or None

"""Shard-native checkpoints: the read side, and a single-process writer.

Counterpart of the shard-native part of ``mgwfbp_tpu/checkpoint.py``. The
format is plain numpy: per step, ``<dir>/sharded/<step:08d>/`` holds one
``p<i>/`` subtree of ``.npy`` files per process plus one ``manifest.json``
that records the world size, the per-leaf layout and, for sharded
sections, which merge group and offset each parameter leaf packs into. The
manifest is renamed into place last, so its presence is the commit marker.

``ShardSource`` is a copy of the JAX package's reader (this package does not
import that one): it reads replicated and sharded (``rs_fwd_ag`` /
``rs_opt_ag``) sections alike, one leaf or one element range at a time off
numpy memmaps; ``read_step`` reads a step's params and batch statistics.
``save_replicated_step`` writes what the JAX trainer writes for a
single-process ``all_reduce`` run: replicated ``params`` and
``batch_stats`` sections, ``p00000/<section>.l<j>.npy`` in the order jax
flattens each tree, and the manifest last.

numpy has no bfloat16 without the ``ml_dtypes`` package, which this package
does not need: a bfloat16 leaf is carried as its raw 16-bit patterns
(``uint16``) and ``leaf_to_tensor`` turns it into a torch bfloat16 tensor.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from mgwfbp_tpu_torch.convert import flatten_flax, flax_path, keystr

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
    ``convert.variables_to_flax(module)``) in the shard-native format, as
    a single-process ``all_reduce`` run of the JAX trainer writes it: no
    optimizer section, so a JAX restore keeps its own optimizer state.
    Returns the step directory."""
    step_dir = os.path.join(directory, SHARD_SUBDIR, f"{int(step):08d}")
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f".tmp.p00000.{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    sections: dict[str, list[dict]] = {}
    for section, tree in (("params", params), ("batch_stats", batch_stats)):
        docs = sections[section] = []
        for j, (path, leaf) in enumerate(flatten_flax(tree or {}).items()):
            arr = np.ascontiguousarray(leaf)
            docs.append({
                "path": keystr(path),
                "shape": [int(s) for s in arr.shape],
                "dtype": arr.dtype.name,
            })
            np.save(os.path.join(tmp, f"{section}.l{j}.npy"), arr)
    final = os.path.join(step_dir, "p00000")
    if os.path.isdir(final):  # a torn previous attempt never committed
        shutil.rmtree(final)
    os.replace(tmp, final)
    manifest = {
        "format_version": SHARD_FORMAT_VERSION,
        "step": int(step),
        "world": 1,
        "process_count": 1,
        "mesh_axes": {"data": 1, "seq": 1},
        "comm_op": "all_reduce",
        "leaves": sections["params"],
        "rng": [],
        "meta": dict(meta or {"iteration": int(step)}),
        "params": {"kind": "replicated"},
        "batch_stats": {"kind": "replicated", "leaves": sections["batch_stats"]},
    }
    mpath = os.path.join(step_dir, MANIFEST_FILE)
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, mpath)  # the commit
    return step_dir


def read_step(directory: str, step: int) -> tuple[dict, dict, dict]:
    """(params, batch_stats, meta) of a committed step, whichever package
    wrote it: flat dicts of dotted Flax path -> numpy array (the storage
    type of the manifest dtype) and the manifest's ``meta``."""
    step_dir = os.path.join(directory, SHARD_SUBDIR, f"{int(step):08d}")
    try:
        with open(os.path.join(step_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointRestoreError(
            f"step {step} in {directory!r} has no readable manifest ({e})"
        ) from e
    src = ShardSource(step_dir, manifest)
    src.validate()

    def section(name: str) -> dict:
        if src.section_kind(name) == "none":
            return {}
        return {
            flax_path(doc["path"]): np.asarray(src.read_leaf(name, j))
            for j, doc in enumerate(src.section_docs(name))
        }

    return section("params"), section("batch_stats"), src.meta

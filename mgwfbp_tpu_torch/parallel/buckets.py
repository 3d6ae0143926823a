"""Flat-bucket layout for merge groups (counterpart of
``mgwfbp_tpu/parallel/buckets.py``).

``build_layout`` maps leaves (arrival order) to (group, offset) slots and
splits any group that crosses a dtype boundary, so every bucket is one
dtype (a mixed bucket would silently upcast). ``pack_group`` concatenates a
group's gradients into its flat (optionally padded) bucket, ``pack_shard``
one rank's slice of it, ``unpack_group`` slices a reduced bucket back into
per-leaf views.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """groups: tuples of leaf indices (one collective each); offsets: each
    member's element offset in its bucket; group_sizes: elements per
    bucket; dtypes: one dtype per bucket."""

    groups: tuple[tuple[int, ...], ...]
    offsets: tuple[tuple[int, ...], ...]
    group_sizes: tuple[int, ...]
    dtypes: tuple[Any, ...]

    @property
    def num_groups(self) -> int:
        return len(self.groups)


def build_layout(
    leaves: Sequence[Any], groups: Sequence[Sequence[int]]
) -> BucketLayout:
    """Offsets of each group over ``leaves`` (anything with ``shape`` and
    ``dtype``, arrival order), groups split at dtype boundaries."""
    out_groups: list[tuple[int, ...]] = []
    out_offsets: list[tuple[int, ...]] = []
    out_sizes: list[int] = []
    out_dtypes: list[Any] = []
    covered: set[int] = set()

    def emit(sub: list[int]) -> None:
        offs, acc = [], 0
        for idx in sub:
            offs.append(acc)
            acc += _numel(leaves[idx].shape)
        out_groups.append(tuple(sub))
        out_offsets.append(tuple(offs))
        out_sizes.append(acc)
        out_dtypes.append(leaves[sub[0]].dtype)

    for g in groups:
        sub: list[int] = []
        for idx in g:
            if idx in covered:
                raise ValueError(f"leaf {idx} appears in multiple groups")
            covered.add(idx)
            if sub and leaves[idx].dtype != leaves[sub[-1]].dtype:
                emit(sub)
                sub = []
            sub.append(idx)
        if sub:
            emit(sub)
    if len(covered) != len(leaves):
        missing = sorted(set(range(len(leaves))) - covered)
        raise ValueError(f"groups do not cover leaves {missing}")
    return BucketLayout(
        groups=tuple(out_groups),
        offsets=tuple(out_offsets),
        group_sizes=tuple(out_sizes),
        dtypes=tuple(out_dtypes),
    )


def pack_group(
    leaves: Sequence[torch.Tensor], layout: BucketLayout, gi: int,
    size: int | None = None,
) -> torch.Tensor:
    """A group's leaves concatenated into one new flat bucket of ``size``
    elements (the group's own by default; the tail past it zero), written
    in place: a padded bucket costs no second copy."""
    flat = [leaves[i].reshape(-1) for i in layout.groups[gi]]
    n = layout.group_sizes[gi]
    if size is None or size == n:
        return torch.cat(flat)
    out = flat[0].new_empty(size)
    torch.cat(flat, out=out[:n])
    out[n:].zero_()
    return out


def pack_shard(
    leaves: Sequence[torch.Tensor], layout: BucketLayout, gi: int,
    lo: int, hi: int,
) -> torch.Tensor:
    """Elements [lo, hi) of a group's padded bucket as one new flat
    tensor, copied from only the leaves that overlap them (zero past the
    group's end)."""
    members = layout.groups[gi]
    parts = []
    for i, off in zip(members, layout.offsets[gi]):
        a = max(off, lo)
        b = min(off + leaves[i].numel(), hi)
        if a < b:
            parts.append(leaves[i].reshape(-1)[a - off:b - off])
    n = layout.group_sizes[gi]
    if hi > n:
        parts.append(leaves[members[0]].new_zeros(hi - max(n, lo)))
    return torch.cat(parts)


def unpack_group(
    bucket: torch.Tensor, layout: BucketLayout, gi: int,
    shapes: Sequence[tuple[int, ...]],
) -> dict[int, torch.Tensor]:
    """Per-leaf views of a bucket, keyed by leaf index."""
    out: dict[int, torch.Tensor] = {}
    for i, off in zip(layout.groups[gi], layout.offsets[gi]):
        n = _numel(shapes[i])
        out[i] = bucket[off : off + n].view(shapes[i])
    return out


def padded_group_size(layout: BucketLayout, gi: int, world: int) -> int:
    """Bucket element count after padding to world divisibility."""
    n = layout.group_sizes[gi]
    return n + (-n) % world


def shard_size(layout: BucketLayout, gi: int, world: int) -> int:
    """Per-rank element count of one group's shard."""
    return padded_group_size(layout, gi, world) // world


def group_mask_vector(
    layout: BucketLayout,
    gi: int,
    leaf_flags: Sequence[bool],
    shapes: Sequence[tuple[int, ...]],
    world: int,
) -> np.ndarray:
    """Per-element float32 vector over the PADDED bucket: 1.0 where the
    owning leaf's flag is set, 0.0 elsewhere (padding included)."""
    out = np.zeros((padded_group_size(layout, gi, world),), np.float32)
    for i, off in zip(layout.groups[gi], layout.offsets[gi]):
        if leaf_flags[i]:
            out[off : off + _numel(shapes[i])] = 1.0
    return out


def pack_group_host(
    leaves: Sequence[np.ndarray], layout: BucketLayout, gi: int, world: int
) -> np.ndarray:
    """numpy padded bucket pack (the checkpoint scatter path)."""
    flat = np.concatenate(
        [np.ravel(np.asarray(leaves[i])) for i in layout.groups[gi]]
    )
    pad = (-flat.size) % world
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat


def unpack_group_host(
    flat: np.ndarray,
    layout: BucketLayout,
    gi: int,
    shapes: Sequence[tuple[int, ...]],
) -> dict[int, np.ndarray]:
    """numpy bucket unpack (the checkpoint gather path), keyed by leaf."""
    out: dict[int, np.ndarray] = {}
    for i, off in zip(layout.groups[gi], layout.offsets[gi]):
        out[i] = np.asarray(flat[off : off + _numel(shapes[i])]).reshape(
            shapes[i])
    return out

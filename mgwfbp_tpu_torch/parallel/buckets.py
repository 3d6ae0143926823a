"""Flat-bucket layout for merge groups (counterpart of
``mgwfbp_tpu/parallel/buckets.py``).

``build_layout`` maps leaves (arrival order) to (group, offset) slots and
splits any group that crosses a dtype boundary, so every bucket is one
dtype (a mixed bucket would silently upcast). ``pack_group`` concatenates a
group's gradients into its flat bucket, ``unpack_group`` slices a reduced
bucket back into per-leaf views.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

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
    leaves: Sequence[torch.Tensor], layout: BucketLayout, gi: int
) -> torch.Tensor:
    """A group's leaves concatenated into one new flat bucket."""
    return torch.cat([leaves[i].reshape(-1) for i in layout.groups[gi]])


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

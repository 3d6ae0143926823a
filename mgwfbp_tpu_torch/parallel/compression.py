"""Gradient compression: the registry and the sparse collective (counterpart
of ``mgwfbp_tpu/parallel/compression.py``).

  * ``none``: identity; buckets all-reduce densely.
  * ``topk``: per bucket, each rank keeps its k = density * n entries of
    largest magnitude, all-gathers (values, int32 indices) and scatter-adds
    the P gathered rows into a dense bucket, one ``index_add_`` per source
    rank in rank order. Within one rank's top-k the indices are unique, so
    no ``index_add_`` sums duplicates (on the card that would take atomics,
    whose order differs between replicas); rank order is also the order in
    which XLA's scatter adds them. The all-gather moves 2 * k * P elements
    against n for a ring all-reduce: the trade ``costmodel.choose_density``
    prices, with 4-byte indices on the wire, as the JAX package moves them.

No error feedback (the JAX package has none either). The reducer
(``parallel.allreduce.MergedAllreduce``) launches the two all-gathers from
its gradient hooks (``select``) and scatter-adds after the wait
(``densify``); ``allreduce`` is the same thing in one synchronous call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from mgwfbp_tpu_torch.parallel.allreduce import all_gather_single


class NoneCompressor:
    """Identity. Buckets stay dense."""

    name = "none"
    density = 1.0

    def sparse(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Keep the ``density`` fraction of largest-|g| entries per bucket."""

    density: float = 0.01
    name: str = "topk"

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")

    def sparse(self) -> bool:
        return self.density < 1.0

    def k_for(self, n: int) -> int:
        return max(1, min(n, int(round(n * self.density))))

    @staticmethod
    def select(buf: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(values, int32 indices) of the k entries of largest magnitude.
        Ties between equal magnitudes are broken as ``torch.topk`` breaks
        them, which need not be the lower index first (``lax.top_k``)."""
        idx = torch.topk(buf.abs(), k, sorted=False).indices
        return buf[idx], idx.to(torch.int32)

    @staticmethod
    def densify(g_vals: torch.Tensor, g_idx: torch.Tensor, n: int
                ) -> torch.Tensor:
        """The dense (n,) sum of the gathered (P, k) rows, added one source
        rank at a time in rank order."""
        dense = torch.zeros(n, dtype=g_vals.dtype, device=g_vals.device)
        for r in range(g_vals.shape[0]):
            dense.index_add_(0, g_idx[r].long(), g_vals[r])
        return dense

    def allreduce(self, buf: torch.Tensor, group=None, mean: bool = True
                  ) -> torch.Tensor:
        """The sparse 'all-reduce' of one flat bucket, synchronously: top-k,
        all-gather (values, indices), scatter-add; the mean divides by the
        world. k >= n is the dense all-reduce."""
        world = dist.get_world_size(group)
        n = buf.shape[0]
        k = self.k_for(n)
        if k >= n:
            out = buf.clone()
            dist.all_reduce(out, group=group)
            return out / world if mean else out
        vals, idx = self.select(buf, k)
        g_vals = torch.empty(world * k, dtype=vals.dtype, device=buf.device)
        g_idx = torch.empty(world * k, dtype=torch.int32, device=buf.device)
        all_gather_single(g_vals, vals, group=group)
        all_gather_single(g_idx, idx, group=group)
        dense = self.densify(g_vals.view(world, k), g_idx.view(world, k), n)
        return dense / world if mean else dense


compressors = {
    "none": NoneCompressor,
    None: NoneCompressor,
    "topk": TopKCompressor,
}


def make_compressor(name: Optional[str], density: float = 1.0):
    """Registry factory; None for the dense path. A sparsifying compressor
    with density >= 1.0 is a configuration error (the run would be dense
    while labelled sparse), not a no-op."""
    if name in (None, "none"):
        return None
    cls = compressors.get(name)
    if cls is None:
        raise KeyError(
            f"unknown compressor {name!r}; expected one of "
            f"{sorted(k for k in compressors if isinstance(k, str))}"
        )
    if density >= 1.0:
        raise ValueError(
            f"compressor {name!r} requires density < 1.0 (got {density}); "
            "pass --density, or use --compressor none for the dense path"
        )
    return cls(density=density)

"""Alpha-beta communication cost models (a copy of the flat part of
``mgwfbp_tpu/parallel/costmodel.py``).

The merge solver needs ``t_comm(bytes) = alpha + beta * bytes`` for one
all-reduce over P workers. The tables below are the JAX package's: the
reference clusters' measured constants (56Gb IB, 10GbE, 1GbE) and the
uncalibrated TPU ICI/DCN priors, kept so that both packages solve the same
schedules. None of them describes NCCL on NVLink; calibrating it is an open
item (ROADMAP.md). Profiles (``--comm-profile``) are read and written in
the JAX package's JSON schema; flat and sampled profiles are supported,
two-level and per-world-size families are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Mapping, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class AlphaBeta:
    """Latency/bandwidth parameters of one all-reduce link class.

    alpha: startup latency in seconds per collective.
    beta: per-byte transfer time in seconds.
    gamma: fixed per-collective overhead outside the link (pack/unpack,
        dispatch), on the critical path once per group.
    overlap: fraction of collective time the platform hides behind compute.
    pack_beta: per-byte cost of packing a multi-member group.
    update_beta, ag_fraction: read by the JAX package's sharded and
        cross-step lowerings; carried here so profiles round-trip.
    """

    alpha: float
    beta: float
    gamma: float = 0.0
    overlap: float = 1.0
    pack_beta: float = 0.0
    update_beta: float = 0.0
    ag_fraction: float = 0.5

    def predict(self, nbytes) -> float:
        return self.alpha + self.beta * nbytes


@dataclasses.dataclass(frozen=True)
class SampledCost:
    """Measured all-reduce cost curve: piecewise-linear in log2(bytes)
    across the samples, extrapolated above the largest at the last
    interval's per-byte rate, floored at the smallest. ``ab`` carries the
    least-squares line (alpha for the merge rule)."""

    sizes_bytes: tuple[float, ...]
    times_s: tuple[float, ...]
    ab: AlphaBeta
    gamma: float = 0.0
    overlap: float = 1.0
    pack_beta: float = 0.0
    update_beta: float = 0.0
    ag_fraction: float = 0.5

    def __post_init__(self):
        object.__setattr__(
            self,
            "_xs",
            np.log2(np.maximum(np.asarray(self.sizes_bytes, np.float64), 1.0)),
        )
        object.__setattr__(self, "_ys", np.asarray(self.times_s, np.float64))

    @property
    def alpha(self) -> float:
        return self.ab.alpha

    @property
    def beta(self) -> float:
        return self.ab.beta

    def predict(self, nbytes) -> float:
        xs, ys = self._xs, self._ys
        b = float(max(nbytes, 1.0))
        if b >= self.sizes_bytes[-1]:
            if len(ys) >= 2:
                slope = max(
                    (ys[-1] - ys[-2])
                    / max(self.sizes_bytes[-1] - self.sizes_bytes[-2], 1.0),
                    0.0,
                )
            else:
                slope = ys[-1] / max(self.sizes_bytes[-1], 1.0)
            return float(ys[-1] + (b - self.sizes_bytes[-1]) * slope)
        return float(np.interp(np.log2(b), xs, ys))


_REFERENCE_56GBIB: Mapping[int, AlphaBeta] = {
    16: AlphaBeta(0.00023583677659915685, 4.0594787739537565e-10),
    8: AlphaBeta(9.75367204301171e-05, 3.0568230536676206e-10),
    4: AlphaBeta(4.204298980348825e-05, 2.0589360830118177e-10),
    2: AlphaBeta(2.554691138304671e-06, 9.837548167872609e-11),
}

_REFERENCE_10GBE: Mapping[int, AlphaBeta] = {
    16: AlphaBeta(0.0009080981007148093, 7.395651186836712e-10),
    8: AlphaBeta(0.0005230272768511732, 8.570746975492128e-10),
    4: AlphaBeta(4.204298980348825e-05, 2.0589360830118177e-10),
    2: AlphaBeta(2.554691138304671e-06, 9.837548167872609e-11),
}

# the JAX package's TPU priors (order-of-magnitude guesses, not
# measurements); the port keeps them for parity
_TPU_ICI_DEFAULT = AlphaBeta(alpha=8e-06, beta=2.2e-11)
_TPU_DCN_DEFAULT = AlphaBeta(alpha=2.5e-04, beta=4.0e-10)

_REFERENCE_1GBE_SMALL: Mapping[int, AlphaBeta] = {
    2: AlphaBeta(1.6e-3, 1.0e-8),
    4: AlphaBeta(2.7e-3, 1.3e-8),
    8: AlphaBeta(4.0e-3, 1.5e-8),
    16: AlphaBeta(1.7e-3, 1.7e-8),
}

_REFERENCE_1GBE_LARGE: Mapping[int, AlphaBeta] = {
    2: AlphaBeta(4.4e-3, 5.8e-9),
    4: AlphaBeta(5.6e-3, 7.4e-9),
    8: AlphaBeta(7.68e-3, 8.2e-9),
    16: AlphaBeta(2.1e-3, 1.7e-8),
}

_REFERENCE_10GBE_UTILS: Mapping[int, AlphaBeta] = {
    2: AlphaBeta(1.5e-5, 5.7e-11),
    4: AlphaBeta(3.6e-5, 1.1e-10),
    8: AlphaBeta(8.5e-5, 1.4e-10),
    16: AlphaBeta(1.4e-4, 2.0e-10),
}

_CONNECTIONS: Mapping[str, Mapping[int, AlphaBeta]] = {
    "56GbIB": _REFERENCE_56GBIB,
    "10GbE": _REFERENCE_10GBE,
    "1GbE-small": _REFERENCE_1GBE_SMALL,
    "1GbE-large": _REFERENCE_1GBE_LARGE,
    "10GbE-utils": _REFERENCE_10GBE_UTILS,
}

_PRIOR_WARNED: set = set()


def lookup_alpha_beta(connection: str, nworkers: int) -> AlphaBeta:
    """AlphaBeta for a link class and worker count: the reference tables
    log2-interpolate between their {2, 4, 8, 16} entries; 'ici'/'dcn' are
    the JAX package's uncalibrated TPU priors (a one-time warning marks a
    run that uses one)."""
    if connection in ("ici", "dcn") and connection not in _PRIOR_WARNED:
        _PRIOR_WARNED.add(connection)
        logging.getLogger("mgwfbp.costmodel").warning(
            "using the UNCALIBRATED %s alpha-beta prior (a TPU guess kept "
            "for parity with the JAX package); pass --comm-profile for "
            "measured constants", connection,
        )
    if connection == "ici":
        ab = _TPU_ICI_DEFAULT
        hops = max(nworkers - 1, 1)
        return AlphaBeta(alpha=ab.alpha * (1.0 + 0.1 * hops), beta=ab.beta)
    if connection == "dcn":
        return _TPU_DCN_DEFAULT
    table = _CONNECTIONS.get(connection)
    if table is None:
        raise KeyError(
            f"unknown connection {connection!r}; expected one of "
            f"{sorted(_CONNECTIONS)} or 'ici'/'dcn'"
        )
    return interp_alpha_beta(table, nworkers)


def interp_alpha_beta(
    table: Mapping[int, AlphaBeta], nworkers: int
) -> AlphaBeta:
    """AlphaBeta at a worker count from a measured table: exact entries as
    they are, intermediate counts log2-interpolated, larger counts with
    alpha extrapolated by the log2 ratio."""
    if not table:
        raise ValueError("empty alpha-beta table")
    if nworkers in table:
        return table[nworkers]
    known = sorted(table)
    if nworkers < known[0]:
        return table[known[0]]
    if nworkers > known[-1]:
        base = table[known[-1]]
        scale = np.log2(nworkers) / np.log2(max(known[-1], 2))
        return AlphaBeta(
            alpha=base.alpha * scale, beta=base.beta, gamma=base.gamma,
            overlap=base.overlap, pack_beta=base.pack_beta,
            update_beta=base.update_beta, ag_fraction=base.ag_fraction,
        )
    lo = max(k for k in known if k < nworkers)
    hi = min(k for k in known if k > nworkers)
    t = (np.log2(nworkers) - np.log2(lo)) / (np.log2(hi) - np.log2(lo))

    def mix(field: str) -> float:
        return float(
            getattr(table[lo], field) * (1 - t) + getattr(table[hi], field) * t
        )

    return AlphaBeta(**{
        f.name: mix(f.name) for f in dataclasses.fields(AlphaBeta)
    })


# profile JSON schema of the JAX package (version 1 = unstamped legacy)
PROFILE_SCHEMA_VERSION = 3
_SUPPORTED_PROFILE_SCHEMAS = (1, 2, 3)


def check_schema_version(d: dict, path: str = "<profile>") -> int:
    v = d.get("schema_version", 1)
    if isinstance(v, bool) or not isinstance(v, int) or v not in (
        _SUPPORTED_PROFILE_SCHEMAS
    ):
        raise ValueError(
            f"{path}: unsupported profile schema_version {v!r}; this build "
            f"reads versions {_SUPPORTED_PROFILE_SCHEMAS}"
        )
    return v


def _model_dict(model: "AlphaBeta | SampledCost") -> dict:
    if isinstance(model, SampledCost):
        return {
            "kind": "sampled",
            "sizes_bytes": list(model.sizes_bytes),
            "times_s": list(model.times_s),
            "ab": dataclasses.asdict(model.ab),
            "gamma": model.gamma,
            "overlap": model.overlap,
            "pack_beta": model.pack_beta,
            "update_beta": model.update_beta,
            "ag_fraction": model.ag_fraction,
        }
    return {"kind": "flat", **dataclasses.asdict(model)}


def save_profile(
    path: str, model: "AlphaBeta | SampledCost", meta: Optional[dict] = None
) -> None:
    """Persist a flat or sampled model, stamped with the schema version."""
    doc = _model_dict(model)
    doc["schema_version"] = PROFILE_SCHEMA_VERSION
    if meta:
        doc["meta"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)


def load_profile(path: str) -> "AlphaBeta | SampledCost":
    """Load a flat or sampled profile written by either package."""
    with open(path) as f:
        d = json.load(f)
    check_schema_version(d, path=path)
    d.pop("schema_version", None)
    d.pop("meta", None)
    kind = d.pop("kind", "flat")
    if kind == "sampled":
        return SampledCost(
            sizes_bytes=tuple(d["sizes_bytes"]),
            times_s=tuple(d["times_s"]),
            ab=AlphaBeta(**d["ab"]),
            gamma=d.get("gamma", 0.0),
            overlap=d.get("overlap", 1.0),
            pack_beta=d.get("pack_beta", 0.0),
            update_beta=d.get("update_beta", 0.0),
            ag_fraction=d.get("ag_fraction", 0.5),
        )
    if kind != "flat":
        raise ValueError(
            f"{path}: {kind!r} profiles are not ported (flat and sampled "
            "only; see ROADMAP.md)"
        )
    return AlphaBeta(**d)


__all__ = [
    "AlphaBeta",
    "SampledCost",
    "interp_alpha_beta",
    "load_profile",
    "lookup_alpha_beta",
    "save_profile",
]

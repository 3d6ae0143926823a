"""Alpha-beta communication cost models (a copy of the flat part of
``mgwfbp_tpu/parallel/costmodel.py``).

The merge solver needs ``t_comm(bytes) = alpha + beta * bytes`` for one
all-reduce over P workers. The tables below are the JAX package's: the
reference clusters' measured constants (56Gb IB, 10GbE, 1GbE) and the
uncalibrated TPU ICI/DCN priors, kept so that both packages solve the same
schedules. None of them describes a GPU: ``python -m
mgwfbp_tpu_torch.calibrate`` measures the card's constants and writes a
profile that ``--comm-profile`` loads. Profiles are read and written in
the JAX package's JSON schema, so either package loads the other's:
flat, sampled, per-world-size ``family`` and ``two_level`` profiles.
``TwoLevelAlphaBeta`` prices the ``hier`` lowering's two links (inside a
slice and across slices; ``calibrate --two-level`` measures both).
``refit_from_observations`` and ``refit_two_level_from_observations``
refit a model from live measurements (the autotuner's correction,
``parallel.autotune``).
``update_beta`` prices the ``rs_opt_ag`` lowering's shard update
(``solver.effective_cost_fn``; ``profiling.profile_update_beta`` measures
it). The sparsification models
at the end (``topk_time``, ``sparse_allgather_time``, ``choose_density``)
price the top-k compressor against the dense all-reduce.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Mapping, Optional, Sequence

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
    update_beta: per-bucket-byte cost of the rs_opt_ag shard update, which
        sits between the reduce-scatter and the all-gather.
    ag_fraction: read by the JAX package's cross-step lowering; carried
        here so profiles round-trip.
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


def check_schema_version(
    d: dict,
    path: str = "<profile>",
    supported: Sequence[int] = _SUPPORTED_PROFILE_SCHEMAS,
    what: str = "profile",
) -> int:
    """Validate a document's schema_version (absent = 1, the legacy
    unstamped layout); a version this build does not read raises."""
    v = d.get("schema_version", 1)
    if isinstance(v, bool) or not isinstance(v, int) or v not in tuple(
        supported
    ):
        raise ValueError(
            f"{path}: unsupported {what} schema_version {v!r}; this build "
            f"reads versions {tuple(supported)}"
        )
    return v


def fit_alpha_beta(
    sizes_bytes: Sequence[float], times_s: Sequence[float]
) -> AlphaBeta:
    """Closed-form least-squares fit of t = alpha + beta * size, with
    alpha >= 0 and beta >= 0 (a negative startup latency would break the
    merge rule ``t_wait < alpha``)."""
    x = np.asarray(sizes_bytes, dtype=np.float64)
    y = np.asarray(times_s, dtype=np.float64)
    if x.size < 2:
        raise ValueError("need at least two (size, time) samples to fit alpha-beta")
    xm, ym = x.mean(), y.mean()
    denom = ((x - xm) ** 2).sum()
    if denom == 0.0:
        raise ValueError("all sizes identical; cannot fit beta")
    beta = float(((x - xm) * (y - ym)).sum() / denom)
    if beta < 0.0:
        # time falling with size is noise: the constant model at the mean
        return AlphaBeta(alpha=max(float(ym), 0.0), beta=0.0)
    alpha = float(ym - beta * xm)
    if alpha < 0.0:
        # refit through the origin under alpha >= 0
        beta = max(float((x * y).sum() / (x * x).sum()), 0.0)
        alpha = 0.0
    return AlphaBeta(alpha=alpha, beta=beta)


@dataclasses.dataclass(frozen=True)
class ProfileFamily:
    """Calibrations of one link class at several world sizes (``calibrate
    --world-sizes`` or ``--prior-extend``). ``at(P)`` returns an exact
    extent's entry as it is (a sampled curve stays a curve) and resolves
    any other extent by ``interp_alpha_beta`` over the entries'
    two-parameter summaries."""

    entries: Mapping[int, "AlphaBeta | SampledCost"]

    def at(self, nworkers: int) -> "AlphaBeta | SampledCost":
        if nworkers in self.entries:
            return self.entries[nworkers]
        summaries = {
            k: (
                dataclasses.replace(
                    v.ab, gamma=v.gamma, overlap=v.overlap,
                    pack_beta=v.pack_beta, update_beta=v.update_beta,
                    ag_fraction=v.ag_fraction,
                )
                if isinstance(v, SampledCost)
                else v
            )
            for k, v in self.entries.items()
        }
        return interp_alpha_beta(summaries, nworkers)


def resolve_profile(
    model: "AlphaBeta | SampledCost | ProfileFamily", nworkers: int
) -> "AlphaBeta | SampledCost":
    """Pin a loaded profile to a world size (a family needs the extent;
    flat and sampled models are already concrete)."""
    if isinstance(model, ProfileFamily):
        return model.at(nworkers)
    return model


@dataclasses.dataclass(frozen=True)
class TwoLevelAlphaBeta:
    """Two-level cost model: the link inside a slice (``ici``) and the link
    across slices (``dcn``). A hierarchical all-reduce is reduce-scatter
    inside the slice, all-reduce of the shard across slices, all-gather
    inside the slice; its cost is the inner link's on the full payload plus
    the outer link's on the 1/ici_size shard."""

    ici: "AlphaBeta | SampledCost"
    dcn: "AlphaBeta | SampledCost"
    ici_size: int  # ranks per slice
    dcn_size: int  # number of slices

    def predict(self, nbytes) -> float:
        if self.dcn_size <= 1:
            return self.ici.predict(nbytes)
        return self.ici.predict(nbytes) + self.dcn_shard_predict(nbytes)

    def ici_predict(self, nbytes) -> float:
        """Full inner-link cost of one bucket (reduce-scatter and
        all-gather together)."""
        return float(self.ici.predict(nbytes))

    def dcn_shard_predict(self, nbytes) -> float:
        """Outer-link cost of one bucket: the cross-slice all-reduce moves
        the 1/ici_size shard; ``nbytes`` is the full bucket payload."""
        if self.dcn_size <= 1:
            return 0.0
        return float(self.dcn.predict(nbytes / max(self.ici_size, 1)))

    @property
    def alpha(self) -> float:
        # one merged collective pays one launch on each level
        if self.dcn_size <= 1:
            return self.ici.alpha
        return self.ici.alpha + self.dcn.alpha

    @property
    def gamma(self) -> float:
        if self.dcn_size <= 1:
            return self.ici.gamma
        return self.ici.gamma + self.dcn.gamma

    @property
    def overlap(self) -> float:
        # hidden only as well as the worse level
        if self.dcn_size <= 1:
            return self.ici.overlap
        return min(self.ici.overlap, self.dcn.overlap)

    @property
    def pack_beta(self) -> float:
        return self.ici.pack_beta  # each bucket is packed once, inside

    @property
    def update_beta(self) -> float:
        return self.ici.update_beta  # the shard update runs on the inner shard

    @property
    def ag_fraction(self) -> float:
        return self.ici.ag_fraction  # the deferred gather is the inner one


def refit_from_observations(
    model,
    observations: Sequence[tuple[float, float]],
    comm_op: str = "all_reduce",
) -> AlphaBeta:
    """Refit alpha/beta (and update_beta on the rs_opt_ag lowering) from
    measured per-collective (bucket bytes, seconds) observations: the
    autotuner's cost-model correction (the JAX package's function).

    The observations are what the live job measured for its merge-group
    collectives (trace group times, or the step-delta pseudo observations
    of ``autotune.step_delta_observations``), so the fitted line is the
    effective per-collective cost. ``model``'s gamma is charged separately
    by the solver's simulation, so it is taken off the fitted intercept
    (floored at 0); on rs_opt_ag the fitted per-byte rate covers beta and
    update_beta together (the shard update rides the same serial
    timeline), so it is split between them in the old model's proportions.
    gamma, overlap, pack_beta and ag_fraction carry over: dedicated
    measurements fit them, not these residuals."""
    obs = [(float(b), float(t)) for b, t in observations]
    if len(obs) < 2:
        raise ValueError("need at least two (bytes, seconds) observations")
    ab = fit_alpha_beta([b for b, _ in obs], [t for _, t in obs])
    gamma = float(getattr(model, "gamma", 0.0))
    alpha = max(ab.alpha - gamma, 0.0)
    rate = ab.beta
    beta = rate
    update_beta = float(getattr(model, "update_beta", 0.0))
    if comm_op == "rs_opt_ag" and update_beta > 0.0:
        old_beta = float(getattr(model, "beta", 0.0))
        share = update_beta / max(old_beta + update_beta, 1e-30)
        update_beta = rate * share
        beta = rate - update_beta
    return AlphaBeta(
        alpha=alpha,
        beta=beta,
        gamma=gamma,
        overlap=float(getattr(model, "overlap", 1.0)),
        pack_beta=float(getattr(model, "pack_beta", 0.0)),
        update_beta=update_beta,
        ag_fraction=float(getattr(model, "ag_fraction", 0.5)),
    )


def refit_two_level_from_observations(
    model: TwoLevelAlphaBeta,
    observations: Sequence[tuple[float, float]],
    ici_observations: Optional[Sequence[tuple[float, float]]] = None,
    dcn_observations: Optional[Sequence[tuple[float, float]]] = None,
) -> TwoLevelAlphaBeta:
    """Refit a two-level model from live measurements, per link when the
    attribution separates them (the JAX package's function).

    ``ici_observations`` / ``dcn_observations`` are per-leg (bytes,
    seconds) samples: the ``mgwfbp_groupNNNN`` ranges time a bucket's inner
    legs (full bucket bytes), the ``mgwfbp_dcngroupNNNN`` ranges its
    cross-slice collective (shard bytes). A link with at least two samples
    refits its own alpha-beta (gamma taken off the intercept); a link
    without keeps its constants. Without per-link samples,
    ``observations`` (whole-collective) rescale both links by one common
    factor, the median of measured over predicted time, which keeps the
    links' measured proportions."""

    def _refit_link(link, obs) -> AlphaBeta:
        ab = fit_alpha_beta([b for b, _ in obs], [t for _, t in obs])
        gamma = float(getattr(link, "gamma", 0.0))
        return AlphaBeta(
            alpha=max(ab.alpha - gamma, 0.0),
            beta=ab.beta,
            gamma=gamma,
            overlap=float(getattr(link, "overlap", 1.0)),
            pack_beta=float(getattr(link, "pack_beta", 0.0)),
            update_beta=float(getattr(link, "update_beta", 0.0)),
            ag_fraction=float(getattr(link, "ag_fraction", 0.5)),
        )

    ici, dcn = model.ici, model.dcn
    per_link = False
    if ici_observations is not None and len(ici_observations) >= 2:
        ici = _refit_link(ici, ici_observations)
        per_link = True
    if dcn_observations is not None and len(dcn_observations) >= 2:
        dcn = _refit_link(dcn, dcn_observations)
        per_link = True
    if not per_link:
        obs = [(float(b), float(t)) for b, t in observations or []]
        if len(obs) < 2:
            raise ValueError(
                "need at least two (bytes, seconds) observations "
                "(per-link or whole-collective)"
            )
        gamma = float(model.gamma)
        ratios = [
            (t - gamma) / model.predict(b)
            for b, t in obs
            if model.predict(b) > 0.0 and t > gamma
        ]
        if not ratios:
            raise ValueError("observations do not constrain the model")
        k = float(np.median(ratios))

        def _scale(link):
            if isinstance(link, SampledCost):
                # a measured curve stays a curve
                return SampledCost(
                    sizes_bytes=link.sizes_bytes,
                    times_s=tuple(float(t) * k for t in link.times_s),
                    ab=AlphaBeta(link.ab.alpha * k, link.ab.beta * k),
                    gamma=link.gamma,
                    overlap=link.overlap,
                    pack_beta=link.pack_beta,
                    update_beta=link.update_beta,
                    ag_fraction=link.ag_fraction,
                )
            return AlphaBeta(
                alpha=float(getattr(link, "alpha", 0.0)) * k,
                beta=float(getattr(link, "beta", 0.0)) * k,
                gamma=float(getattr(link, "gamma", 0.0)),
                overlap=float(getattr(link, "overlap", 1.0)),
                pack_beta=float(getattr(link, "pack_beta", 0.0)),
                update_beta=float(getattr(link, "update_beta", 0.0)),
                ag_fraction=float(getattr(link, "ag_fraction", 0.5)),
            )

        ici, dcn = _scale(ici), _scale(dcn)
    return TwoLevelAlphaBeta(
        ici=ici, dcn=dcn, ici_size=model.ici_size, dcn_size=model.dcn_size,
    )


def committed_profile_or_prior(path, connection: str, nworkers: int):
    """(cost model, source): the profile at ``path`` resolved at
    ``nworkers`` when the file exists (source = the path), else the
    ``lookup_alpha_beta`` prior (source = None)."""
    if path and os.path.exists(path):
        return resolve_profile(load_profile(path), nworkers), path
    return lookup_alpha_beta(connection, nworkers), None


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
    return dataclasses.asdict(model)


def _model_from_dict(d: dict) -> "AlphaBeta | SampledCost":
    if d.get("kind") == "sampled":
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
    return AlphaBeta(**{k: v for k, v in d.items() if k != "kind"})


def save_profile(
    path: str,
    model: "AlphaBeta | SampledCost | TwoLevelAlphaBeta | ProfileFamily",
    meta: Optional[dict] = None,
) -> None:
    """Persist a flat, sampled, two-level or family model, stamped with
    the schema version; ``meta`` (device, backend, what was measured) is
    carried for provenance and ignored on load."""
    if isinstance(model, ProfileFamily):
        doc = {
            "kind": "family",
            "entries": {
                str(k): _model_dict(v) for k, v in sorted(model.entries.items())
            },
        }
    elif isinstance(model, SampledCost):
        doc = _model_dict(model)
    elif isinstance(model, TwoLevelAlphaBeta):
        # each link may be a measured curve (calibrate --two-level)
        doc = {
            "kind": "two_level",
            "ici": _model_dict(model.ici),
            "dcn": _model_dict(model.dcn),
            "ici_size": model.ici_size,
            "dcn_size": model.dcn_size,
        }
    else:
        doc = {"kind": "flat", **dataclasses.asdict(model)}
    doc["schema_version"] = PROFILE_SCHEMA_VERSION
    if meta:
        doc["meta"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)


def load_profile(
    path: str,
) -> "AlphaBeta | SampledCost | TwoLevelAlphaBeta | ProfileFamily":
    """Load a flat, sampled, two-level or family profile written by either
    package (resolve a family with ``resolve_profile(model, nworkers)``)."""
    with open(path) as f:
        d = json.load(f)
    check_schema_version(d, path=path)
    d.pop("schema_version", None)
    d.pop("meta", None)
    kind = d.get("kind", "flat")
    if kind == "two_level":
        return TwoLevelAlphaBeta(
            ici=_model_from_dict(d["ici"]),
            dcn=_model_from_dict(d["dcn"]),
            ici_size=d["ici_size"],
            dcn_size=d["dcn_size"],
        )
    if kind == "family":
        return ProfileFamily(entries={
            int(k): _model_from_dict(v) for k, v in d["entries"].items()
        })
    return _model_from_dict(d)


# ---------------------------------------------------------------------------
# Sparsification cost models (the JAX package's, from the reference's
# utils.py:95-149): the top-k select and the sparse all-gather, so that a
# policy can choose dense or sparse. TOPK_MACHINE_CONST is the reference's
# P102-100 constant; no card has refitted it.
# ---------------------------------------------------------------------------

TOPK_MACHINE_CONST = 2.18896957e-10


def topk_time(nelems: float, s: float = TOPK_MACHINE_CONST) -> float:
    """t = s * n * log2(n): the top-k selection cost."""
    n = max(float(nelems), 2.0)
    return s * n * float(np.log2(n))


def sparse_allgather_time(
    alpha: float, beta: float, nelems: float, nworkers: int,
    density: float, itemsize: int = 4,
) -> float:
    """t = 2 * (alpha + beta * n * P * itemsize * density): all-gathering
    (values, indices) of a density-sparsified n-element tensor over P
    workers (the factor 2 covers the two payloads)."""
    return 2.0 * (
        alpha + beta * float(nelems) * nworkers * itemsize * density
    )


def sparse_allgather_time_ethernet(
    nelems: float, nworkers: int, density: float, itemsize: int = 4,
) -> float:
    """The reference's sparse-allgather predictor: the 1GbE SMALL table
    below 1 MB of payload (n * P * itemsize * density), the LARGE table at
    or above it, doubled for the (values, indices) pair."""
    if nelems == 0:
        return 0.0
    size = float(nelems) * nworkers * itemsize * density
    connection = "1GbE-large" if size >= 1024 * 1024 else "1GbE-small"
    ab = lookup_alpha_beta(connection, nworkers)
    return sparse_allgather_time(
        ab.alpha, ab.beta, nelems, nworkers, density, itemsize
    )


def choose_density(
    nelems: float,
    nworkers: int,
    cost_model,
    candidates: Sequence[float] = (0.25, 0.05, 0.01, 0.001),
    itemsize: int = 4,
    topk_const: float = TOPK_MACHINE_CONST,
) -> float:
    """The density whose predicted top-k select plus sparse all-gather is
    cheapest, or 1.0 when the dense all-reduce wins. The (values, indices)
    payload is priced through the active all-reduce cost model, which
    overestimates an all-gather and so errs toward dense."""
    if nelems <= 0:
        return 1.0
    best_density = 1.0
    best_t = cost_model.predict(float(nelems) * itemsize)
    select = topk_time(nelems, topk_const)
    for d in candidates:
        payload = float(nelems) * nworkers * itemsize * d
        t = select + 2.0 * cost_model.predict(payload)
        if t < best_t:
            best_t, best_density = t, d
    return best_density


__all__ = [
    "AlphaBeta",
    "TOPK_MACHINE_CONST",
    "choose_density",
    "sparse_allgather_time",
    "sparse_allgather_time_ethernet",
    "topk_time",
    "ProfileFamily",
    "SampledCost",
    "TwoLevelAlphaBeta",
    "committed_profile_or_prior",
    "fit_alpha_beta",
    "interp_alpha_beta",
    "load_profile",
    "lookup_alpha_beta",
    "refit_two_level_from_observations",
    "resolve_profile",
    "save_profile",
]

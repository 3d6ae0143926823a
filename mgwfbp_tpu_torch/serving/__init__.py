"""Online inference plane (port of ``mgwfbp_tpu/serving``).

  * ``ServingModel`` (model.py) — the forward on one device plus an
    atomically swapped live snapshot of the newest committed checkpoint's
    weights (hot reload of shard-native steps, whichever package wrote
    them).
  * ``ReloadWatcher`` (watch.py) — polls the checkpoint directory's
    committed steps and drives the swap; emits ``reload`` events.
  * ``PredictService`` (service.py) — bounded request queue + dispatcher
    thread packing requests into fixed batch slots (deadline-or-full
    flush); answers POST ``/predict`` on the telemetry server.
  * ``ServePlane`` (plane.py) — wires them together;
    ``python -m mgwfbp_tpu_torch.serving`` runs one standalone.
"""

from mgwfbp_tpu_torch.serving.model import ServingModel, committed_sharded_steps
from mgwfbp_tpu_torch.serving.plane import ServePlane
from mgwfbp_tpu_torch.serving.service import PredictService
from mgwfbp_tpu_torch.serving.watch import ReloadWatcher

__all__ = [
    "PredictService",
    "ReloadWatcher",
    "ServePlane",
    "ServingModel",
    "committed_sharded_steps",
]

"""Telemetry plane of the port: the event stream (``events``), overlap
accounting (``overlap``), the metric registry and its renderers
(``export``), the live HTTP plane (``serve``), the fleet fan-in
(``fleet``), drift and straggler detection (``drift``), training-health
detection (``health``) and the flight recorder (``recorder``)."""

from mgwfbp_tpu_torch.telemetry.events import (
    EVENT_SCHEMA_VERSION,
    EVENT_TYPES,
    EventWriter,
    events_of,
    find_stream_paths,
    read_event_set,
    read_events,
    stream_filename,
)
from mgwfbp_tpu_torch.telemetry.overlap import (
    GroupOverlap,
    OverlapSummary,
    attribute_overlap,
    group_comm_times,
    summarize,
)

__all__ = [
    "EVENT_SCHEMA_VERSION",
    "EVENT_TYPES",
    "EventWriter",
    "GroupOverlap",
    "OverlapSummary",
    "attribute_overlap",
    "events_of",
    "find_stream_paths",
    "group_comm_times",
    "read_event_set",
    "read_events",
    "stream_filename",
    "summarize",
]

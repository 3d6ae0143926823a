"""Telemetry plane of the port (so far: the serving HTTP endpoints)."""

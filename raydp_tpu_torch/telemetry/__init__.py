"""Telemetry of the port: the DataFrame engine's stage statistics."""

"""Utilities of the port: metric writing."""

from .metrics import MetricWriter, ThroughputMeter  # noqa: F401

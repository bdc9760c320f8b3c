"""Observability and accounting helpers: ``profiling`` (traces, step
timers, metric streams) and ``flops`` (analytic FLOP counts)."""

from . import profiling  # noqa: F401

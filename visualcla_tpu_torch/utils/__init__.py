"""Utilities of the port: ``profiling`` (phase timers, counters, traces)."""

"""Frozen copy of the reference package's tracer."""

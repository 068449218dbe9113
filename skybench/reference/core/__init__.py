"""Frozen copies of the reference package's core modules."""

"""Frozen copies of the reference package's sim modules."""

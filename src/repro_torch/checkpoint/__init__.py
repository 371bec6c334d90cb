"""Atomic, checksummed checkpoints of nested dicts of arrays."""

"""Serving-side background work over a live index (the maintenance loop)."""

"""Geometry, grids, view selection, synthetic fixtures and device choice."""

"""Scheduling of device work (single device in this slice of the port)."""

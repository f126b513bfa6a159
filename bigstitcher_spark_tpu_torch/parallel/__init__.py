"""Scheduling of device work: the pair scheduler (one device) and the
sharded block work loop over a mesh of devices, with its retry layer."""

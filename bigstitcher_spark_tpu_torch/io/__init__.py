"""Host IO in numpy and the standard library: SpimData XML, N5 / zarr v2 chunks."""

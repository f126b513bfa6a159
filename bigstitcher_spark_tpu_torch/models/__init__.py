"""Pipeline drivers built on the ops kernels."""

"""Device programs: hand-written CUDA kernels and their plain-torch twins."""

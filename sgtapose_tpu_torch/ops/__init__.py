"""Hand-written CUDA kernels: builder, launch counters and wrappers."""

"""Hand-written CUDA kernels, their build, and host-side preprocessing."""

"""Hand-written CUDA kernels of the update tail, their plain versions and
wrappers."""

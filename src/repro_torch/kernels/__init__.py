"""Hand-written CUDA kernels (the update tail and the compression body),
their plain versions and wrappers."""

"""DC-S3GD (arXiv:1911.02516) in PyTorch, with hand-written CUDA kernels
for the NVIDIA H100.

A port of the JAX package ``repro``: module names mirror it
(``repro_torch.core.dc_s3gd`` ↔ ``repro.core.dc_s3gd`` and so on), the
parameter and state layouts are the same, and the JAX package stays the
oracle the parity tests compare against.  This package imports neither
``jax`` nor anything of ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch
version.
"""

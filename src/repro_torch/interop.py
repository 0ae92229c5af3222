"""Weights across packages: numpy trees <-> trees of torch tensors.

The JAX package initialises weights with ``jax.random``, which torch
cannot reproduce, so parity runs carry the reference's weights over as
numpy arrays.  Nesting, shapes and dtypes are kept; bfloat16 crosses as
its 16-bit pattern (numpy has no native bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable host copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; ships with the JAX stack
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, *, device="cuda"):
    """Tree of numpy (or array-like) leaves -> same tree of tensors."""
    return T.map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Tree of tensors -> same tree of numpy arrays on the host."""
    return T.map(_to_numpy, tree)

"""Weights and state across packages: numpy trees <-> trees of tensors.

The JAX package initialises weights with ``jax.random``, which torch
cannot reproduce, so parity runs carry the reference's weights over as
numpy arrays.  Nesting, shapes and dtypes are kept (so falcon-mamba's
``a_log``, ``dt_bias`` and ``d_skip`` stay f32 beside bf16 weights, as in
the reference); bfloat16 crosses as its 16-bit pattern (numpy has no
native bfloat16).  A compressed
reducer's ``TrainState.comm["reducer"]`` crosses the same way, except
randk's ``step``, which is an int32 array in the reference and a host int
in the port.  Dynamic SSP's ``comm["staleness"]`` counters are a device
int32 array in the reference and a host numpy int32 array in the port.
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


def reducer_state_from_numpy(rstate, *, device="cuda"):
    """A reference ``comm["reducer"]`` (residual list, randk's ``step``,
    powersgd's ``q`` list) as numpy -> the port's layout."""
    out = {k: params_from_numpy(v, device=device) for k, v in rstate.items()
           if k != "step"}
    if "step" in rstate:
        out["step"] = int(np.asarray(rstate["step"]))
    return out


def reducer_state_to_numpy(rstate):
    """The port's ``comm["reducer"]`` -> the reference's layout, as numpy."""
    out = {k: params_to_numpy(v) for k, v in rstate.items() if k != "step"}
    if "step" in rstate:
        out["step"] = np.asarray(rstate["step"], np.int32)
    return out


def staleness_counters(pstate):
    """A ``comm["staleness"]`` of either package -> host int32 numpy
    counters: the port's layout, and what the reference's jnp arrays
    convert from."""
    return {k: np.array(v, np.int32) for k, v in pstate.items()}

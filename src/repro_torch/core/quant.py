"""Symmetric scaled quantization for the int8/fp8 wire (a copy of
``repro.core.quant``).

Each row (a worker's bucket or leaf on the wire) carries its values in
int8/fp8 plus ONE f32 scale, chosen so the row's absolute maximum maps to
the format's clip point: dequantization is one multiply, zero stays
exactly zero, and an int8 element's error is at most
``amax(row) / (2 * QMAX)``.  The reducers' error-feedback residual absorbs
``a - dequantize(quantize(c))`` as it absorbs sparsification
(`repro_torch.core.compress`).

Dtype names: ``"int8"`` and ``"float8_e4m3fn"`` plus the aliases ``"fp8"``
and ``"i8"``.  The float wires (``"float32"``, ``"bfloat16"``,
``"float16"``) are not quantized; their callers cast.
"""
from __future__ import annotations

from typing import Tuple

import torch

# canonical name -> (storage dtype, symmetric clip point).  e4m3fn's max
# finite value is 448; int8 clips at 127 so the symmetric range is exact.
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "float8_e4m3fn": (torch.float8_e4m3fn, 448.0),
}
_ALIASES = {"fp8": "float8_e4m3fn", "i8": "int8"}
FLOAT_WIRES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}

SCALE_BYTES = 4  # one f32 scale per quantized row on the wire


def canonical(name) -> str:
    s = str(name)
    return _ALIASES.get(s, s)


def is_quantized(name) -> bool:
    return canonical(name) in QUANT_DTYPES


def qinfo(name) -> Tuple[torch.dtype, float]:
    """(storage dtype, clip point) for a quantized dtype name."""
    return QUANT_DTYPES[canonical(name)]


def float_wire(name) -> torch.dtype:
    """The torch dtype of a float (plain-cast) wire name."""
    if name not in FLOAT_WIRES:
        raise ValueError(f"comm_dtype {name!r}: have "
                         f"{sorted(FLOAT_WIRES) + sorted(QUANT_DTYPES)} "
                         f"and the aliases {sorted(_ALIASES)}")
    return FLOAT_WIRES[name]


def wire_itemsize(name) -> int:
    """Payload bytes per element."""
    if is_quantized(name):
        return 1
    return float_wire(name).itemsize


def quantize(x: torch.Tensor, name, *, axes=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with per-row scales (keepdims).

    ``axes`` are the reduction axes of the amax (default: every axis but
    0, one scale per leading-axis row).  The op order is the reference's:
    amax, ``max(amax, 1e-30) / qmax``, ``clip(x / scale)``, round (int8,
    half to even), cast."""
    qdt, qmax = qinfo(name)
    x = x.float()
    if axes is None:
        axes = tuple(range(1, x.dim()))
    # torch reduces over every axis for an empty list; jnp over none
    amax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar through
    # its reciprocal, which is not the reference's division
    scale = amax.clamp_min(1e-30) / torch.full_like(amax, qmax)
    y = torch.clamp(x / scale, -qmax, qmax)
    if not qdt.is_floating_point:
        y = torch.round(y)
    return y.to(qdt), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale

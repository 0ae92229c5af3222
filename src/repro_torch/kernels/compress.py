"""The error-feedback compression kernel, its wrapper and its plain version.

`select_ef_mean` replaces ``repro/kernels/compress.py::select_ef_mean``
(``_select_ef_kernel``): one launch per bucket reads the accumulated
payload ``a`` (W, n) once and writes the worker mean (1, n) and the new
residual (W, n):

    keep_w = |a_w| >= t_w          (union=True ORs the masks over W)
    c_w    = where(keep, a_w, 0)   cast to the wire dtype and back
    mean   = (sum of c_w in worker order) / W, rounded to the wire dtype
    res'_w = a_w - c_w

Bound on an H100: bytes, 4W read + 4 + 4W written per column (20 B at
W = 2).  The CUDA kernel (``csrc/compress.cu``) is one grid-striding pass
with 16-byte accesses where the operands allow them; the per-worker
thresholds are read from device memory, so the step never waits on the
host.  The thresholds themselves are computed outside, in torch
(`repro_torch.core.compress.magnitude_threshold`).

The kernel takes any n (the reference's needs n % BLOCK == 0 and leaves
other buckets to XLA) and the plain-cast wires f32, bf16 and f16.  On a
CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.select_ef_mean_plain`); on a CUDA tensor it
launches the kernel or raises.  ``select_ef_mean.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.dc_update import _aligned, _check, _grid, _raise_on
from repro_torch.kernels.ref import select_ef_mean_plain

# the kernel's wire codes (csrc/compress.cu)
_WIRE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def select_ef_mean(a: torch.Tensor, thresh: torch.Tensor, *,
                   comm_dtype: torch.dtype, union: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused select + wire cast + worker mean + residual for one bucket.

    a: (W, n) f32; thresh: (W,) or (W, 1) f32 on a's device; comm_dtype:
    torch.float32, bfloat16 or float16.  Returns ``(mean, residual)``:
    (1, n) f32 and (W, n) f32, bitwise the plain version."""
    if a.device.type == "cpu":
        return select_ef_mean_plain(a, thresh, comm_dtype=comm_dtype,
                                    union=union)
    if a.device.type != "cuda":
        raise ValueError(f"select_ef_mean: no kernel for device {a.device}")
    thresh = thresh.reshape(-1).contiguous()    # W floats
    _check("select_ef_mean", a, thresh)
    if a.dtype != torch.float32 or a.dim() != 2 \
            or thresh.dtype != torch.float32 \
            or thresh.shape != (a.shape[0],) or comm_dtype not in _WIRE_CODE:
        raise ValueError("select_ef_mean: a (W, n) f32, thresh (W,) f32, "
                         "comm_dtype float32/bfloat16/float16")
    from repro_torch.kernels.build import library
    W, n = a.shape
    mean = torch.empty((1, n), dtype=torch.float32, device=a.device)
    res = torch.empty_like(a)
    # elementwise per column: the load width never changes the bits
    vec = _aligned(n, a, mean, res)
    # PyTorch on CUDA divides by a Python scalar through its reciprocal, so
    # the kernel multiplies by the same f32 reciprocal (exactly the
    # division when W is a power of two)
    inv_w = float(torch.tensor(1.0) / torch.tensor(float(W)))
    err = library("compress").select_ef_mean_f32(
        a.data_ptr(), thresh.data_ptr(), W, n, _WIRE_CODE[comm_dtype],
        int(bool(union)), inv_w, int(vec), _grid(n, n % 4 == 0),
        mean.data_ptr(), res.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "select_ef_mean")
    select_ef_mean.launches += 1
    return mean, res


select_ef_mean.launches = 0

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

On a worker axis split over ranks one launch holds W / R rows: with
``partial=True`` it writes the f32 row sum instead of the mean, and
`finish_mean` completes it after the all-reduce with the operations the
full mode runs in the kernel (so one rank gives the same bits); ``mask``,
a (1, n) uint8 union from every rank, replaces the OR over the local rows.

The kernel takes any n (the reference's needs n % BLOCK == 0 and leaves
other buckets to XLA) and the plain-cast wires f32, bf16 and f16.  On a
CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.select_ef_mean_plain`); on a CUDA tensor it
launches the kernel or raises.  ``select_ef_mean.launches`` counts the
launches; inside an op trace the call is one node whose wire casts are
the plain version's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.instrument import nbytes, traced_kernel
from repro_torch.kernels.dc_update import _aligned, _check, _grid, _raise_on
from repro_torch.kernels.ref import select_ef_mean_plain

# the kernel's wire codes (csrc/compress.cu)
_WIRE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def select_ef_mean_cost(a, thresh, *, comm_dtype, union, mask=None,
                        partial=False) -> dict:
    # select, cast, sum and residual per element; the (W, n) payload and
    # the (1, n) mean cross the wire dtype, as `wire_mean`'s casts do (a
    # partial sum is not cast: `finish_mean` casts it, outside); a union
    # mask adds its n bytes read
    W, n = a.shape
    rows = W if partial else W + 1
    casts = () if comm_dtype == torch.float32 else (
        ("float32", str(comm_dtype).replace("torch.", ""), rows * n),)
    return {"flops": 4 * W * n,
            "bytes_read": nbytes(a, thresh, mask),
            "bytes_written": 4 * (W + 1) * n, "casts": casts}


def _inv(n_workers: int) -> float:
    """The f32 reciprocal of the worker count, as a host float."""
    return float(torch.tensor(1.0) / torch.tensor(float(n_workers)))


def finish_mean(acc: torch.Tensor, n_workers: int,
                comm_dtype: torch.dtype) -> torch.Tensor:
    """The mean of a ``partial=True`` row sum all-reduced over the ranks:
    (1, n) f32 over the global ``n_workers``, rounded to the wire.  On the
    card the f32 reciprocal multiply the full mode does in the kernel; on
    the CPU `wire_mean`'s division, which the plain version's full mode
    does.  (PyTorch on CUDA divides by a Python scalar through that same
    reciprocal, so both are each device's one-process mean.)"""
    if acc.device.type == "cuda":
        return (acc * _inv(n_workers)).to(comm_dtype).float()
    return (acc / n_workers).to(comm_dtype).float()


@traced_kernel("select_ef_mean", select_ef_mean_cost)
def select_ef_mean(a: torch.Tensor, thresh: torch.Tensor, *,
                   comm_dtype: torch.dtype, union: bool,
                   mask: Optional[torch.Tensor] = None,
                   partial: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused select + wire cast + worker mean + residual for one bucket.

    a: (W, n) f32; thresh: (W,) or (W, 1) f32 on a's device; comm_dtype:
    torch.float32, bfloat16 or float16; mask: None or a (1, n) uint8
    union (with ``union=True``); partial: the row sum in place of the
    mean.  Returns ``(mean, residual)``: (1, n) f32 and (W, n) f32,
    bitwise the plain version in every mode."""
    if a.device.type == "cpu":
        return select_ef_mean_plain(a, thresh, comm_dtype=comm_dtype,
                                    union=union, mask=mask, partial=partial)
    if a.device.type != "cuda":
        raise ValueError(f"select_ef_mean: no kernel for device {a.device}")
    thresh = thresh.reshape(-1).contiguous()    # W floats
    _check("select_ef_mean", a, thresh)
    if a.dtype != torch.float32 or a.dim() != 2 \
            or thresh.dtype != torch.float32 \
            or thresh.shape != (a.shape[0],) or comm_dtype not in _WIRE_CODE:
        raise ValueError("select_ef_mean: a (W, n) f32, thresh (W,) f32, "
                         "comm_dtype float32/bfloat16/float16")
    if mask is not None:
        mask = mask.reshape(-1).contiguous()    # n bytes
        _check("select_ef_mean", a, mask)
        if not union or mask.dtype != torch.uint8 \
                or mask.shape != (a.shape[1],):
            raise ValueError("select_ef_mean: a union mask is (1, n) uint8 "
                             "and needs union=True")
    from repro_torch.kernels.build import library
    W, n = a.shape
    mean = torch.empty((1, n), dtype=torch.float32, device=a.device)
    res = torch.empty_like(a)
    # elementwise per column: the load width never changes the bits
    vec = _aligned(n, a, mean, res)
    # PyTorch on CUDA divides by a Python scalar through its reciprocal, so
    # the kernel multiplies by the same f32 reciprocal (exactly the
    # division when W is a power of two)
    inv_w = _inv(W)
    with torch.cuda.device(a.device):
        err = library("compress").select_ef_mean_f32(
            a.data_ptr(), thresh.data_ptr(),
            None if mask is None else mask.data_ptr(), W, n,
            _WIRE_CODE[comm_dtype], int(bool(union)), int(bool(partial)),
            inv_w, int(vec), _grid(n, n % 4 == 0), mean.data_ptr(),
            res.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "select_ef_mean")
    select_ef_mean.launches += 1
    return mean, res


select_ef_mean.launches = 0

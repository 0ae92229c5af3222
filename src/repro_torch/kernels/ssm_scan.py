"""The selective-scan kernel, its wrapper and its plain version.

`ssm_scan` replaces ``repro/kernels/ssm_scan.py::ssm_scan``
(``_ssm_kernel``): the Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} +
dtx_t b_t, y_t = <h_t, c_t> with A = -exp(a_log), returning y and the
last state.  It is the scan of `repro_torch.models.ssm.mamba_forward`.

Bound on an H100: bytes (dt, dtx read and y written once, 12 bytes per
(t, e)); at one batch row the S dependent steps of each of the E x N
chains set the time.  The CUDA kernel (``csrc/ssm_scan.cu``) runs the
chains in parallel, 4 states of one channel per thread, sequential over t
inside the thread, with no padding of S or E: the TPU kernel's blocks
need both padded by the caller.

On a CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.ssm_scan_plain`); on a CUDA tensor it launches
the kernel or raises.  ``ssm_scan.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.dc_update import _check, _contiguous16, _raise_on
from repro_torch.kernels.ref import ssm_scan_plain

_STATES = (4, 8, 16, 32, 64, 128)     # the kernel's instantiations


def ssm_scan(a_log: torch.Tensor, dt: torch.Tensor, dtx: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_log: (E, N); dt, dtx: (B, S, E); b, c: (B, S, N); any float
    dtype, computed in f32.  Returns (y (B, S, E) f32, h_last (B, E, N)
    f32), h_last the state after step S."""
    if dt.device.type == "cpu":
        return ssm_scan_plain(a_log, dt, dtx, b, c)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {dt.device}")
    if dt.dim() != 3 or a_log.dim() != 2:
        raise ValueError("ssm_scan: a_log (E, N), dt and dtx (B, S, E), b "
                         "and c (B, S, N)")
    B, S, E = dt.shape
    N = a_log.shape[1]
    if a_log.shape != (E, N) or dtx.shape != dt.shape \
            or b.shape != (B, S, N) or c.shape != b.shape \
            or N not in _STATES or B < 1 \
            or not all(t.dtype.is_floating_point
                       for t in (a_log, dt, dtx, b, c)):
        raise ValueError(
            "ssm_scan: a_log (E, N), dt and dtx (B, S, E), b and c (B, S, "
            f"N), floating point, N in {_STATES}; got {tuple(a_log.shape)}, "
            f"{tuple(dt.shape)}, {tuple(dtx.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    a_log, dt, dtx, b, c = (_contiguous16(t.float())
                            for t in (a_log, dt, dtx, b, c))
    _check("ssm_scan", a_log, dt, dtx, b, c)
    from repro_torch.kernels.build import library
    y = torch.empty((B, S, E), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, E, N), dtype=torch.float32, device=dt.device)
    err = library("ssm_scan").ssm_scan_f32(
        a_log.data_ptr(), dt.data_ptr(), dtx.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, E, N,
        torch.cuda.current_stream(dt.device).cuda_stream)
    _raise_on(err, "ssm_scan")
    ssm_scan.launches += 1
    return y, h_last


ssm_scan.launches = 0

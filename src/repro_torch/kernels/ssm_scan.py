"""The selective-scan kernel, its wrapper and its plain version.

`ssm_scan` replaces ``repro/kernels/ssm_scan.py::ssm_scan``
(``_ssm_kernel``): the Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} +
dtx_t b_t, y_t = <h_t, c_t> with A = -exp(a_log), returning y and the
last state.  It is the scan of `repro_torch.models.ssm.mamba_forward`.

Bound on an H100: bytes (dt, dtx read and y written once, 12 bytes per
(t, e)); it has no matrix product, so the tensor cores do not apply.  At
one batch row the E x N chains are too few to fill the card if each runs
all S steps, so the CUDA kernel (``csrc/ssm_scan.cu``) is a chunked scan
with a carry pass, the associative form of the reference's
``_ssm_scan_chunked``: S is cut into chunks of `chunk_length` steps
(chosen from the shapes so that the grid fills the SMs); pass 1 scans
every chunk but the last from h = 0 and writes its end state and decay
product to a workspace; pass 2 folds the carries of the chunks before
its own, rescans its chunk from there and writes y (the last chunk also
h_last).  4 states of one channel per thread, each CTA's b and c rows
staged in shared memory by cp.async, no padding of S or E.  Where one
chunk holds S, pass 2 alone runs the sequential chain with expf, and
h_last is bitwise the plain version's; past one chunk the step takes the
SFU's ex2 with fused multiply-adds (within the reference's 1e-4).

On a CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.ssm_scan_plain`); on a CUDA tensor it launches
the kernel or raises.  ``ssm_scan.launches`` counts the wrapper's calls
that launched (one per call, both passes).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.instrument import nbytes, traced_kernel
from repro_torch.kernels.dc_update import (_check, _contiguous16,
                                           _raise_on, _sm_count)
from repro_torch.kernels.ref import ssm_scan_plain

_STATES = (4, 8, 16, 32, 64, 128)     # the kernel's instantiations
_THREADS = 256                         # the kernel's kThreads
_CTAS_PER_SM = 4                       # per pass; fewer chunks, less redone
_MIN_CHUNK = 16


def ctas_per_chunk(batch: int, channels: int, state: int) -> int:
    """CTAs one chunk's scan takes: a thread holds 4 states of one
    channel, 256 threads per CTA."""
    return -(-channels // (_THREADS // (state // 4))) * batch


def chunk_length(batch: int, seq: int, channels: int, state: int,
                 sms: int) -> int:
    """Steps per chunk: the shortest power of two, from ``_MIN_CHUNK``
    up, whose grid (channel blocks x batch x chunks) holds at most
    ``_CTAS_PER_SM`` CTAs per SM; ``seq`` itself (one chunk, no carry)
    where the channels alone fill the SMs or S is short.  Every chunk but
    the first and the last is scanned twice, so fewer, longer chunks win
    once the SMs are busy: on an H100 at falcon-mamba's prefill (B 1, E
    8,192, N 16, S = 512) chunks of 128 took 0.0646 ms against 0.0709 for
    chunks of 64 (``scripts/kernel_variants.py``).  128 there on 132
    SMs."""
    ctas = ctas_per_chunk(batch, channels, state)
    target = _CTAS_PER_SM * sms
    if seq <= _MIN_CHUNK or ctas * 2 > target:
        return max(seq, 1)
    length = _MIN_CHUNK
    while length < seq and ctas * -(-seq // length) > target:
        length *= 2
    return length


def ssm_scan_cost(a_log, dt, dtx, b, c) -> dict:
    # 7 flops per (step, channel, state); y and h_last written in f32
    B, S, E = dt.shape
    N = a_log.shape[1]
    return {"flops": 7 * B * S * E * N,
            "bytes_read": nbytes(a_log, dt, dtx, b, c),
            "bytes_written": 4 * (B * S * E + B * E * N)}


@traced_kernel("ssm_scan", ssm_scan_cost)
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
    L = chunk_length(B, S, E, N, _sm_count(dt.device))
    chunks = max(1, -(-S // L))
    # pass 1's (h_c, P_c) of every chunk but the last
    work = torch.empty(2 * B * (chunks - 1) * E * N, dtype=torch.float32,
                       device=dt.device) if chunks > 1 else None
    with torch.cuda.device(dt.device):
        err = library("ssm_scan").ssm_scan_f32(
            a_log.data_ptr(), dt.data_ptr(), dtx.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            work.data_ptr() if work is not None else None, B, S, E, N, L,
            torch.cuda.current_stream(dt.device).cuda_stream)
    _raise_on(err, "ssm_scan")
    ssm_scan.launches += 1
    return y, h_last


ssm_scan.launches = 0

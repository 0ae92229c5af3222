"""The DC-S3GD update-tail kernels, their plain versions and wrappers.

The paper's per-step compute is an elementwise tail over four model-sized
tensors (g, D, m, w) producing three (w', m', Δw), plus the two norm
reductions of Eq. 17.  Two hand-written Hopper kernels
(``csrc/dc_update.cu``) do it in one pass each:

* `dc_norms` replaces ``repro/kernels/dc_update.py::dc_norms``
  (``_dc_norms_kernel``).  Bound on an H100: bytes, 8 B/element read.
  The TPU kernel sums into a (1,1) block over a sequential grid; here
  blocks run in parallel, so it is a two-pass reduction (per-block
  partials, then a fixed-order sum per worker) with no float atomics:
  run-to-run identical sums.
* `dc_fused_update` replaces ``repro/kernels/dc_update.py::dc_fused_update``
  (``_dc_update_kernel``).  Bound: bytes, 28 B/element with f32 w
  (24 with bf16 w).  One grid-striding pass with 16-byte accesses; the
  worker is the grid's y axis, so one launch covers all W workers (the
  reference vmaps one launch per worker); λ is read per worker from
  device memory, so the step never waits on the host.

Both take the worker-stacked (W, n) layout.  On a CPU tensor a wrapper
runs its plain PyTorch version (the port of ``repro/kernels/ref.py``'s
``dc_norms_ref`` / ``dc_fused_update_ref``); on a CUDA tensor it launches
the kernel or raises.  Each wrapper counts its launches in ``.launches``,
and inside an op trace (`repro_torch.analysis.optrace`) records one node
with the bytes and FLOPs above.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.instrument import nbytes, traced_kernel

_MAX_BLOCKS = 1024   # per worker row; the grid strides over the rest


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dc_norms_plain(g: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(W, n) g, D -> (W, 2): [‖g_w‖², ‖g_w⊙g_w⊙D_w‖²] per worker row."""
    g32 = g.float()
    c = g32 * g32 * d.float()
    return torch.stack([(g32 * g32).sum(1), (c * c).sum(1)], dim=1)


def dc_fused_update_plain(g, d, m, w, *, lam, mu: float, eta: float,
                          wd: float):
    """(W, n) operands, λ (W,):

        g̃  = g + λ·g⊙g⊙D + wd·w
        m' = μ·m + g̃,   Δw = −η·m',   w' = w + D + Δw

    Returns (w' in w's dtype, m' f32, Δw f32)."""
    g32, d32, w32 = g.float(), d.float(), w.float()
    g_t = g32 + lam.reshape(-1, 1) * (g32 * g32 * d32)
    g_t = g_t + wd * w32
    m_new = mu * m.float() + g_t
    delta = -eta * m_new
    w_new = (w32 + d32 + delta).to(w.dtype)
    return w_new, m_new, delta


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _contiguous16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _grid(n: int, vec: bool) -> int:
    threads = 256
    items = n // 4 if vec else n
    return max(1, min(-(-items // threads), _MAX_BLOCKS))


def _aligned(n: int, *ts: torch.Tensor) -> bool:
    """16-byte accesses need n % 4 == 0 and aligned row starts."""
    return n % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in ts)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (a cached host query, no sync)."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


def dc_norms_cost(g, d) -> dict:
    # g², ·D, square and two sums per element; (W, 2) f32 out
    return {"flops": 5 * g.numel(), "bytes_read": nbytes(g, d),
            "bytes_written": 8 * g.shape[0]}


def dc_fused_update_cost(g, d, m, w, *, lam, **_) -> dict:
    # the eleven multiplies and adds of the tail; w' in w's dtype, m' and
    # Δw f32
    return {"flops": 11 * g.numel(), "bytes_read": nbytes(g, d, m, w, lam),
            "bytes_written": nbytes(w) + 8 * g.numel()}


@traced_kernel("dc_norms", dc_norms_cost)
def dc_norms(g: torch.Tensor, d: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, n) f32 g, D -> (gsq, csq), each (W,) f32."""
    if g.device.type == "cpu":
        out = dc_norms_plain(g, d)
        return out[:, 0], out[:, 1]
    if g.device.type != "cuda":
        raise ValueError(f"dc_norms: no kernel for device {g.device}")
    _check("dc_norms", g, d)
    if g.dtype != torch.float32 or d.dtype != torch.float32 or g.dim() != 2 \
            or d.shape != g.shape:
        raise ValueError("dc_norms: g, D must be (W, n) float32")
    from repro_torch.kernels.build import library
    W, n = g.shape
    # the grid and the sum order follow n alone; alignment picks only the
    # load width, so a misaligned view gives the same bits
    vec = n % 4 == 0
    nblocks = _grid(n, vec)
    partials = torch.empty((W, nblocks, 2), dtype=torch.float32,
                           device=g.device)
    out = torch.empty((W, 2), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = library("dc_update").dc_norms_f32(
            g.data_ptr(), d.data_ptr(), W, n, int(vec),
            int(_aligned(n, g, d)), nblocks, partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(err, "dc_norms")
    dc_norms.launches += 1
    return out[:, 0], out[:, 1]


dc_norms.launches = 0


@traced_kernel("dc_fused_update", dc_fused_update_cost)
def dc_fused_update(g, d, m, w, *, lam: torch.Tensor, mu: float, eta: float,
                    wd: float):
    """(W, n) f32 g, D, m and w (f32 or bf16), λ (W,) f32 on g's device.
    Returns (w', m', Δw): w' in w's dtype, m' and Δw f32."""
    if g.device.type == "cpu":
        return dc_fused_update_plain(g, d, m, w, lam=lam, mu=mu, eta=eta,
                                     wd=wd)
    if g.device.type != "cuda":
        raise ValueError(f"dc_fused_update: no kernel for device {g.device}")
    _check("dc_fused_update", g, d, m, w, lam)
    if any(t.dtype != torch.float32 for t in (g, d, m, lam)) \
            or w.dtype not in (torch.float32, torch.bfloat16) \
            or g.dim() != 2 or not (g.shape == d.shape == m.shape == w.shape) \
            or lam.shape != (g.shape[0],):
        raise ValueError("dc_fused_update: g, D, m (W, n) f32, w (W, n) "
                         "f32/bf16, lam (W,) f32")
    from repro_torch.kernels.build import library
    W, n = g.shape
    w_new = torch.empty_like(w)
    m_new = torch.empty_like(m)
    delta = torch.empty_like(g)
    # elementwise: each output's bits are the same on either path
    vec = _aligned(n, g, d, m, w, w_new, m_new, delta)
    lib = library("dc_update")
    fn = lib.dc_fused_update_f32w if w.dtype == torch.float32 \
        else lib.dc_fused_update_bf16w
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), d.data_ptr(), m.data_ptr(), w.data_ptr(),
                 lam.data_ptr(), float(mu), float(eta), float(wd), W, n,
                 int(vec), _grid(n, vec), w_new.data_ptr(), m_new.data_ptr(),
                 delta.data_ptr(),
                 torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(err, "dc_fused_update")
    dc_fused_update.launches += 1
    return w_new, m_new, delta


dc_fused_update.launches = 0

"""The Mamba-1 selective-SSM block of falcon-mamba (the port of
``repro.models.ssm``: ``dt_rank_of``, ``init_mamba``, ``_ssm_scan_chunked``
(`ssm_scan_chunked`), ``mamba_forward``, ``init_mamba_state``,
``mamba_decode``; ``mamba_prefill`` is the reference's
``transformer._mamba_with_state``).

Two scan routes.  The prefill runs its scan through the hand-written
kernel `repro_torch.kernels.ssm_scan.ssm_scan` (its plain version on the
CPU), which never materialises the state and has no backward.  Training
(``mamba_forward(..., chunk=n)``, as `Model.loss` calls it) takes the
reference's chunked linear-recurrence scan, differentiable by autograd: a
log-depth (Hillis–Steele) associative scan over each chunk with the
reference's ``combine``, the state carried between chunks in a Python
loop, each chunk checkpointed (non-reentrant ``torch.utils.checkpoint``,
the reference's ``jax.checkpoint``) and contracted against C inside the
chunk, so the (B, S, E, N) state never exists beyond one chunk.  The two
scans reduce in other orders than ``jax.lax.associative_scan``: they agree
to rounding, not to the bit.  The RG-LRU block
(`repro_torch.models.rglru`) scans through `ssm_scan_chunked` with N = 1.
The decode step is the O(1)-state recurrence with the conv state and the
ssm state carried, written in place.

Parameters keep the reference's names, shapes and dtypes (``a_log``,
``dt_bias`` and ``d_skip`` f32 whatever the param dtype), with a leading
stacked-layer shape ``lead`` as the stage tree holds them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssm_scan_plain
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_update,
                                       checkpointed, conv_state, dense_init,
                                       matmul, row_matmul)


def dt_rank_of(d_model: int, cfg) -> int:
    return cfg.dt_rank or -(-d_model // 16)


def init_mamba(gen: torch.Generator, lead, d: int, cfg, dtype) -> dict:
    """Weights with a leading stacked-layer shape ``lead``, on ``gen``'s
    device: the reference's init (LeCun-normal projections, conv weights
    N(0, 0.1^2), dt_bias uniform in [-4.6, -2.3] (softplus^-1 of ~1e-2),
    the S4D-real A = 1..N as ``a_log``, ``d_skip`` ones)."""
    lead = tuple(lead)
    e, n, r = cfg.expand * d, cfg.state_dim, dt_rank_of(d, cfg)
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init(gen, lead + (d, 2 * e), dtype, in_axis_size=d),
        "conv_w": (torch.randn(lead + (e, cfg.conv_kernel), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (e,), dtype=dtype, device=dev),
        "w_x": dense_init(gen, lead + (e, r + 2 * n), dtype, in_axis_size=e),
        "w_dt": dense_init(gen, lead + (r, e), dtype, in_axis_size=r),
        "dt_bias": torch.empty(lead + (e,), dtype=torch.float32,
                               device=dev).uniform_(-4.6, -2.3,
                                                    generator=gen),
        "a_log": torch.log(a).expand(lead + (e, n)).contiguous(),
        "d_skip": torch.ones(lead + (e,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, lead + (e, d), dtype, in_axis_size=e),
    }


def _project_in(params: dict, x: torch.Tensor, tp=None):
    """x (B, S, d) -> (xi pre-conv, z), each (B, S, e).

    With ``tp`` ``w_in`` holds this rank's contiguous block of the 2e
    columns, which the reference lays out x branch first: on two ranks
    rank 0 holds all of xi's columns and rank 1 all of z's.  The product
    is gathered over the axis and each rank keeps its e / M channels of
    xi and of z, the channels its ``conv_w`` / ``a_log`` / ``d_skip``
    shards belong to; the gathered tensor's gradient is summed over the
    axis before the rank's columns are taken (`ModelAxis.gather_reduce`:
    each rank reads other slices of it)."""
    xz = matmul(x, params["w_in"], tp)
    if tp is None:
        return xz.chunk(2, dim=-1)
    xi, z = tp.gather_reduce(xz, -1).chunk(2, dim=-1)
    e_l = xz.shape[-1] // 2
    lo = tp.shard_start(e_l)
    return xi[..., lo:lo + e_l], z[..., lo:lo + e_l]


def _dt_b_c(params: dict, xi: torch.Tensor, cfg, d: int, tp=None):
    """Post-conv xi -> (dt f32, B, C) as the reference splits ``xi @
    w_x`` into dt_low, B and C.  With ``tp`` xi holds this rank's
    channels: ``xi @ w_x`` is a row-parallel partial summed over the axis
    in f32, and the replicated sum enters the local channels (``w_dt``'s
    columns, the scan's B and C) through one `ModelAxis.copy`."""
    r, n = dt_rank_of(d, cfg), cfg.state_dim
    xbc = row_matmul(xi, params["w_x"], tp)
    if tp is not None:
        xbc = tp.copy(xbc)
    dt_low, bm, cm = xbc.split([r, n, n], dim=-1)
    dt = F.softplus(matmul(dt_low, params["w_dt"]).float()
                    + params["dt_bias"])
    return dt, bm, cm


# ---------------------------------------------------------------------------
# the chunked linear-recurrence scan (training; RG-LRU's prefill)
# ---------------------------------------------------------------------------


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1, by
    Hillis–Steele doubling: log2(L) passes, each combining every element
    with the one ``step`` before it by the reference's ``combine``,
    ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2).  Returns (a_acc, b_acc),
    with h_t = a_acc_t h_0 + b_acc_t."""
    step = 1
    while step < a.shape[1]:
        a_lo, b_lo = a[:, :-step], b[:, :-step]
        a_hi, b_hi = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_lo * a_hi], dim=1)
        b = torch.cat([b[:, :step], a_hi * b_lo + b_hi], dim=1)
        step *= 2
    return a, b


def _chunk_hs(h, a, b):
    a_acc, b_acc = _assoc_scan(a, b)
    hs = a_acc * h[:, None] + b_acc
    return hs[:, -1], hs


def _chunk_y(h, a, b, c):
    a_acc, b_acc = _assoc_scan(a, b)
    hs = a_acc * h[:, None] + b_acc
    return hs[:, -1], torch.einsum("bsen,bsn->bse", hs, c)


def ssm_scan_chunked(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor,
                     chunk: int, C: Optional[torch.Tensor] = None):
    """The reference's ``_ssm_scan_chunked``: h_t = dA_t h_{t-1} + dBx_t
    over axis 1 from ``h0`` (B, E, N).  dA, dBx: (B, S, E, N), S a multiple
    of ``chunk``.  Without ``C`` returns (hs (B, S, E, N), h_last); with
    ``C`` (B, S, N) the state is contracted against C inside each chunk
    and only y (B, S, E) is returned beside h_last.  Differentiable."""
    S = dA.shape[1]
    if S % chunk:
        raise ValueError(f"ssm_scan_chunked: S {S} is not a multiple of "
                         f"the chunk {chunk}")
    h, outs = h0, []
    for s0 in range(0, S, chunk):
        xs = (dA[:, s0:s0 + chunk], dBx[:, s0:s0 + chunk])
        if C is None:
            h, out = checkpointed(_chunk_hs, h, *xs)
        else:
            h, out = checkpointed(_chunk_y, h, *xs, C[:, s0:s0 + chunk])
        outs.append(out)
    return torch.cat(outs, dim=1), h


def _mamba_chunk(h, dt, dtx, bm, cm, A):
    """One chunk of the training scan: the discretised (B, chunk, E, N)
    dA and dBx are built here and die with the chunk."""
    dA = torch.exp(dt[..., None] * A)
    dbx = dtx[..., None] * bm.float()[..., None, :]
    return _chunk_y(h, dA, dbx, cm.float())


def _scan_chunked(a_log, dt, dtx, bm, cm, chunk: int):
    """The reference's training scan of ``mamba_forward``: (y (B, S, E)
    f32, h_last (B, E, N) f32), identity-padded (dt = 0: dA = 1, dBx = 0)
    to a multiple of ``min(chunk, S)``."""
    B, S, E = dt.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        dt, dtx, bm, cm = (F.pad(t, (0, 0, 0, pad))
                           for t in (dt, dtx, bm, cm))
    A = -torch.exp(a_log)
    h = torch.zeros((B, E, a_log.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for s0 in range(0, S + pad, chunk):
        h, y = checkpointed(_mamba_chunk, h,
                             *(t[:, s0:s0 + chunk] for t in (dt, dtx, bm,
                                                            cm)), A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _forward(params: dict, x: torch.Tensor, cfg, use_kernel: bool,
             chunk: Optional[int] = None, tp=None):
    """(out (B, S, d), final ssm state (B, E, N) f32, pre-conv xi (B, S,
    E)) of the full-sequence pass; with ``tp`` E is this rank's channels
    and ``w_out`` is row-parallel."""
    d = x.shape[-1]
    xi_raw, z = _project_in(params, x, tp)
    xi = F.silu(causal_conv1d(xi_raw, params["conv_w"], params["conv_b"]))
    dt, bm, cm = _dt_b_c(params, xi, cfg, d, tp)
    dtx = dt * xi.float()
    if chunk is not None:
        y, h_last = _scan_chunked(params["a_log"], dt, dtx, bm, cm, chunk)
    else:
        scan = ssm_scan if use_kernel else ssm_scan_plain
        y, h_last = scan(params["a_log"], dt, dtx, bm, cm)
    y = y + params["d_skip"] * xi.float()
    y = y.to(x.dtype) * F.silu(z)
    return row_matmul(y, params["w_out"], tp), h_last, xi_raw


def mamba_forward(params: dict, x: torch.Tensor, cfg, *,
                  return_state: bool = False, use_kernel: bool = True,
                  chunk: Optional[int] = None, tp=None):
    """x: (B, S, d) -> (B, S, d) [, final ssm state (B, E, N) f32].

    With ``chunk`` (the reference's argument) the scan is the
    differentiable chunked one, the training route.  Without it the scan
    goes through the kernel wrapper (the CUDA kernel on the card, its plain
    version on the CPU); ``use_kernel=False`` runs the plain version on any
    device, the route the kernel is checked against.  ``tp`` (a
    `repro_torch.parallel.tensor.ModelAxis`; training): the params are
    this rank's shards over 'model', the inner dim's channels (`_forward`);
    the scan runs per channel on the local ones."""
    out, h_last, _ = _forward(params, x, cfg, use_kernel, chunk, tp)
    return (out, h_last) if return_state else out


def mamba_prefill(params: dict, x: torch.Tensor, cfg, *,
                  use_kernel: bool = True,
                  tp=None) -> Tuple[torch.Tensor, dict]:
    """`mamba_forward` that also returns the decode state after the prompt
    (the reference's ``_mamba_with_state``): ``{"conv"``: the raw, pre-conv
    xi of the last K-1 positions in x's dtype (zero rows before a
    prompt shorter than that), ``"ssm"``: the final
    state}.  The reference recomputes xi for the conv state; here it is
    the forward pass's own, the same values.  ``tp``: the params are this
    rank's shards over 'model' (`_forward`), so is the state: its E is
    the rank's channels, as the cache specs shard it."""
    out, h_last, xi_raw = _forward(params, x, cfg, use_kernel, tp=tp)
    conv = conv_state(xi_raw, cfg.conv_kernel).to(x.dtype)
    return out, {"conv": conv, "ssm": h_last}


def init_mamba_state(batch: int, d: int, cfg, dtype, device) -> dict:
    """Zeroed decode state: conv (batch, K-1, e) in ``dtype``, ssm
    (batch, e, N) f32."""
    e = cfg.expand * d
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, e), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, e, cfg.state_dim), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params: dict, state: dict, x: torch.Tensor, cfg, *,
                 tp=None) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x: (B, 1, d).  Returns ((B, 1, d), ``state``
    updated in place).  The reference returns a new state whose conv part
    is promoted to the step's dtype; here it is written into the caller's
    buffer at that buffer's dtype (a bf16 slot state rounds it).  ``tp``:
    the params and the state are this rank's channels (`_forward`'s
    edges: ``w_in``'s product gathered, ``w_x`` and ``w_out``
    row-parallel)."""
    d = x.shape[-1]
    xi, z = _project_in(params, x[:, 0], tp)
    xi, conv = causal_conv1d_update(state["conv"], xi, params["conv_w"],
                                    params["conv_b"])
    xi = F.silu(xi)
    dt, bm, cm = _dt_b_c(params, xi, cfg, d, tp)
    A = -torch.exp(params["a_log"])
    dA = torch.exp(dt[..., None] * A)                   # (B, e, n)
    dbx = (dt * xi.float())[..., None] * bm.float()[:, None, :]
    h = dA * state["ssm"] + dbx
    y = torch.einsum("ben,bn->be", h, cm.float())
    y = y + params["d_skip"] * xi.float()
    y = y.to(x.dtype) * F.silu(z)
    out = row_matmul(y, params["w_out"], tp)[:, None]
    state["conv"].copy_(conv)
    state["ssm"].copy_(h)
    return out, state

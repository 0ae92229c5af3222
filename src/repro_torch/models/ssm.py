"""The Mamba-1 selective-SSM block of falcon-mamba (the port of
``repro.models.ssm``: ``dt_rank_of``, ``init_mamba``, ``mamba_forward``,
``init_mamba_state``, ``mamba_decode``; ``mamba_prefill`` is the
reference's ``transformer._mamba_with_state``).

The full-sequence pass runs its scan through the hand-written kernel
`repro_torch.kernels.ssm_scan.ssm_scan` (its plain version on the CPU).
The reference scans with XLA in chunks (``_ssm_scan_chunked``), a memory
device that keeps the (B, chunk, E, N) state small; the kernel never
materialises the state, so the port has no chunk argument and the math is
the same recurrence.  The decode step is the O(1)-state recurrence with
the conv state and the ssm state carried, written in place.

Parameters keep the reference's names, shapes and dtypes (``a_log``,
``dt_bias`` and ``d_skip`` f32 whatever the param dtype), with a leading
stacked-layer shape ``lead`` as the stage tree holds them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssm_scan_plain
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_update,
                                       dense_init, matmul)


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


def _project_in(params: dict, x: torch.Tensor):
    """x (B, S, d) -> (xi pre-conv, z), each (B, S, e)."""
    xz = matmul(x, params["w_in"])
    return xz.chunk(2, dim=-1)


def _dt_b_c(params: dict, xi: torch.Tensor, cfg, d: int):
    """Post-conv xi -> (dt f32, B, C) as the reference splits ``xi @
    w_x`` into dt_low, B and C."""
    r, n = dt_rank_of(d, cfg), cfg.state_dim
    dt_low, bm, cm = matmul(xi, params["w_x"]).split([r, n, n], dim=-1)
    dt = F.softplus(matmul(dt_low, params["w_dt"]).float()
                    + params["dt_bias"])
    return dt, bm, cm


def _forward(params: dict, x: torch.Tensor, cfg, use_kernel: bool):
    """(out (B, S, d), final ssm state (B, E, N) f32, pre-conv xi (B, S,
    E)) of the full-sequence pass."""
    d = x.shape[-1]
    xi_raw, z = _project_in(params, x)
    xi = F.silu(causal_conv1d(xi_raw, params["conv_w"], params["conv_b"]))
    dt, bm, cm = _dt_b_c(params, xi, cfg, d)
    dtx = dt * xi.float()
    scan = ssm_scan if use_kernel else ssm_scan_plain
    y, h_last = scan(params["a_log"], dt, dtx, bm, cm)
    y = y + params["d_skip"] * xi.float()
    y = y.to(x.dtype) * F.silu(z)
    return matmul(y, params["w_out"]), h_last, xi_raw


def mamba_forward(params: dict, x: torch.Tensor, cfg, *,
                  return_state: bool = False, use_kernel: bool = True):
    """x: (B, S, d) -> (B, S, d) [, final ssm state (B, E, N) f32].

    The scan goes through the kernel wrapper (the CUDA kernel on the card,
    its plain version on the CPU); ``use_kernel=False`` runs the plain
    version on any device, the route the kernel is checked against."""
    out, h_last, _ = _forward(params, x, cfg, use_kernel)
    return (out, h_last) if return_state else out


def mamba_prefill(params: dict, x: torch.Tensor, cfg, *,
                  use_kernel: bool = True) -> Tuple[torch.Tensor, dict]:
    """`mamba_forward` that also returns the decode state after the prompt
    (the reference's ``_mamba_with_state``): ``{"conv"``: the raw, pre-conv
    xi of the last K-1 positions in x's dtype, ``"ssm"``: the final
    state}.  The reference recomputes xi for the conv state; here it is
    the forward pass's own, the same values."""
    out, h_last, xi_raw = _forward(params, x, cfg, use_kernel)
    conv = xi_raw[:, -(cfg.conv_kernel - 1):, :].to(x.dtype)
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


def mamba_decode(params: dict, state: dict, x: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x: (B, 1, d).  Returns ((B, 1, d), ``state``
    updated in place).  The reference returns a new state whose conv part
    is promoted to the step's dtype; here it is written into the caller's
    buffer at that buffer's dtype (a bf16 slot state rounds it)."""
    d = x.shape[-1]
    xi, z = _project_in(params, x[:, 0])
    xi, conv = causal_conv1d_update(state["conv"], xi, params["conv_w"],
                                    params["conv_b"])
    xi = F.silu(xi)
    dt, bm, cm = _dt_b_c(params, xi, cfg, d)
    A = -torch.exp(params["a_log"])
    dA = torch.exp(dt[..., None] * A)                   # (B, e, n)
    dbx = (dt * xi.float())[..., None] * bm.float()[:, None, :]
    h = dA * state["ssm"] + dbx
    y = torch.einsum("ben,bn->be", h, cm.float())
    y = y + params["d_skip"] * xi.float()
    y = y.to(x.dtype) * F.silu(z)
    out = matmul(y, params["w_out"])[:, None]
    state["conv"].copy_(conv)
    state["ssm"].copy_(h)
    return out, state

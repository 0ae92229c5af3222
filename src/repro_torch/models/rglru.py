"""The RG-LRU recurrent block of RecurrentGemma / Griffin (the port of
``repro.models.rglru``; ``rglru_prefill`` is the reference's
``transformer._rglru_with_state``).

Two branches from the input: x-branch linear(d -> w) -> causal conv(4) ->
RG-LRU recurrence; gate-branch linear(d -> w) -> GeLU (tanh, as
``jax.nn.gelu``); merged multiplicatively, then linear(w -> d).  Per
channel:

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(-c softplus(lam) r_t)                 (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The full-sequence pass scans through the differentiable chunked scan of
`repro_torch.models.ssm.ssm_scan_chunked` with N = 1, identity-padded to
a multiple of the chunk as the reference pads; it is the training route
and the prefill's (no kernel computes it).  Decoding carries (conv state,
h) and writes them in place.  The gates and h are f32 whatever the compute
dtype; h is cast to the block input's dtype before the gate product, and
the conv state is kept at the compute dtype, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (act_fn, causal_conv1d,
                                       causal_conv1d_update, conv_state,
                                       dense_init, matmul, row_matmul)
from repro_torch.models.ssm import ssm_scan_chunked

_C = 8.0  # Griffin's fixed exponent scale


def init_rglru_block(gen: torch.Generator, lead, d: int, cfg,
                     dtype) -> dict:
    """Weights with a leading stacked-layer shape ``lead``, on ``gen``'s
    device: the reference's init (LeCun-normal projections, conv weights
    N(0, 0.1^2), ``lam`` = softplus^-1(-log(u) / c) for u uniform in
    [0.9, 0.999], so that a is in [0.9, 0.999] at r = 1; ``lam`` f32
    whatever the param dtype)."""
    lead = tuple(lead)
    w = cfg.lru_width or d
    dev = gen.device
    u = torch.empty(lead + (w,), dtype=torch.float32,
                    device=dev).uniform_(0.9, 0.999, generator=gen)
    return {
        "w_x": dense_init(gen, lead + (d, w), dtype, in_axis_size=d),
        "w_gate": dense_init(gen, lead + (d, w), dtype, in_axis_size=d),
        "conv_w": (torch.randn(lead + (w, cfg.conv_kernel), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "w_a": dense_init(gen, lead + (w, w), dtype, in_axis_size=w),
        "w_i": dense_init(gen, lead + (w, w), dtype, in_axis_size=w),
        "lam": torch.log(torch.exp(-torch.log(u) / _C) - 1.0),
        "w_out": dense_init(gen, lead + (w, d), dtype, in_axis_size=w),
    }


def _gates(params: dict, xi: torch.Tensor, tp=None):
    """(a, beta * i * xi), both f32: the recurrence's decay and input.
    With ``tp`` xi holds this rank's channels and ``w_a`` / ``w_i`` their
    columns (w, w / M): the whole xi is gathered over the axis to enter
    them, its gradient summed over the axis before the rank's channels
    are taken (`ModelAxis.gather_reduce`)."""
    xw = xi if tp is None else tp.gather_reduce(xi, -1)
    r = torch.sigmoid(matmul(xw, params["w_a"]).float())
    i = torch.sigmoid(matmul(xw, params["w_i"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * xi.float()


def _forward(params: dict, x: torch.Tensor, chunk: int, tp=None):
    """(out (B, S, d), h after the last position (B, w) f32, the pre-conv
    xi (B, S, w)) of the full-sequence pass.  With ``tp`` w is this
    rank's channels: ``w_x`` / ``w_gate`` column-parallel, the conv, the
    gates and the scan per channel, ``w_out`` row-parallel."""
    B, S, _ = x.shape
    xi_raw = matmul(x, params["w_x"], tp)
    gate = act_fn("gelu")(matmul(x, params["w_gate"], tp))
    xi = causal_conv1d(xi_raw, params["conv_w"], params["conv_b"])
    a, bx = _gates(params, xi, tp)                   # (B, S, w) each
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:   # identity steps: a = 1, bx = 0 leave h as it is
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        bx = F.pad(bx, (0, 0, 0, pad))
    hs, h_last = ssm_scan_chunked(
        a[..., None], bx[..., None],
        torch.zeros((B, a.shape[-1], 1), dtype=torch.float32,
                    device=x.device), chunk)
    h = hs[:, :S, :, 0].to(x.dtype)
    return row_matmul(h * gate, params["w_out"], tp), h_last[..., 0], \
        xi_raw


def rglru_forward(params: dict, x: torch.Tensor, cfg, *,
                  chunk: int = 256, tp=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); differentiable.  ``tp``: the params are
    this rank's shards over 'model' (`_forward`)."""
    return _forward(params, x, chunk, tp)[0]


def rglru_prefill(params: dict, x: torch.Tensor, cfg, *,
                  chunk: int = 256, tp=None) -> Tuple[torch.Tensor, dict]:
    """`rglru_forward` that also returns the decode state after the prompt
    (the reference's ``_rglru_with_state``): ``{"conv"``: the raw, pre-conv
    xi of the last K-1 positions in x's dtype (zero rows before a
    prompt shorter than that), ``"h"``: the final state
    (B, w) f32}.  The reference runs the scan twice (once for y, once for
    h_last); here both come from the one pass.  ``tp``: the params are
    this rank's shards over 'model', the state the rank's channels."""
    out, h_last, xi_raw = _forward(params, x, chunk, tp)
    conv = conv_state(xi_raw, cfg.conv_kernel).to(x.dtype)
    return out, {"conv": conv, "h": h_last}


def init_rglru_state(batch: int, d: int, cfg, dtype, device) -> dict:
    """Zeroed decode state: conv (batch, K-1, w) in ``dtype``, h (batch, w)
    f32."""
    w = cfg.lru_width or d
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(params: dict, state: dict, x: torch.Tensor, cfg, *,
                 tp=None) -> Tuple[torch.Tensor, dict]:
    """One-token step.  x: (B, 1, d).  Returns ((B, 1, d), ``state``
    updated in place; the conv state at its buffer's dtype).  ``tp``: the
    params and the state are this rank's channels, the gates read the
    gathered xi (`_forward`'s edges)."""
    xt = x[:, 0]
    xi = matmul(xt, params["w_x"], tp)
    gate = act_fn("gelu")(matmul(xt, params["w_gate"], tp))
    xi, conv = causal_conv1d_update(state["conv"], xi, params["conv_w"],
                                    params["conv_b"])
    a, bx = _gates(params, xi, tp)
    h = a * state["h"] + bx
    out = row_matmul(h.to(x.dtype) * gate, params["w_out"], tp)[:, None]
    state["conv"].copy_(conv)
    state["h"].copy_(h)
    return out, state

"""Shared building blocks (the port of ``repro.models.layers``): init
helpers, rmsnorm, rotary embeddings, the gated MLP and the causal 1-d
convolution of the Mamba block.

Parameters are nested dicts of tensors with the reference's names,
shapes and layouts (``(d, f)`` weights, used as ``x @ w``), so weights
move between the packages one to one.  Random init draws from an
explicit ``torch.Generator`` and lands on that generator's device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype,
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """LeCun-normal style init; fan-in is the product of all but the last
    dim unless given.  A leading stacked-layer axis is not part of the
    fan-in: pass ``in_axis_size``."""
    fan_in = in_axis_size
    if fan_in is None:
        fan_in = int(math.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: a stacked weight (17 GB for falcon-mamba-7b's
    # w_in) is never held twice
    x = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
    return x.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02
            ).to(dtype)


def init_rmsnorm(shape, dtype, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mixed-precision matmul
# ---------------------------------------------------------------------------


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's type promotion.

    The reference multiplies bf16 activations (``compute_dtype``) by f32
    weights and jnp promotes the product to f32; torch refuses a
    mixed-dtype matmul, so both sides are cast to the promoted type here.
    With f32 weights this makes every activation after the first product
    f32, as in the reference."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S):
    (S,) shared, or (B, 1) per row at decode."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None, None].float() * inv    # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, lead, d: int, f: int, dtype) -> dict:
    """Gated MLP weights with a leading stacked-layer shape ``lead``."""
    lead = tuple(lead)
    return {
        "w_up": dense_init(gen, lead + (d, f), dtype, in_axis_size=d),
        "w_down": dense_init(gen, lead + (f, d), dtype, in_axis_size=f),
        "w_gate": dense_init(gen, lead + (d, f), dtype, in_axis_size=d),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SiLU-gated MLP: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    up = F.silu(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    return matmul(up, params["w_down"])


# ---------------------------------------------------------------------------
# causal 1-d convolution (the Mamba block's temporal conv)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (C, K), the reference's
    layout.  K shifted multiply-adds, in the reference's order."""
    k = w.shape[-1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[:, i]
    if bias is not None:
        out = out + bias
    return out


def causal_conv1d_update(conv_state: torch.Tensor, x_t: torch.Tensor,
                         w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  conv_state: (B, K-1, C) past inputs; x_t:
    (B, C).  Returns (y_t, new_conv_state), both in the promoted dtype
    (jnp's concatenate promotes; torch's einsum needs it spelled out)."""
    k = w.shape[-1]
    dt = torch.promote_types(torch.promote_types(conv_state.dtype,
                                                 x_t.dtype), w.dtype)
    window = torch.cat([conv_state.to(dt), x_t.to(dt)[:, None, :]], dim=1)
    y = torch.einsum("bkc,ck->bc", window, w.to(dt))
    if bias is not None:
        y = y + bias
    return y, (window[:, 1:] if k > 1 else conv_state)

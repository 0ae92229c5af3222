"""Shared building blocks (the port of ``repro.models.layers``): init
helpers, rmsnorm and layernorm, rotary embeddings (plain RoPE and
Qwen2-VL's multimodal M-RoPE), whisper's sinusoidal absolute positions,
the MLP, gated or not (SiLU or tanh-GeLU), the causal 1-d
convolution of the Mamba and RG-LRU blocks, and `checkpointed`, the
rematerialisation every remat boundary of the models goes through.

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
from torch.utils.checkpoint import checkpoint

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


def init_layernorm(shape, dtype, device) -> dict:
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mixed-precision matmul
# ---------------------------------------------------------------------------


def promoted(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands of a product cast to their promoted dtype.

    The reference multiplies bf16 activations (``compute_dtype``) by f32
    weights and jnp promotes the product to f32; torch refuses a
    mixed-dtype matmul or einsum, so every operand is cast to the
    promoted type here.  With f32 weights this makes every activation
    after the first product f32, as in the reference."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def matmul(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``x @ w`` (batched over leading dims) with jnp's type promotion.
    With ``tp`` (a `repro_torch.parallel.tensor.ModelAxis`) ``w`` holds
    this rank's columns of a column-parallel product: the promoted ``x``
    enters through `ModelAxis.copy`, so each product's input gradient is
    summed over the axis at the promoted dtype and cast back once, as the
    one-process product's is (a bf16 ``x`` would otherwise sum its
    rounded per-rank shares)."""
    x, w = promoted(x, w)
    if tp is not None:
        x = tp.copy(x)
    return x @ w


def row_matmul(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``matmul(x, w)``; with ``tp`` a row-parallel product (``x`` and
    ``w`` this rank's block of the contracted dim), its f32 partials
    summed over the axis and cast once to the promoted dtype
    (`repro_torch.parallel.tensor.ModelAxis.row_matmul`)."""
    if tp is None:
        return matmul(x, w)
    return tp.row_matmul(x, w, torch.promote_types(x.dtype, w.dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Mean and variance over the last axis in f32, then scale and bias
    (the reference's ``layernorm``)."""
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dtype)


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: (..., S, H, head_dim); positions:
    (3, ..., S), the temporal / height / width position of each token:
    (3, S) for a whole sequence, (3, 1) at a dense decode step, (3, B, 1)
    at a paged one.  ``sections`` split the head_dim // 2 frequencies
    into t / h / w groups, each rotated by its own component; the
    rotation is in f32 and cast back, as in `apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim // 2 = {half}")
    inv = rope_freqs(x.shape[-1], theta, x.device)              # (half,)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long,
                                 device=x.device)
                      for i, s in enumerate(sections)])          # (half,)
    pos = positions.float()[comp].movedim(0, -1)                # (..., S, half)
    angles = pos[..., None, :] * inv                            # (..., S, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# absolute positions (whisper)
# ---------------------------------------------------------------------------


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal embedding at ``positions`` (any shape):
    (..., d) f32, sines then cosines over d // 2 frequencies.  The
    denominator is the reference's ``max(d // 2 - 1, 1)``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """(n_pos, d) f32: `sinusoidal` at positions 0 .. n_pos - 1 (the
    reference's ``sinusoidal_positions``)."""
    return sinusoidal(torch.arange(n_pos, device=device), d)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, lead, d: int, f: int, gated: bool,
             dtype) -> dict:
    """MLP weights with a leading stacked-layer shape ``lead``; ``w_gate``
    only when ``gated``."""
    lead = tuple(lead)
    p = {
        "w_up": dense_init(gen, lead + (d, f), dtype, in_axis_size=d),
        "w_down": dense_init(gen, lead + (f, d), dtype, in_axis_size=f),
    }
    if gated:
        p["w_gate"] = dense_init(gen, lead + (d, f), dtype, in_axis_size=d)
    return p


def act_fn(name: str):
    """The reference's ``act_fn``.  ``jax.nn.gelu`` is the tanh
    approximation by default, so "gelu" is ``approximate="tanh"`` here
    (the exact erf form differs by up to ~5e-4 per element)."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(params: dict, x: torch.Tensor, activation: str,
        tp=None) -> torch.Tensor:
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down`` when the weights hold
    ``w_gate``, else ``act(x @ w_up) @ w_down``.  With ``tp`` (a
    `repro_torch.parallel.tensor.ModelAxis`) the weights are this rank's
    shards: ``w_up`` / ``w_gate`` column-parallel (the hidden dim's
    block), ``w_down`` row-parallel, its partials summed over the axis."""
    act = act_fn(activation)
    up = matmul(x, params["w_up"], tp)
    up = act(matmul(x, params["w_gate"], tp)) * up if "w_gate" in params \
        else act(up)
    return row_matmul(up, params["w_down"], tp)


# ---------------------------------------------------------------------------
# causal 1-d convolution (the Mamba / RG-LRU blocks' temporal conv)
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


def conv_state(x: torch.Tensor, k: int) -> torch.Tensor:
    """The decode conv state after a prompt: x's last ``k - 1`` rows (x:
    (B, S, C), the raw pre-conv inputs), left-padded with zeros when the
    prompt is shorter.  Zeros before position 0 are what `causal_conv1d`
    assumes.  (The reference keeps ``x[:, -(k-1):]``, which holds only S
    rows for S < k - 1: ROADMAP queue C5.)"""
    tail = x[:, max(x.shape[1] - (k - 1), 0):]
    return F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))


def causal_conv1d_update(conv_state: torch.Tensor, x_t: torch.Tensor,
                         w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  conv_state: (B, K-1, C) past inputs; x_t:
    (B, C).  Returns (y_t, new_conv_state), both in the promoted dtype
    (jnp's concatenate promotes; torch's einsum needs it spelled out)."""
    k = w.shape[-1]
    state, x_t, w = promoted(conv_state, x_t, w)
    window = torch.cat([state, x_t[:, None, :]], dim=1)
    y = torch.einsum("bkc,ck->bc", window, w)
    if bias is not None:
        y = y + bias
    return y, (window[:, 1:] if k > 1 else conv_state)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


def checkpointed(fn, *args, reads=()):
    """``fn(*args)``, rematerialised in the backward pass when autograd
    records it (the reference's ``jax.checkpoint``): only ``args`` are
    kept for the backward pass, and ``fn`` runs again there to rebuild
    what its backward reads (non-reentrant ``torch.utils.checkpoint``;
    the recompute stops at the last tensor the backward needs).
    ``reads``: tensors ``fn`` reads through its closure (a block's
    weights), which switch it on too when they require gradients.
    Without a gradient to record (a prefill, a decode step) ``fn`` just
    runs.  No model draws a random number in its forward pass, so the
    RNG state is not saved for the recompute."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (*args, *reads)):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)

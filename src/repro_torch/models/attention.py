"""Grouped-query attention for training: dense, causal, no window (the
port of ``repro.models.attention.init_attention`` / ``attention_train``).

The attention core is plain tensor code, as the reference's is (it
computes it with XLA, not with a Pallas kernel): the masked softmax is
taken over the whole (short) sequence at once, where the reference
streams KV blocks through an online softmax — the same function, up to
rounding.  The Pallas ``flash_attention`` kernel is a later slice's port.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (apply_rope, dense_init, init_rmsnorm,
                                       matmul, rmsnorm)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, lead, d: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool, dtype) -> dict:
    """Weights with a leading stacked-layer shape ``lead``."""
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, n_heads, head_dim), dtype,
                         in_axis_size=d),
        "wk": dense_init(gen, lead + (d, n_kv, head_dim), dtype,
                         in_axis_size=d),
        "wv": dense_init(gen, lead + (d, n_kv, head_dim), dtype,
                         in_axis_size=d),
        "wo": dense_init(gen, lead + (n_heads, head_dim, d), dtype,
                         in_axis_size=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(lead + (head_dim,), dtype, gen.device)
        p["k_norm"] = init_rmsnorm(lead + (head_dim,), dtype, gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') with jnp promotion."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, KV, G, hd); k, v: (B, S, KV, hd).  Scores and softmax in
    f32.  Returns (B, S, KV, G, hd) in q's dtype."""
    S, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float()) \
        * (hd ** -0.5)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_train(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, rope_theta: float, qk_norm: bool = False,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """x: (B, S, d); positions: (S,).  Returns (B, S, d)."""
    B, S, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k = rmsnorm(params["k_norm"], k, norm_eps)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    out = causal_attention(q.reshape(B, S, KV, H // KV, hd), k, v)
    wo = params["wo"]
    return matmul(out.reshape(B, S, H * hd), wo.reshape(H * hd, wo.shape[-1]))

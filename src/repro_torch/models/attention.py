"""Grouped-query attention: dense, causal, no window (the port of
``repro.models.attention``'s ``init_attention`` / ``attention_train`` and,
for decoding, ``init_kv_cache`` / ``decode_positions`` / ``attend_one`` /
``attention_decode``).

The full-sequence attention core has two routes, chosen by the caller
(``core``): ``"plain"`` (`causal_attention`, plain tensor code that takes
the masked softmax over the whole sequence at once, where the reference's
XLA path streams KV blocks through an online softmax: the same function,
up to rounding) for training, whose gradients autograd takes through it;
and ``"flash"``, the hand-written kernel
`repro_torch.kernels.flash_attention` (its plain version on the CPU),
forward only, for the prefill.

Decoding writes the new token's k/v into the cache in place (the torch
form of the reference's buffer donation).  The sliding-window ring,
cross-attention and M-RoPE are not ported (ROADMAP A6): the dense family
has none of them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
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
                    norm_eps: float = 1e-6, return_kv: bool = False,
                    core: str = "plain"):
    """x: (B, S, d); positions: (S,).  Returns (B, S, d), and with
    ``return_kv`` also the (normed, roped) k and v (B, S, KV, hd) that a
    decode cache stores.  ``core``: ``"plain"`` (`causal_attention`,
    differentiable) or ``"flash"`` (the flash-attention kernel's wrapper,
    forward only)."""
    if core not in ("plain", "flash"):
        raise ValueError(f"attention core {core!r}: 'plain' or 'flash'")
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
    qg = q.reshape(B, S, KV, H // KV, hd)
    out = flash_attention(qg, k, v, causal=True) if core == "flash" \
        else causal_attention(qg, k, v)
    wo = params["wo"]
    y = matmul(out.reshape(B, S, H * hd), wo.reshape(H * hd, wo.shape[-1]))
    return (y, k, v) if return_kv else y


# ---------------------------------------------------------------------------
# one-token decode against a KV cache
# ---------------------------------------------------------------------------


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported: the dense family decodes with full causal "
        "self-attention only (ROADMAP A6)")


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device) -> dict:
    """Zeroed dense k and v caches (batch, cache_len, n_kv, head_dim)."""
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_positions(pos: torch.Tensor) -> torch.Tensor:
    """Positions for RoPE at decode: a 0-d ``pos`` (the dense layout, every
    row at the same position) becomes (1,); a per-row (B,) vector (the
    paged layout) becomes (B, 1)."""
    return pos[None] if pos.dim() == 0 else pos[:, None]


def attend_one(qg: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention core.  qg: (B, KV, G, hd); k/v caches:
    (B, C, KV, hd); valid: (C,) shared or (B, C) per-row mask.  Returns
    (B, KV, G, hd) f32.  Shared by the dense and paged cache layouts, so
    the two are bitwise equal on matched inputs.  The probabilities are
    rounded to the cache dtype before the PV product, as the reference
    does (at bf16 this is where the gather path and the paged kernel,
    which keeps them in f32, part)."""
    hd = qg.shape[-1]
    s = torch.einsum("bkgh,bckh->bkgc", qg.float(), k_cache.float()) \
        * (hd ** -0.5)
    mask = valid[None] if valid.dim() == 1 else valid
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgc,bckh->bkgh", p.to(v_cache.dtype).float(),
                        v_cache.float())


def attention_decode(params: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, *, rope_theta: float,
                     window: int = 0, qk_norm: bool = False,
                     norm_eps: float = 1e-6, cross: bool = False,
                     cache_ops=None):
    """One-token decode.  x: (B, 1, d); pos: 0-d int tensor (the dense
    layout) or a per-row (B,) vector under a paged layout, on x's device.

    Cache keys are stored post-RoPE.  ``cache_ops`` (a
    `repro_torch.models.cache` layout's step ops) takes over the cache
    update + attend, the seam the paged layout plugs into; ``None`` is the
    dense path, which writes at ``pos`` in place.  Returns ((B, 1, d),
    the cache)."""
    if window > 0:
        raise _unported("the sliding-window ring cache")
    if cross:
        raise _unported("cross-attention")
    B = x.shape[0]
    positions = decode_positions(pos)
    q = _project(x, params["wq"])
    k_new = _project(x, params["wk"])
    v_new = _project(x, params["wv"])
    if qk_norm:
        q = rmsnorm(params["q_norm"], q, norm_eps)
        k_new = rmsnorm(params["k_norm"], k_new, norm_eps)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k_new = apply_rope(k_new, positions, rope_theta)
    H, KV, hd = q.shape[2], k_new.shape[2], q.shape[3]
    qg = q.reshape(B, KV, H // KV, hd)
    if cache_ops is not None:
        out, cache = cache_ops.kv_attend(cache, qg, k_new, v_new,
                                         window=window)
    else:
        rows = torch.arange(B, device=x.device)
        slot = pos.long().expand(B)
        cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
        valid = torch.arange(cache["k"].shape[1], device=x.device) <= pos
        out = attend_one(qg, cache["k"], cache["v"], valid)
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    wo = params["wo"]
    return matmul(out, wo.reshape(H * hd, wo.shape[-1])), cache

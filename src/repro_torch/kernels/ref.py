"""Plain PyTorch versions of the compression, paged-attention, flash-
attention and selective-scan kernels (the port of ``repro/kernels/
ref.py``'s ``select_ef_mean_ref``, ``paged_attention_ref`` and
``ssm_scan_ref``, and of the function ``_flash_kernel`` computes).

The update-tail kernels keep theirs beside them in
`repro_torch.kernels.dc_update`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.reduce import _row_sum, wire_mean


def select_ef_mean_plain(a: torch.Tensor, thresh: torch.Tensor, *,
                         comm_dtype: torch.dtype, union: bool,
                         mask: Optional[torch.Tensor] = None,
                         partial: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bucket of the error-feedback compression body:

        keep_w = |a_w| >= t_w    (union=True ORs the masks over workers)
        c_w    = where(keep, a_w, 0)
        mean   = mean_w(cast(c_w, comm_dtype))      -> f32, shape (1, n)
        res'_w = a_w - c_w                          -> f32, shape (W, n)

    a: (W, n) f32 accumulated payload; thresh: (W,) or (W, 1) f32.  The
    mean adds the worker rows in worker order and divides by W, as
    `repro_torch.core.reduce.MeanAllReduce` does, so at a zero threshold
    this is bitwise the dense mean.

    The worker axis split over ranks: ``mask`` (union only), a (1, n)
    uint8 union from every rank, replaces the OR over ``a``'s rows;
    ``partial`` returns the f32 row sum of the wire-cast rows in place of
    the mean (`repro_torch.kernels.compress.finish_mean` finishes it)."""
    a32 = a.float()
    if mask is not None:
        if not union:
            raise ValueError("select_ef_mean: a union mask needs union=True")
        keep = mask.reshape(1, -1) != 0
    else:
        keep = a32.abs() >= thresh.reshape(-1, 1)
        if union:
            keep = keep.any(dim=0, keepdim=True)
    c = torch.where(keep, a32, 0.0)
    if partial:
        return _row_sum(c.to(comm_dtype).float()), a32 - c
    return wire_mean(c, comm_dtype), a32 - c


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One-token GQA decode attention over a PAGED KV cache.

    q: (B, KV, G, hd); k_pool/v_pool: (num_pages, page_size, KV, hd), the
    shared page pool; block_tables: (B, max_pages) int physical page ids
    in logical order; lengths: (B,) int valid positions per row (logical
    position p of row b lives at ``(block_tables[b, p // page_size],
    p % page_size)``).  ``k_scale``/``v_scale`` (optional,
    (num_pages, page_size) f32) are the per-token scales of int8/fp8
    pools: the linearized view is dequantized (``value.float() * scale``)
    before the attention math.

    Gathers each row's pages into logical order, masks positions
    ``>= lengths[b]`` and softmax-attends in q's dtype promoted to at
    least f32 (f32 for the model's queries, as the reference; a float64 q
    evaluates the same function without f32's rounding).  Returns
    (B, KV, G, hd) in that dtype."""
    dtype = torch.promote_types(q.dtype, torch.float32)
    B, mp = block_tables.shape
    ps = k_pool.shape[1]
    bt = block_tables.long()
    k_lin = k_pool[bt].reshape(B, mp * ps, *k_pool.shape[2:]).to(dtype)
    v_lin = v_pool[bt].reshape(B, mp * ps, *v_pool.shape[2:]).to(dtype)
    if k_scale is not None:
        k_lin = k_lin * k_scale[bt].reshape(B, mp * ps)[:, :, None, None]
        v_lin = v_lin * v_scale[bt].reshape(B, mp * ps)[:, :, None, None]
    s = torch.einsum("bkgh,bskh->bkgs", q.to(dtype), k_lin) \
        * (q.shape[-1] ** -0.5)
    mask = torch.arange(mp * ps, device=q.device)[None, :] \
        < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v_lin)


NEG_INF = -1e30   # the reference's mask value


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_start: int = 0) -> torch.Tensor:
    """Forward GQA attention over a whole sequence, the function
    ``repro/kernels/flash_attention.py::_flash_kernel`` computes.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd).  Key j sits at absolute
    position j and query row i at ``q_start + i`` (0 in the Pallas kernel;
    a prompt's chunk starts later); ``causal`` masks ``kpos > qpos`` and
    ``window > 0`` masks ``qpos - kpos >= window``.  Scores, their ``hd**-0.5``
    scale and the softmax are in f32; the unnormalised probabilities p =
    exp(s - max s) are rounded to v's dtype before the PV product, their
    f32 sum l is not, and the output is ``acc / max(l, 1e-30)`` in q's
    dtype (the kernel's finalize, with one block spanning all keys).  A
    row whose every key is masked is outside the function: the reference
    averages whatever its padded blocks hold there."""
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float(), k.float()) \
        * (hd ** -0.5)
    qpos = q_start + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqc,bckh->bkgqh", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def ssm_scan_plain(a_log: torch.Tensor, dt: torch.Tensor, dtx: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan as a sequential recurrence (the port of
    ``ssm_scan_ref``):

        h_t = exp(dt_t * A) * h_{t-1} + dtx_t * b_t,   y_t = <h_t, c_t>,

    with A = -exp(a_log) and h_0 = 0.  a_log: (E, N); dt, dtx: (B, S, E);
    b, c: (B, S, N); any S and E.  Returns (y (B, S, E) f32, h_last
    (B, E, N) f32), h_last the state after step S."""
    A = -torch.exp(a_log.float())                      # (E, N)
    dt, dtx, b, c = dt.float(), dtx.float(), b.float(), c.float()
    B_, S, E = dt.shape
    h = torch.zeros((B_, E, A.shape[-1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + dtx[:, t, :, None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(dim=-1))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros((B_, 0, E))
    return y, h

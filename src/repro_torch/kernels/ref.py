"""Plain PyTorch versions of the compression and paged-attention kernels
(the port of ``repro/kernels/ref.py``'s ``select_ef_mean_ref`` and
``paged_attention_ref``).

The update-tail kernels keep theirs beside them in
`repro_torch.kernels.dc_update`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.reduce import wire_mean


def select_ef_mean_plain(a: torch.Tensor, thresh: torch.Tensor, *,
                         comm_dtype: torch.dtype, union: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bucket of the error-feedback compression body:

        keep_w = |a_w| >= t_w    (union=True ORs the masks over workers)
        c_w    = where(keep, a_w, 0)
        mean   = mean_w(cast(c_w, comm_dtype))      -> f32, shape (1, n)
        res'_w = a_w - c_w                          -> f32, shape (W, n)

    a: (W, n) f32 accumulated payload; thresh: (W,) or (W, 1) f32.  The
    mean adds the worker rows in worker order and divides by W, as
    `repro_torch.core.reduce.MeanAllReduce` does, so at a zero threshold
    this is bitwise the dense mean."""
    a32 = a.float()
    keep = a32.abs() >= thresh.reshape(-1, 1)
    if union:
        keep = keep.any(dim=0, keepdim=True)
    c = torch.where(keep, a32, 0.0)
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
    ``>= lengths[b]`` and softmax-attends in f32.  Returns
    (B, KV, G, hd) f32."""
    B, mp = block_tables.shape
    ps = k_pool.shape[1]
    bt = block_tables.long()
    k_lin = k_pool[bt].reshape(B, mp * ps, *k_pool.shape[2:]).float()
    v_lin = v_pool[bt].reshape(B, mp * ps, *v_pool.shape[2:]).float()
    if k_scale is not None:
        k_lin = k_lin * k_scale[bt].reshape(B, mp * ps)[:, :, None, None]
        v_lin = v_lin * v_scale[bt].reshape(B, mp * ps)[:, :, None, None]
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_lin) \
        * (q.shape[-1] ** -0.5)
    mask = torch.arange(mp * ps, device=q.device)[None, :] \
        < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v_lin)

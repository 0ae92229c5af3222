"""The paged-attention decode kernel, its wrapper and its plain version.

`paged_attention` replaces ``repro/kernels/paged_attention.py::
paged_attention`` (``_paged_kernel``, ``_paged_kernel_quant``): one new
token per row attends over a paged KV cache through the row's block
table, with an online softmax over its live tokens; int8/fp8 pools are
dequantized per token with their f32 scales before QK and PV.

Bound on an H100: bytes, the row's live k and v rows read once (2 * hd *
itemsize per token and kv head) plus q and the f32 output.  The CUDA
kernel (``csrc/paged_attention.cu``) runs one CTA per (kv head, row) with
all G query heads of the group, and walks only the row's live tokens 64
at a time, where the TPU grid visits every page of the block table and
masks the dead ones: a wide block table costs nothing.  Rows are read
with 16-byte loads where they allow them.  Block tables and lengths are
read from device memory, so a decode step never waits on the host.

On a CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.paged_attention_plain`); on a CUDA tensor it
launches the kernel or raises.  ``paged_attention.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dc_update import _check, _raise_on
from repro_torch.kernels.ref import paged_attention_plain

# pool dtype -> the C entry point (csrc/paged_attention.cu)
_ENTRY = {torch.float32: "paged_attention_f32",
          torch.bfloat16: "paged_attention_bf16",
          torch.float16: "paged_attention_f16",
          torch.int8: "paged_attention_i8",
          torch.float8_e4m3fn: "paged_attention_fp8"}
_QUANTIZED = (torch.int8, torch.float8_e4m3fn)
_TILE = 64                  # the kernel's kTile
_MAX_SMEM = 232_448         # bytes of shared memory one H100 block may use


def smem_bytes(groups: int, hd: int) -> int:
    """Dynamic shared memory one CTA takes (the kernel's smem_floats)."""
    return 4 * (2 * groups * hd + _TILE * (hd + 1) + _TILE * hd
                + groups * _TILE + 3 * groups)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, KV, G, hd); k_pool/v_pool: (num_pages, page_size, KV, hd)
    in f32, bf16, f16, int8 or float8_e4m3fn; block_tables: (B, max_pages)
    int; lengths: (B,) int, positions ``>= lengths[b]`` masked (rows need
    ``lengths >= 1``).  ``k_scale``/``v_scale``: (num_pages, page_size)
    f32 per-token scales, required for int8/fp8 pools.  Returns
    (B, KV, G, hd) f32."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    B, KV, G, hd = q.shape
    num_pages, page_size = k_pool.shape[:2]
    mp = block_tables.shape[1]
    scales = () if k_scale is None else (k_scale, v_scale)
    if k_pool.dtype not in _ENTRY or v_pool.dtype != k_pool.dtype \
            or k_pool.shape != (num_pages, page_size, KV, hd) \
            or v_pool.shape != k_pool.shape \
            or block_tables.shape != (B, mp) or lengths.shape != (B,) \
            or not q.dtype.is_floating_point \
            or any(s.dtype != torch.float32
                   or s.shape != (num_pages, page_size) for s in scales):
        raise ValueError(
            "paged_attention: q (B, KV, G, hd); pools (num_pages, "
            "page_size, KV, hd) f32/bf16/f16/int8/float8_e4m3fn; "
            "block_tables (B, max_pages); lengths (B,); scales "
            "(num_pages, page_size) f32")
    if k_pool.dtype in _QUANTIZED and not scales:
        raise ValueError(f"paged_attention: {k_pool.dtype} pools need "
                         "k_scale and v_scale")
    if smem_bytes(G, hd) > _MAX_SMEM:
        raise ValueError(f"paged_attention: G={G} hd={hd} needs "
                         f"{smem_bytes(G, hd)} B of shared memory")
    q = q.float().contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    _check("paged_attention", q, k_pool, v_pool, bt, ln, *scales)
    from repro_torch.kernels.build import library
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    # 16-byte loads of k and v rows where every row starts aligned
    vec = (hd * k_pool.element_size()) % 16 == 0 \
        and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
    fn = getattr(library("paged_attention"), _ENTRY[k_pool.dtype])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if scales else None,
             v_scale.data_ptr() if scales else None,
             bt.data_ptr(), ln.data_ptr(), B, KV, G, hd, page_size, mp,
             hd ** -0.5, int(vec), out.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

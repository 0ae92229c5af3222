"""The paged-attention decode kernel, its wrapper and its plain version.

`paged_attention` replaces ``repro/kernels/paged_attention.py::
paged_attention`` (``_paged_kernel``, ``_paged_kernel_quant``): one new
token per row attends over a paged KV cache through the row's block
table, with an online softmax over its live tokens; int8/fp8 pools are
dequantized per token with their f32 scales before QK and PV.

Bound on an H100: bytes, the row's live k and v rows read once (2 * hd *
itemsize per token and kv head) plus q and the f32 output.  At about 2
flops per byte (4 G hd flops per 2 hd bf16 elements) it is far below
the ~295 where the tensor cores would bound it, and a G = 2 query tile
would leave a 16-row MMA 7/8 empty: the kernel is about keeping enough
loads in flight, not about wgmma.  The CUDA kernel
(``csrc/paged_attention.cu``) is split-K over each row's live tokens
(flash-decoding), two launches per call: pass 1 runs a grid (kv heads,
rows, splits), CTA s folding its share of the row's live tokens (a
32-token-tile multiple of ceil(n / splits), n read on the device) into a
partial (m, l, acc) through a ring of cp.async-filled 32-token tiles,
gathered token by token through the block table; pass 2
merges the splits of each (kv head, row) in a fixed order.  The split
count comes from the batch, the kv heads and the SM count alone
(`splits_for`), never from the block table's width or the page size,
so a wide table costs nothing and gives bitwise the output of a narrow
one, and pages of 8, 16 or 32 tokens give the same bits.  Block
tables and lengths are read from device memory, so a decode step never
waits on the host; the workspace is sized from shapes alone.

On a CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.paged_attention_plain`); on a CUDA tensor it
launches the kernel or raises.  ``paged_attention.launches`` counts the
wrapper's calls that launched (one per call, both passes).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.instrument import host_ints, nbytes, traced_kernel
from repro_torch.kernels.dc_update import _check, _raise_on, _sm_count
from repro_torch.kernels.ref import paged_attention_plain

# pool dtype -> the C entry point (csrc/paged_attention.cu)
_ENTRY = {torch.float32: "paged_attention_f32",
          torch.bfloat16: "paged_attention_bf16",
          torch.float16: "paged_attention_f16",
          torch.int8: "paged_attention_i8",
          torch.float8_e4m3fn: "paged_attention_fp8"}
_QUANTIZED = (torch.int8, torch.float8_e4m3fn)
_TILE = 32                  # the kernel's kTile
_STAGES = 2                 # the kernel's kStages
_MAX_SMEM = 232_448         # bytes of shared memory one H100 block may use
_CTAS_PER_SM = 16           # pass 1's target: 2,048 threads / 128 per CTA
_MAX_SPLITS = 64


def smem_bytes(groups: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory one pass-1 CTA takes (the kernel's
    smem_bytes): the ring of k tiles (rows padded by 16 bytes), v tiles
    and scales, then q (rows padded by 4 floats), acc, the tile's weights
    and m, l, corr in f32."""
    stage = -(-(_TILE * (hd * itemsize + 16) + _TILE * hd * itemsize
                + 2 * _TILE * 4) // 16) * 16
    return _STAGES * stage + 4 * (groups * (2 * hd + 4) + groups * _TILE
                                  + 3 * groups)


def splits_for(batch: int, kv_heads: int, sms: int) -> int:
    """CTAs per (kv head, row) in pass 1: about ``_CTAS_PER_SM`` CTAs per
    SM over the launch, at least 1, at most ``_MAX_SPLITS``.  16 at the
    serving shape (16 rows, 8 kv heads) on 132 SMs."""
    return max(1, min(_MAX_SPLITS, _CTAS_PER_SM * sms // (batch * kv_heads)))


def paged_attention_cost(q, k_pool, v_pool, block_tables, lengths, *,
                         k_scale=None, v_scale=None) -> dict:
    """The work one launch must do: each live k and v row (and its
    scales) read once, the live rows' block-table entries, the lengths
    and q read, the f32 output written; 4 flops per (live key, query
    head, dim) on the CUDA cores.  Reads the lengths (`host_ints`)."""
    B, KV, G, hd = q.shape
    lens = host_ints(lengths)
    tokens = sum(lens)
    page = k_pool.shape[1]
    pages = sum(-(-n // page) for n in lens)
    scales = 0 if k_scale is None else 2 * 4 * tokens
    return {"flops": 4 * G * hd * KV * tokens,
            "bytes_read": 2 * tokens * KV * hd * k_pool.element_size()
            + scales + pages * block_tables.element_size()
            + nbytes(q, lengths),
            "bytes_written": 4 * q.numel()}


@traced_kernel("paged_attention", paged_attention_cost)
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
    smem = smem_bytes(G, hd, k_pool.element_size())
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: G={G} hd={hd} needs {smem} B "
                         "of shared memory")
    q = q.float().contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    _check("paged_attention", q, k_pool, v_pool, bt, ln, *scales)
    from repro_torch.kernels.build import library
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=q.device)
    splits = splits_for(B, KV, _sm_count(q.device))
    # per split: (m, l) per query head, then acc (G, hd)
    work = torch.empty(B * KV * splits * G * (hd + 2), dtype=torch.float32,
                       device=q.device)
    # 16-byte copies of k and v rows where every row starts aligned
    vec = (hd * k_pool.element_size()) % 16 == 0 \
        and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
    fn = getattr(library("paged_attention"), _ENTRY[k_pool.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr() if scales else None,
                 v_scale.data_ptr() if scales else None,
                 bt.data_ptr(), ln.data_ptr(), B, KV, G, hd, page_size, mp,
                 hd ** -0.5, int(vec), splits, work.data_ptr(),
                 out.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0

"""The flash-attention prefill kernel, its wrapper and its plain version.

`flash_attention` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): forward GQA attention over a whole
sequence, causal and/or sliding-window, with an online softmax over key
tiles, for f32 and bf16 inputs.  It is the attention core of
`repro_torch.models.transformer.Model.prefill` and, with ``q_start`` (the
absolute position of query row 0, 0 in the Pallas kernel), of a prompt's
chunk over the keys already in the paged cache
(`repro_torch.models.cache.PagedLayout.prefill_resume`).

Bound on an H100: operations (4 hd flops per live (query, key) pair
against q, k, v and o read or written once).  The CUDA kernel
(``csrc/flash_attention.cu``) runs both products on the tensor cores
(``mma.sync``: bf16 inputs as bf16, f32 inputs as 3xTF32, three TF32
products per f32 one, which holds the reference's 2e-5).  One CTA takes
64 packed rows, the G query heads of one kv head at 64 / G positions, and
walks the key tiles they can see (64 keys; 32 or 16 where shared memory
is short), skipping those past the causal diagonal or before the window,
where the TPU grid visits and masks every key tile.  Two warpgroups (three
for bf16 at hd <= 128) share the tiles out by absolute tile index, each
through its own two-stage cp.async ring, and merge their softmax states at
the end in a fixed order; scores and probabilities stay in registers.  A
row's output does not depend on where its chunk starts, so chunked
prefill with and without prefix-cache hits gives the same bits.

On a CPU tensor the wrapper runs the plain version
(`repro_torch.kernels.ref.flash_attention_plain`); on a CUDA tensor it
launches the kernel or raises.  ``flash_attention.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dc_update import _check, _contiguous16, _raise_on
from repro_torch.kernels.ref import flash_attention_plain

# input dtype -> the C entry point (csrc/flash_attention.cu)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
# the kernel's instantiations (226 KB of shared memory at most: bf16, 128;
# 80 is stablelm-3b's)
_HEAD_DIMS = (32, 64, 80, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_start: int = 0) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd), all f32 or all bf16.
    Key j sits at absolute position j, query row i at ``q_start + i``;
    ``causal`` masks keys after the query, ``window > 0`` keys ``window``
    or more before it.  Returns (B, Sq, KV, G, hd) in q's dtype."""
    q_start = int(q_start)
    if q_start < 0:
        raise ValueError(f"flash_attention: q_start {q_start} < 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_start=q_start)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError("flash_attention: q (B, Sq, KV, G, hd), k and v "
                         "(B, Sk, KV, hd)")
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype \
            or k.shape != (B, Sk, KV, hd) or v.shape != k.shape \
            or hd not in _HEAD_DIMS or min(B, Sq, Sk) < 1:
        raise ValueError(
            "flash_attention: q (B, Sq, KV, G, hd), k and v (B, Sk, KV, "
            f"hd), all float32 or all bfloat16, hd in {_HEAD_DIMS}; got "
            f"{tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}, "
            f"{tuple(v.shape)} {v.dtype}")
    q, k, v = _contiguous16(q), _contiguous16(k), _contiguous16(v)
    _check("flash_attention", q, k, v)
    from repro_torch.kernels.build import library
    out = torch.empty_like(q)
    fn = getattr(library("flash_attention"), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 Sq, Sk, KV, G, hd, int(bool(causal)), int(window), q_start,
                 hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

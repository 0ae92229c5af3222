"""The flash-attention prefill kernel, its wrapper and its plain version.

`flash_attention` replaces ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``): forward GQA attention over a whole
sequence, causal and/or sliding-window, with an online softmax over key
tiles, for f32 and bf16 inputs.  It is the attention core of
`repro_torch.models.transformer.Model.prefill`.

Bound on an H100: operations (about 2 S^2 hd flops per query head of a
causal prompt of S tokens, f32 on the CUDA cores, against 4 S hd bytes
per head of q, k, v and o).  The CUDA kernel (``csrc/flash_attention.cu``)
runs one CTA per (32-row query tile, query head, batch row) and walks the
key tiles a row can see, 64 at a time, skipping those past the causal
diagonal or before the window, where the TPU grid visits and masks every
key tile; scores stay in registers, k and v tiles in shared memory.

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
# the kernel's instantiations; its shared memory (174 KB at 256) fits all
_HEAD_DIMS = (32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd), all f32 or all bf16.
    Positions are absolute from 0 on both sides; ``causal`` masks keys
    after the query, ``window > 0`` keys ``window`` or more before it.
    Returns (B, Sq, KV, G, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
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
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
             Sk, KV, G, hd, int(bool(causal)), int(window), hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

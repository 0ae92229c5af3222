"""Plain PyTorch versions of the compression kernel (the port of
``repro/kernels/ref.py``'s ``select_ef_mean_ref``).

The update-tail kernels keep theirs beside them in
`repro_torch.kernels.dc_update`.
"""
from __future__ import annotations

from typing import Tuple

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

"""Iteration-dependent schedules (paper §IV-A), computed in float32.

Linear warm-up to ``warmup_steps``, then linear decay to zero at
``total_steps`` — for both the learning rate and (scaled by k=2.3) the
weight decay.  The arithmetic is float32, op for op as the reference's
jnp version, so both packages step with the same rates; the result comes
back as a Python float (exactly the float32 value) because the step
counter lives on the host.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def linear_warmup_linear_decay(step: int, *, peak: float, warmup_steps: int,
                               total_steps: int) -> float:
    s = _f32(step)
    if step < warmup_steps:
        return float(_f32(peak) * s / _f32(max(warmup_steps, 1)))
    span = _f32(max(total_steps - warmup_steps, 1))
    return float(_f32(peak) * max(_f32(total_steps) - s, _f32(0.0)) / span)


def theoretical_lr(eta_single_node: float, n_workers: int) -> float:
    """Paper Eq. 16: eta_theo = N * eta_sn (linear scaling rule)."""
    return eta_single_node * n_workers

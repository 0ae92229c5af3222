"""Pluggable delay compensators (`repro_torch.core.api.Compensator`).

``dc`` is the DC-ASGD pseudo-Hessian correction with Eq. 17 variance
control (`repro_torch.core.correction.dc_correct`); ``none`` is the exact
identity (the uncompensated "stale" baseline).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import registry
from repro_torch.core.correction import dc_correct

Tree = Any


@registry.register(registry.COMPENSATOR, "dc")
class DelayCompensation:
    """g̃ = g + λ·g⊙g⊙D with λ = λ0·‖g‖/‖c‖ (paper Eq. 10 + 17)."""

    name = "dc"

    def __init__(self, cfg=None, *, lambda0: Optional[float] = None,
                 mode: Optional[str] = None):
        self.lambda0 = lambda0 if lambda0 is not None else \
            (cfg.lambda0 if cfg is not None else 0.2)
        self.mode = mode if mode is not None else \
            (cfg.lambda_norm if cfg is not None else "global")

    def __call__(self, grads: Tree, distance: Tree, *,
                 axis0_is_worker: bool = False) -> Tuple[Tree, torch.Tensor]:
        return dc_correct(grads, distance, self.lambda0, mode=self.mode,
                          axis0_is_worker=axis0_is_worker)


@registry.register(registry.COMPENSATOR, "none")
class NoCompensation(DelayCompensation):
    """λ0 = 0: exact identity on the gradients (`dc_correct` shortcuts)."""

    name = "none"

    def __init__(self, cfg=None):
        super().__init__(cfg, lambda0=0.0)

"""Local optimizer U(g, eta, mu) used inside DC-S3GD (the port of
``repro.optim.local``'s momentum SGD; Nesterov, LARS and Adam are queued).

Returns the *update* ``delta_w`` plus the new slots, so it composes with
the DC-S3GD step (Eq. 11: Δw_i = U(g̃_i, η, μ)).  Weight decay is
decoupled and scheduled, and masked off rank-1 leaves (the paper exempts
normalisation parameters).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import Schedules

Tree = Any


def _decay_mask(params: Tree, axis0_is_worker: bool = False) -> Tree:
    """1.0 on leaves that get weight decay (canonical rank > 1).

    ``axis0_is_worker``: the tree carries a leading worker axis, so rank
    is judged on the per-worker shape.  With the stacked-layer layout a
    layer's norm scales are (L, d) — rank 2 per worker — and so are
    decayed, as in the reference; only ``final_norm`` is not."""
    rank0 = 2 if axis0_is_worker else 1
    return T.map(lambda p: 1.0 if p.dim() > rank0 else 0.0, params)


def momentum_update(grads: Tree, state: Tree, params: Tree, *, lr: float,
                    momentum: float, weight_decay: float,
                    nesterov: bool = False, axis0_is_worker: bool = False
                    ) -> Tuple[Tree, Tree]:
    """Returns (delta_w, new_state)."""
    mask = T.leaves(_decay_mask(params, axis0_is_worker))
    gl, treedef = T.flatten(grads)
    deltas, slots = [], []
    for g, m, p, msk in zip(gl, T.leaves(state["m"]), T.leaves(params),
                            mask):
        g32 = g.float() + (weight_decay * msk) * p.float()
        m_new = momentum * m + g32
        step_dir = g32 + momentum * m_new if nesterov else m_new
        deltas.append((-lr * step_dir).to(p.dtype))
        slots.append(m_new)
    return T.unflatten(treedef, deltas), {"m": T.unflatten(treedef, slots)}


@registry.register(registry.LOCAL_OPTIMIZER, "momentum")
class Momentum:
    """Momentum SGD (paper §IV-A); honours ``cfg.nesterov``."""

    name = "momentum"

    def __init__(self, cfg=None, *, momentum: float | None = None,
                 nesterov: bool | None = None):
        self.momentum = momentum if momentum is not None else \
            (cfg.momentum if cfg is not None else 0.9)
        self.nesterov = nesterov if nesterov is not None else \
            bool(getattr(cfg, "nesterov", False))

    def init(self, params: Tree) -> Tree:
        return {"m": T.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}

    def __call__(self, grads: Tree, slots: Tree, params: Tree,
                 schedules: Schedules, *, axis0_is_worker: bool = False
                 ) -> Tuple[Tree, Tree]:
        return momentum_update(grads, slots, params, lr=schedules["lr"],
                               momentum=self.momentum,
                               weight_decay=schedules["weight_decay"],
                               nesterov=self.nesterov,
                               axis0_is_worker=axis0_is_worker)


def from_config(cfg) -> Any:
    """The `LocalOptimizer` a `DCS3GDConfig` names (``cfg.local_optimizer``)."""
    return registry.make_local_optimizer(cfg.local_optimizer, cfg)

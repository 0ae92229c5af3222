"""Local optimizers U(g, eta, mu) used inside DC-S3GD / SSGD (the port of
``repro.optim.local``).

The paper uses momentum SGD (with the decoupled, scheduled weight decay of
§IV-A); Nesterov, LARS and Adam are the §V extensions.  Each returns the
*update* ``delta_w`` plus the new slots, so it composes with the DC-S3GD
step (Eq. 11: Δw_i = U(g̃_i, η, μ)).  Weight decay is masked off rank-1
leaves (the paper exempts normalisation parameters).

``axis0_is_worker``: the tree carries a leading worker axis.  Rank is
then judged per worker, and LARS takes its trust-ratio norms per worker
(over axes 1...).  The reference's ``lars_update`` takes them over the
whole (W, ...)-stacked leaf, so its ratio mixes every worker's norms — a
cross-worker reduction inside a local optimizer, which the decentralised
algorithm has no wire for; the port keeps each worker's own.
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


def _norm(x: torch.Tensor, axis0_is_worker: bool) -> torch.Tensor:
    """Euclidean norm of a leaf: per worker (keepdims, (W, 1, ...)) when
    ``axis0_is_worker``, else a scalar.  A (W,) leaf of 0-d tensors is
    its own per-worker norm's argument: |x| (torch would sum over every
    axis for an empty axis list)."""
    if not axis0_is_worker:
        return x.square().sum().sqrt()
    if x.dim() == 1:
        return x.abs()
    return x.square().sum(dim=tuple(range(1, x.dim())), keepdim=True).sqrt()


def init_local_state(params: Tree, optimizer: str = "momentum") -> Tree:
    """Zeroed slots: ``{"m"}``, and for Adam ``{"m", "v", "t"}`` with ``t``
    a 0-d int32 step count on the params' device."""
    zeros = T.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    if optimizer == "adam":
        return {"m": zeros, "v": T.map(torch.zeros_like, zeros),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=T.leaves(params)[0].device)}
    return {"m": zeros}


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


def lars_update(grads: Tree, state: Tree, params: Tree, *, lr: float,
                momentum: float, weight_decay: float, trust: float = 0.001,
                axis0_is_worker: bool = False, **_) -> Tuple[Tree, Tree]:
    """LARS (You et al. 2017) — paper §V suggested local optimizer.  The
    trust ratio ``trust·‖w‖/‖g‖`` is per worker under ``axis0_is_worker``
    (see the module docstring)."""
    mask = T.leaves(_decay_mask(params, axis0_is_worker))
    gl, treedef = T.flatten(grads)
    deltas, slots = [], []
    for g, m, p, msk in zip(gl, T.leaves(state["m"]), T.leaves(params),
                            mask):
        g32 = g.float() + (weight_decay * msk) * p.float()
        w_norm = _norm(p.float(), axis0_is_worker)
        g_norm = _norm(g32, axis0_is_worker)
        ratio = torch.where((w_norm > 0) & (g_norm > 0),
                            trust * w_norm / (g_norm + 1e-9),
                            torch.ones_like(w_norm))
        m_new = momentum * m + ratio * g32
        deltas.append((-lr * m_new).to(p.dtype))
        slots.append(m_new)
    return T.unflatten(treedef, deltas), {"m": T.unflatten(treedef, slots)}


def adam_update(grads: Tree, state: Tree, params: Tree, *, lr: float,
                weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, axis0_is_worker: bool = False,
                **_) -> Tuple[Tree, Tree]:
    """AdamW-style local optimizer — paper §V suggested alternative.  The
    bias corrections come from the on-device step count ``t``."""
    mask = T.leaves(_decay_mask(params, axis0_is_worker))
    t = state["t"] + 1
    tf = t.float()
    bc1 = 1.0 - torch.pow(torch.full_like(tf, b1), tf)
    bc2 = 1.0 - torch.pow(torch.full_like(tf, b2), tf)
    gl, treedef = T.flatten(grads)
    deltas, ms, vs = [], [], []
    for g, m, v, p, msk in zip(gl, T.leaves(state["m"]), T.leaves(state["v"]),
                               T.leaves(params), mask):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32.square()
        step = (m_new / bc1) / ((v_new / bc2).sqrt() + eps)
        step = step + (weight_decay * msk) * p.float()
        deltas.append((-lr * step).to(p.dtype))
        ms.append(m_new)
        vs.append(v_new)
    return T.unflatten(treedef, deltas), {"m": T.unflatten(treedef, ms),
                                          "v": T.unflatten(treedef, vs),
                                          "t": t}


def local_update(name: str):
    return {"momentum": momentum_update, "lars": lars_update,
            "adam": adam_update}[name]


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
        return init_local_state(params, "momentum")

    def __call__(self, grads: Tree, slots: Tree, params: Tree,
                 schedules: Schedules, *, axis0_is_worker: bool = False
                 ) -> Tuple[Tree, Tree]:
        return momentum_update(grads, slots, params, lr=schedules["lr"],
                               momentum=self.momentum,
                               weight_decay=schedules["weight_decay"],
                               nesterov=self.nesterov,
                               axis0_is_worker=axis0_is_worker)


@registry.register(registry.LOCAL_OPTIMIZER, "nesterov")
class Nesterov(Momentum):
    """Nesterov-momentum variant of the same update."""

    name = "nesterov"

    def __init__(self, cfg=None, *, momentum: float | None = None):
        super().__init__(cfg, momentum=momentum, nesterov=True)


@registry.register(registry.LOCAL_OPTIMIZER, "lars")
class LARS:
    """LARS (You et al. 2017) — paper §V suggested local optimizer."""

    name = "lars"

    def __init__(self, cfg=None, *, momentum: float | None = None,
                 trust: float = 0.001):
        self.momentum = momentum if momentum is not None else \
            (cfg.momentum if cfg is not None else 0.9)
        self.trust = trust

    def init(self, params: Tree) -> Tree:
        return init_local_state(params, "momentum")

    def __call__(self, grads: Tree, slots: Tree, params: Tree,
                 schedules: Schedules, *, axis0_is_worker: bool = False
                 ) -> Tuple[Tree, Tree]:
        return lars_update(grads, slots, params, lr=schedules["lr"],
                           momentum=self.momentum,
                           weight_decay=schedules["weight_decay"],
                           trust=self.trust, axis0_is_worker=axis0_is_worker)


@registry.register(registry.LOCAL_OPTIMIZER, "adam")
class Adam:
    """AdamW-style local optimizer — paper §V suggested alternative."""

    name = "adam"

    def __init__(self, cfg=None, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> Tree:
        return init_local_state(params, "adam")

    def __call__(self, grads: Tree, slots: Tree, params: Tree,
                 schedules: Schedules, *, axis0_is_worker: bool = False
                 ) -> Tuple[Tree, Tree]:
        return adam_update(grads, slots, params, lr=schedules["lr"],
                           weight_decay=schedules["weight_decay"],
                           b1=self.b1, b2=self.b2, eps=self.eps,
                           axis0_is_worker=axis0_is_worker)


def from_config(cfg) -> Any:
    """The `LocalOptimizer` a `DCS3GDConfig` names (``cfg.local_optimizer``)."""
    return registry.make_local_optimizer(cfg.local_optimizer, cfg)

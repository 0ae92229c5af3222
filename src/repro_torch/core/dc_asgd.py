"""DC-ASGD baseline (Zheng et al. 2016) — centralized parameter-server
asynchronous SGD with delay compensation (the port of
``repro.core.dc_asgd``).

The paper compares against this (§III-D.2): with a parameter server the
staleness distance ``w_PS − w_i`` grows ∝ N, while DC-S3GD's
distance-to-average grows more slowly.  `DCASGD` is an event-accurate
sequential simulation of it: N logical workers finish in round-robin
order (the average-staleness-N regime), one PS copy.

State: ``params`` is the PS copy, ``comm["worker_params"]`` the (W, ...)
stale worker copies.  :meth:`DCASGD.step` takes the same (W, b, ...)
batch as the other algorithms and performs ONE PS transaction for worker
``step mod W`` — a host int, so choosing it reads nothing from the
device.  It shares the `Compensator` and `LocalOptimizer` pieces with
DC-S3GD.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import LossFn, Metrics, TrainState
from repro_torch.core.types import DCS3GDConfig
from repro_torch.optim import local as local_opt

Tree = Any


@registry.register(registry.ALGORITHM, "dc_asgd")
class DCASGD:
    """PS-asynchronous baseline through the protocol (round-robin sim)."""

    name = "dc_asgd"

    def __init__(self, cfg: DCS3GDConfig, *, n_workers: int = 1,
                 local_optimizer=None, compensator=None, **_ignored):
        self.cfg = cfg
        self.n_workers = n_workers
        self.local_optimizer = (
            local_opt.from_config(cfg) if local_optimizer is None
            else registry.make_local_optimizer(local_optimizer, cfg))
        self.compensator = registry.make_compensator(
            "dc" if compensator is None else compensator, cfg)

    def init(self, params: Tree) -> TrainState:
        wp = T.map(lambda p: p.unsqueeze(0).expand(
            (self.n_workers,) + p.shape).contiguous(), params)
        return TrainState(params=params,
                          opt=self.local_optimizer.init(params),
                          comm={"worker_params": wp}, step=0)

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        """One PS transaction for worker ``state.step mod W``, fed that
        worker's (b, ...) shard of the stacked batch (the other shards
        are not used)."""
        wid = state.step % self.n_workers
        return self._transaction(state, wid, T.map(lambda x: x[wid], batch),
                                 loss_fn=loss_fn)

    def _transaction(self, state: TrainState, wid: int, batch_i: Tree, *,
                     loss_fn: LossFn) -> Tuple[TrainState, Metrics]:
        """Worker ``wid`` submits a gradient computed at its stale copy;
        the PS applies the (delay-compensated) update and sends fresh
        weights back to that worker only."""
        cfg = self.cfg
        worker_params = state.comm["worker_params"]
        leaves, treedef = T.flatten(worker_params)
        w_i = [x[wid].detach().requires_grad_() for x in leaves]
        loss = loss_fn(T.unflatten(treedef, w_i), batch_i)
        g = T.unflatten(treedef, list(torch.autograd.grad(loss, w_i)))
        w_i = T.unflatten(treedef, [x.detach() for x in w_i])

        # DC-ASGD Eq. 6: correct toward the PS copy
        D = T.map(lambda ps, wi: ps.float() - wi.float(), state.params, w_i)
        g, lam = self.compensator(g, D)

        lr = float(np.float32(cfg.learning_rate))
        wd = float(np.float32(cfg.weight_decay))
        delta, opt = self.local_optimizer(g, state.opt, state.params,
                                          {"lr": lr, "weight_decay": wd})
        new_ps = T.map(lambda w, dw: (w.float() + dw.float()).to(w.dtype),
                       state.params, delta)

        def receive(wp, ps):
            out = wp.clone()
            out[wid] = ps.to(wp.dtype)
            return out

        new_workers = T.map(receive, worker_params, new_ps)
        if isinstance(lam, torch.Tensor):
            lam_metric = lam.float().mean()
        else:   # per-tensor λ: the mean of the leaves' λ
            lam_metric = torch.stack([v.mean() for v in T.leaves(lam)]).mean()
        metrics = {"loss": loss.detach(), "lr": lr, "wd": wd,
                   "lambda": lam_metric,
                   "staleness_dist": _dist(new_ps, w_i)}
        return TrainState(new_ps, opt, {"worker_params": new_workers},
                          state.step + 1), metrics

    def eval_params(self, state: TrainState) -> Tree:
        return state.params


def _dist(a: Tree, b: Tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() - y.float()).square().sum()
                          for x, y in zip(T.leaves(a), T.leaves(b))))

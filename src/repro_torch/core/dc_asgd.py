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

On a mesh (`bind_workers`) the state is replicated and the batch rows
are split over the ranks: the transaction runs on the rank that holds
worker ``step mod W``'s row (a host int picks it), which then broadcasts
the new PS copy, the optimizer state and the metrics; every rank writes
that worker's stale copy from the broadcast PS copy.  Each rank then
holds bitwise the one-process state.  Over a 'model' axis
(`bind_model_axis`) each rank holds its shards of the PS copy, the
optimizer state and the stale copies; the transaction's norms sum the
shards over the axis, and the broadcast stays within the worker group of
the rank's 'model' coordinate.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import LossFn, Metrics, TrainState
from repro_torch.core.reduce import LOCAL
from repro_torch.core.types import DCS3GDConfig
from repro_torch.optim import local as local_opt
from repro_torch.parallel.tensor import norm_helpers

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
        self.workers = LOCAL
        # the 'model' axis and the model's config (`bind_model_axis`)
        self.model_axis = None
        self._model_cfg = None

    def bind_workers(self, workers) -> None:
        """Split the batch rows over ``workers``' ranks: each transaction
        runs where its worker's row is, and the result is broadcast."""
        self.workers = workers

    def bind_model_axis(self, axis, model_cfg) -> None:
        """Hold this rank's shards over ``axis`` (a `repro_torch.parallel.
        tensor.ModelAxis`) of the leaves the partition rules for
        ``model_cfg`` shard over 'model': every norm of a transaction
        (Eq. 17's, LARS's, the staleness distance) sums the shards'
        partials over the axis, and the owner's broadcast runs within
        the worker group of this rank's 'model' coordinate."""
        self.model_axis = axis
        self._model_cfg = model_cfg

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
        wk = self.workers
        if not wk.distributed:
            return self._transaction(state, wid,
                                     T.map(lambda x: x[wid], batch),
                                     loss_fn=loss_fn)
        rows = wk.rows(self.n_workers)
        owner = wid // rows
        if wk.rank == owner:
            new, metrics = self._transaction(
                state, wid, T.map(lambda x: x[wid - owner * rows], batch),
                loss_fn=loss_fn)
            ps, opt = new.params, new.opt
            scalars = torch.stack([metrics[k].float().reshape(())
                                   for k in _BROADCAST])
        else:
            ps = T.map(torch.empty_like, state.params)
            opt = T.map(torch.empty_like, state.opt)
            scalars = torch.empty(len(_BROADCAST), dtype=torch.float32,
                                  device=T.leaves(state.params)[0].device)
        wk.broadcast_from(T.leaves(ps) + T.leaves(opt) + [scalars], owner)
        if wk.rank != owner:
            # the PS sends its fresh weights back to that worker only
            new = TrainState(ps, opt, {"worker_params": T.map(
                lambda wp, p: _receive(wp, p, wid),
                state.comm["worker_params"], ps)}, state.step + 1)
        lr, wd = _rates(self.cfg)
        return new, {"loss": scalars[0], "lr": lr, "wd": wd,
                     "lambda": scalars[1], "staleness_dist": scalars[2]}

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
        g = T.unflatten(treedef, list(torch.autograd.grad(
            loss, w_i, materialize_grads=True)))
        w_i = T.unflatten(treedef, [x.detach() for x in w_i])

        # DC-ASGD Eq. 6: correct toward the PS copy
        D = T.map(lambda ps, wi: ps.float() - wi.float(), state.params, w_i)
        sum_sq, leaf_sums = norm_helpers(self.model_axis,
                                          self._model_cfg, state.params)
        g, lam = self.compensator(g, D, sum_sq=sum_sq, leaf_sums=leaf_sums)

        lr, wd = _rates(cfg)
        delta, opt = self.local_optimizer(g, state.opt, state.params,
                                          {"lr": lr, "weight_decay": wd},
                                          leaf_sums=leaf_sums)
        new_ps = T.map(lambda w, dw: (w.float() + dw.float()).to(w.dtype),
                       state.params, delta)
        new_workers = T.map(lambda wp, ps: _receive(wp, ps, wid),
                            worker_params, new_ps)
        if isinstance(lam, torch.Tensor):
            lam_metric = lam.float().mean()
        else:   # per-tensor λ: the mean of the leaves' λ
            lam_metric = torch.stack([v.mean() for v in T.leaves(lam)]).mean()
        metrics = {"loss": loss.detach(), "lr": lr, "wd": wd,
                   "lambda": lam_metric,
                   "staleness_dist": _dist(new_ps, w_i, sum_sq)}
        return TrainState(new_ps, opt, {"worker_params": new_workers},
                          state.step + 1), metrics

    # -- sharding hooks -----------------------------------------------------

    def state_specs(self, model_cfg, state: TrainState, axes) -> TrainState:
        """Centralized simulator: everything replicated over workers; the
        PS copy is canonical and the (W, ...) stale worker copies keep a
        plain (unsharded) leading dim."""
        from repro_torch.parallel import sharding as shd
        return shd.train_state_specs(model_cfg, state,
                                     model_size=axes.model_size,
                                     worker_axes=None)

    def batch_specs(self, model_cfg, batch: Tree, axes) -> Tree:
        from repro_torch.parallel import sharding as shd
        return shd.batch_specs(model_cfg, batch,
                               worker_axes=axes.worker_spec)

    def eval_params(self, state: TrainState) -> Tree:
        return state.params


# the device metrics the transaction's rank broadcasts, in this order
_BROADCAST = ("loss", "lambda", "staleness_dist")


def _rates(cfg: DCS3GDConfig):
    """(lr, wd): the constant rates, f32 values as host floats."""
    return (float(np.float32(cfg.learning_rate)),
            float(np.float32(cfg.weight_decay)))


def _receive(wp: torch.Tensor, ps: torch.Tensor, wid: int) -> torch.Tensor:
    """The stale copies with worker ``wid``'s replaced by the PS copy."""
    out = wp.clone()
    out[wid] = ps.to(wp.dtype)
    return out


def _dist(a: Tree, b: Tree, sum_sq) -> torch.Tensor:
    """‖a − b‖ over the tree; ``sum_sq`` adds up the per-leaf squares
    (over the model axis for the sharded leaves, `norm_helpers`)."""
    return torch.sqrt(sum_sq([((x.float() - y.float()).square().sum(),)
                              for x, y in zip(T.leaves(a),
                                              T.leaves(b))])[0])

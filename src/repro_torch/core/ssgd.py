"""Synchronous SGD baseline (paper §II-A "decentralized synchronous"; the
port of ``repro.core.ssgd``).

Identical weights on every worker; the gradient all-reduce is on the
critical path (the update depends on *this* step's gradients), so the step
time is t_C + t_ARed (paper Eq. 13), the thing DC-S3GD removes.

`SSGD` composes the same `LocalOptimizer` / `Reducer` pieces as DC-S3GD
over the generic `TrainState`, with no worker axis on params and opt.
``comm`` is empty, or holds a compressed reducer's state under
``comm["reducer"]`` (per-worker residuals, worker axis first).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import LossFn, Metrics, TrainState
from repro_torch.core.dc_s3gd import _vgrads, schedules
from repro_torch.core.reduce import collapse_worker_axis
from repro_torch.core.types import DCS3GDConfig
from repro_torch.optim import local as local_opt

Tree = Any


@registry.register(registry.ALGORITHM, "ssgd")
class SSGD:
    """Synchronous data-parallel SGD through the protocol.

    ``batch`` leaves are (W, per_worker_batch, ...) as for DC-S3GD, but
    params are shared: grads go through the `Reducer` *before* the update
    (the blocking all-reduce).  ``use_kernels`` routes a topk /
    topk_exact reducer's compression body through its kernel."""

    name = "ssgd"

    def __init__(self, cfg: DCS3GDConfig, *, n_workers: int = 1,
                 local_optimizer=None, reducer=None,
                 buckets: Optional[int] = None, use_kernels: bool = False,
                 overlap: bool = False, **_ignored):
        if overlap:
            raise ValueError(
                "overlap=True is not available for ssgd: the gradient "
                "all-reduce is blocking by definition (the update depends "
                "on THIS step's gradients, paper Eq. 13).  Overlap is "
                "what dc_s3gd/stale buy with the one-step-stale wire")
        self.cfg = cfg
        self.n_workers = n_workers
        self.local_optimizer = (
            local_opt.from_config(cfg) if local_optimizer is None
            else registry.make_local_optimizer(local_optimizer, cfg))
        self.reducer = registry.make_reducer(
            "mean_allreduce" if reducer is None else reducer, cfg)
        self.use_kernels = bool(use_kernels)
        if use_kernels and hasattr(self.reducer, "use_kernels"):
            self.reducer.use_kernels = True
        # flat-buffer bucketing of the gradient all-reduce: >0 packs grads
        # into contiguous buckets, one cast+reduce per bucket
        self.buckets = int(cfg.buckets if buckets is None else buckets)
        self._plan_cache: dict = {}

    def _plan(self, params: Tree):
        from repro_torch.parallel import buckets as B
        return B.cached_plan(self._plan_cache, params, self.buckets)

    @property
    def _reducer_stateless(self) -> bool:
        return bool(getattr(self.reducer, "stateless", True))

    def init(self, params: Tree) -> TrainState:
        comm = {}
        # error-feedback compressed reducers carry per-worker residuals
        # across steps in comm["reducer"], the same seam as DC-S3GD
        if not self._reducer_stateless:
            comm["reducer"] = self.reducer.init(
                self.n_workers, self._plan(params) if self.buckets else None,
                device=T.leaves(params)[0].device)
        return TrainState(params=params,
                          opt=self.local_optimizer.init(params),
                          comm=comm, step=0)

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        lr, wd = schedules(state.step, self.cfg)
        W = T.leaves(batch)[0].shape[0]
        # per-worker gradients of the one shared copy of the weights
        shared = T.map(lambda p: p.unsqueeze(0).expand((W,) + p.shape),
                       state.params)
        grads, loss = _vgrads(loss_fn, shared, batch)
        g32 = T.map(lambda g: g.float(), grads)
        del grads
        # blocking all-reduce over workers, on the critical path;
        # collapse_worker_axis folds the reducer's (1, ...) output back to
        # canonical shapes
        comm = {}
        if self.buckets:
            plan = self._plan(state.params)
            wire = plan.pack(g32)
            if self._reducer_stateless:
                red = self.reducer(wire)
            else:
                red, comm["reducer"] = self.reducer(wire,
                                                    state.comm["reducer"])
            reduced = plan.unpack(collapse_worker_axis(red))
        else:
            if not self._reducer_stateless:
                raise ValueError(
                    f"reducer {self.reducer.name!r} needs the bucketed "
                    f"wire: construct with buckets > 0")
            reduced = collapse_worker_axis(self.reducer(g32))
        delta, opt = self.local_optimizer(reduced, state.opt, state.params,
                                          {"lr": lr, "weight_decay": wd})
        new_params = T.map(
            lambda w, dw: (w.float() + dw.float()).to(w.dtype),
            state.params, delta)
        return (TrainState(new_params, opt, comm, state.step + 1),
                {"loss": loss.mean(), "lr": lr, "wd": wd})

    def eval_params(self, state: TrainState) -> Tree:
        return state.params

    def resize_state(self, state: TrainState, n_new: int) -> TrainState:
        """Elastic resize: params and opt are shared (already the
        consensus, so ``eval_params`` is unchanged); only a stateful
        reducer's per-worker residuals carry a worker axis, and they go
        through the reducer's own ``resize`` (mass-conserving)."""
        comm = dict(state.comm)
        if "reducer" in comm:
            comm["reducer"] = self.reducer.resize(comm["reducer"],
                                                  int(n_new))
        return state._replace(comm=comm)

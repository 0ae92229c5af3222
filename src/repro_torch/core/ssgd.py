"""Synchronous SGD baseline (paper §II-A "decentralized synchronous"; the
port of ``repro.core.ssgd``).

Identical weights on every worker; the gradient all-reduce is on the
critical path (the update depends on *this* step's gradients), so the step
time is t_C + t_ARed (paper Eq. 13), the thing DC-S3GD removes.

`SSGD` composes the same `LocalOptimizer` / `Reducer` pieces as DC-S3GD
over the generic `TrainState`, with no worker axis on params and opt.
``comm`` is empty, or holds a compressed reducer's state under
``comm["reducer"]`` (per-worker residuals, worker axis first).  On a
mesh (`bind_workers`) every rank holds the shared params and W / R rows
of the batch; the gradient mean runs over the worker process group (a
weight-mixing reducer's rows are averaged over every rank's).
Under tensor parallelism (`bind_model_axis`) the params are the rank's
shards over the mesh's 'model' axis: the shards go through the same
gradient mean as whole leaves, and LARS's per-leaf norms sum them over
the axis.  A compressed wire or a quantized ``comm_dtype`` reduces the
whole buckets (leaves) instead, gathered over the axis and cut back
after the reduce (`repro_torch.parallel.tensor.WholeWire`), its
``comm["reducer"]`` in the whole plan's layout, as DC-S3GD's.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import LossFn, Metrics, TrainState
from repro_torch.core.dc_s3gd import _vgrads, schedules
from repro_torch.core.reduce import (LOCAL, collapse_worker_axis,
                                     layout_bound)
from repro_torch.core.types import DCS3GDConfig
from repro_torch.instrument import scope
from repro_torch.optim import local as local_opt
from repro_torch.parallel.tensor import norm_helpers, whole_wire

Tree = Any


@registry.register(registry.ALGORITHM, "ssgd")
class SSGD:
    """Synchronous data-parallel SGD through the protocol.

    ``batch`` leaves are (W, per_worker_batch, ...) as for DC-S3GD, but
    params are shared: grads go through the `Reducer` *before* the update
    (the blocking all-reduce).  ``use_kernels`` routes a topk /
    topk_exact reducer's compression body through its kernel."""

    name = "ssgd"
    # one shared copy of the params (no worker axis)
    worker_stacked = False

    def __init__(self, cfg: DCS3GDConfig, *, n_workers: int = 1,
                 local_optimizer=None, reducer=None,
                 buckets: Optional[int] = None, use_kernels: bool = False,
                 overlap: bool = False, plan_block: Optional[int] = None,
                 **_ignored):
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
        # bucket padding granularity (the autotuner's knob; None = BLOCK)
        self.plan_block = None if plan_block is None else int(plan_block)
        self._plan_cache: dict = {}
        self._wire_cache: dict = {}
        self.workers = LOCAL
        self.model_axis = None
        self._model_cfg = None

    def bind_workers(self, workers) -> None:
        """Run the worker axis (the batch's rows) over ``workers``: the
        gradient mean and the loss metric reduce over every rank."""
        self.workers = workers
        if hasattr(self.reducer, "workers"):
            self.reducer.workers = workers

    def bind_model_axis(self, axis, model_cfg) -> None:
        """Hold this rank's shards over ``axis``: the model's own
        collectives carry the axis; LARS's per-leaf norms, the step's
        only norms, sum their shards over it."""
        self.model_axis = axis
        self._model_cfg = model_cfg

    def _plan(self, params: Tree):
        from repro_torch.parallel import buckets as B
        return B.cached_plan(self._plan_cache, params, self.buckets,
                             block=self.plan_block,
                             wire_dtype=getattr(self.reducer, "comm_dtype",
                                                None))

    def _whole_wire(self, params: Tree):
        """The `WholeWire` of the params' layout when the gradient wire
        reduces the whole buckets (leaves) over the 'model' axis
        (`layout_bound`); else None."""
        if self.model_axis is None or not layout_bound(self.reducer):
            return None
        key = tuple((tuple(x.shape), x.dtype) for x in T.leaves(params))
        if key not in self._wire_cache:
            self._wire_cache[key] = whole_wire(
                self.model_axis, self._model_cfg, params, lead=0,
                local=self._plan(params) if self.buckets else None,
                plan_of=self._plan)
        return self._wire_cache[key]

    def reducer_plan(self, params: Tree):
        """The bucket plan of the reducer's wire and carried state: the
        whole tree's under `_whole_wire`, else this rank's (None without
        buckets)."""
        if not self.buckets:
            return None
        wire = self._whole_wire(params)
        return wire.whole if wire is not None else self._plan(params)

    @property
    def _reducer_stateless(self) -> bool:
        return bool(getattr(self.reducer, "stateless", True))

    def init(self, params: Tree) -> TrainState:
        comm = {}
        # error-feedback compressed reducers carry per-worker residuals
        # across steps in comm["reducer"], the same seam as DC-S3GD
        if not self._reducer_stateless:
            comm["reducer"] = self.reducer.init(
                self.n_workers, self.reducer_plan(params),
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
        with scope("model"):
            grads, loss = _vgrads(loss_fn, shared, batch)
        g32 = T.map(lambda g: g.float(), grads)
        del grads
        # blocking all-reduce over workers, on the critical path;
        # collapse_worker_axis folds the reducer's (1, ...) output back to
        # canonical shapes (the mean of a weight-mixing reducer's rows)
        comm = {}
        wk = self.workers if getattr(self.reducer, "reduces_weights", False) \
            else LOCAL
        # over 'model', the whole buckets (leaves) the reduce runs over
        whole = self._whole_wire(state.params)
        if self.buckets:
            plan = self._plan(state.params)
            wire = plan.pack(g32)
        else:
            if not self._reducer_stateless:
                raise ValueError(
                    f"reducer {self.reducer.name!r} needs the bucketed "
                    f"wire: construct with buckets > 0")
            wire = g32
        if whole is not None:
            wire = whole.gather(wire)
        # the `wire` scope marks the simulated wire in an op trace
        with scope("wire"):
            if self._reducer_stateless:
                red = self.reducer(wire)
            else:
                red, comm["reducer"] = self.reducer(
                    wire, state.comm["reducer"])
        del wire
        if whole is not None:
            red = whole.scatter(red)
        reduced = collapse_worker_axis(red, wk)
        if self.buckets:
            reduced = plan.unpack(reduced)
        delta, opt = self.local_optimizer(
            reduced, state.opt, state.params, {"lr": lr, "weight_decay": wd},
            leaf_sums=norm_helpers(self.model_axis, self._model_cfg,
                                   state.params)[1])
        new_params = T.map(
            lambda w, dw: (w.float() + dw.float()).to(w.dtype),
            state.params, delta)
        return (TrainState(new_params, opt, comm, state.step + 1),
                {"loss": self.workers.means({"loss": loss})["loss"],
                 "lr": lr, "wd": wd})

    def eval_params(self, state: TrainState) -> Tree:
        """The shared params (None on a rank outside the mesh)."""
        return state.params if self.workers.holds else None

    # -- sharding hooks -----------------------------------------------------

    def state_specs(self, model_cfg, state: TrainState, axes) -> TrainState:
        """Replicated over workers: canonical param layout, no worker axis
        on any state leaf, except a stateful reducer's per-worker
        residuals, which lead with the worker axes."""
        from repro_torch.parallel import sharding as shd
        overrides = {}
        if "reducer" in state.comm:
            # the reducer's own buckets (the whole plan's over 'model')
            from repro_torch.parallel.buckets import BucketSizes
            overrides["reducer"] = self.reducer.state_specs(
                axes, BucketSizes.of(state.comm["reducer"]["residual"]))
        return shd.train_state_specs(model_cfg, state,
                                     model_size=axes.model_size,
                                     worker_axes=None,
                                     comm_overrides=overrides)

    def batch_specs(self, model_cfg, batch: Tree, axes) -> Tree:
        from repro_torch.parallel import sharding as shd
        return shd.batch_specs(model_cfg, batch,
                               worker_axes=axes.worker_spec)

    def resize_state(self, state: TrainState, n_new: int, *,
                     workers=None) -> TrainState:
        """Elastic resize: params and opt are shared (already the
        consensus, so ``eval_params`` is unchanged); only a stateful
        reducer's per-worker residuals carry a worker axis, and they go
        through the reducer's own ``resize`` (mass-conserving).
        ``workers``: the seam of the mesh that carries ``n_new``, as for
        `repro_torch.core.dc_s3gd.DCS3GD.resize_state` (every rank of the
        world calls it; the shared state and a worker's residual share
        reach the new mesh's ranks, ``self`` is bound to it, a rank outside
        it gets None)."""
        from repro_torch.core.reduce import check_rows, hand_over
        src = self.workers
        dst = src if workers is None else workers
        n_new = int(n_new)
        check_rows(n_new, dst)
        held = None
        if state is not None and src.holds:
            comm = dict(state.comm)
            if "reducer" in comm:
                comm["reducer"] = self.reducer.resize(comm["reducer"], n_new)
            held = state._replace(comm=comm)
        held = hand_over(held, src, dst)
        self.bind_workers(dst)
        if held is None or "reducer" not in held.comm:
            return held
        rows = dst.rows(n_new)
        red = dict(held.comm["reducer"])
        red["residual"] = [r.expand((rows,) + r.shape[1:]).contiguous()
                           for r in red["residual"]]
        return held._replace(comm={**held.comm, "reducer": red})

"""DC-S3GD — the paper's contribution (Algorithm 1), in PyTorch.

Decentralized stale-synchronous SGD with delay compensation:

* every worker keeps its own weights ``w_i`` — a leading worker axis W on
  every parameter/optimizer leaf, all W workers in one process;
* the all-reduce of the *previous* update ``Δw^{t-1}`` is the pluggable
  `Reducer` applied to the carried ``delta_prev``; it does not depend on
  this step's gradients;
* the staleness error is compensated by the pluggable `Compensator`
  (Eq. 10 + 17), and weights move to the average while applying the
  corrected local update (Eq. 12).

``use_kernels=True`` runs the correction + momentum + Eq. 12 tail through
the two hand-written CUDA kernels (`repro_torch.kernels`), and a topk /
topk_exact reducer's compression body through a third; on CPU tensors
the same calls run their plain versions.  ``buckets > 0`` packs the wire
state and the fused tail into a few flat buffers
(`repro_torch.parallel.buckets`); within the port the bucketed and
per-leaf trajectories are bitwise equal.  A stateful (compressed) reducer
carries its state in ``comm["reducer"]`` and needs ``buckets > 0``.

A weight-mixing reducer (``gossip``, ``hierarchical``: ``reduces_weights``)
mixes the carried weights instead of the deltas (D-PSGD), D = R(w) − w,
and carries no ``delta_prev``.  A stateful staleness policy
(``dynamic_ssp``) keeps its counters in ``comm["staleness"]`` on the host,
so its admit decision is a host branch and costs no device read; a
revoked window replaces D by a blocking pull to the plain worker mean.

The reference fences the wire and D with ``lax.optimization_barrier`` so
XLA cannot fuse across them; eager PyTorch materialises every tensor, so
the port needs no counterpart.  ``overlap=True`` runs the double-buffered
bucket pipeline (`repro_torch.parallel.pipeline`): each step's reduce is
issued at its end and consumed at the top of the next, bitwise the
inline schedule.  ``resize_state`` reshards the carried state to another
worker count (elastic membership, `repro_torch.cluster`).

The first iteration of Algorithm 1 (the plain step before the loop) is
``delta_prev = 0``: then D = 0, λ = 0 and the step is plain momentum SGD.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.api import LossFn, Metrics, TrainState
from repro_torch.core.correction import worker_sq_sum
from repro_torch.core.reduce import _row_sum
from repro_torch.core.types import DCS3GDConfig
from repro_torch.instrument import scope
from repro_torch.optim import local as local_opt
from repro_torch.optim.schedules import linear_warmup_linear_decay

Tree = object


def replicate_for_workers(params: Tree, n_workers: int) -> Tree:
    """w_i = w̄ for every worker (Algorithm 1 'Initialize')."""
    return T.map(lambda p: p.unsqueeze(0).expand((n_workers,) + p.shape)
                 .contiguous(), params)


def schedules(step: int, cfg: DCS3GDConfig) -> Tuple[float, float]:
    """(lr, wd) at ``step``, float32 arithmetic, as host floats."""
    lr = linear_warmup_linear_decay(step, peak=cfg.learning_rate,
                                    warmup_steps=cfg.warmup_steps,
                                    total_steps=cfg.total_steps) \
        if cfg.total_steps > 1 else float(np.float32(cfg.learning_rate))
    wd_peak = cfg.weight_decay_k * cfg.weight_decay
    if cfg.schedule_weight_decay and cfg.total_steps > 1:
        wd = linear_warmup_linear_decay(step, peak=wd_peak,
                                        warmup_steps=cfg.warmup_steps,
                                        total_steps=cfg.total_steps)
    else:
        wd = float(np.float32(wd_peak))
    return lr, wd


_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@registry.register(registry.ALGORITHM, "dc_s3gd")
class DCS3GD:
    """Algorithm 1 as a composition of protocol pieces.

    ``local_optimizer`` / ``reducer`` / ``compensator`` / ``staleness``
    accept a registered name or an object; defaults come from ``cfg``
    (momentum, mean all-reduce, Eq. 10+17 compensation, the fixed
    one-step window)."""

    name = "dc_s3gd"
    # params carry a leading worker axis (W, ...)
    worker_stacked = True

    def __init__(self, cfg: DCS3GDConfig, *, n_workers: int = 1,
                 local_optimizer=None, reducer=None, compensator=None,
                 staleness=None, use_kernels: bool = False,
                 buckets: Optional[int] = None,
                 overlap: Optional[bool] = None,
                 plan_block: Optional[int] = None):
        self.cfg = cfg
        self.n_workers = n_workers
        self.local_optimizer = (
            local_opt.from_config(cfg) if local_optimizer is None
            else registry.make_local_optimizer(local_optimizer, cfg))
        self.reducer = registry.make_reducer(
            "mean_allreduce" if reducer is None else reducer, cfg)
        self.compensator = registry.make_compensator(
            "dc" if compensator is None else compensator, cfg)
        self.staleness = registry.make_staleness_policy(
            "fixed" if staleness is None else staleness, cfg)
        self.use_kernels = use_kernels
        # compressed reducers with a fused kernel share the knob: one flag
        # routes both the tail and the compression through kernels
        if use_kernels and hasattr(self.reducer, "use_kernels"):
            self.reducer.use_kernels = True
        self.buckets = int(cfg.buckets if buckets is None else buckets)
        # the bucket padding granularity (a multiple of the kernels' BLOCK;
        # None = BLOCK): the autotuner's train-side knob
        self.plan_block = None if plan_block is None else int(plan_block)
        # the double-buffered bucket pipeline (repro_torch.parallel.
        # pipeline): issue each reduce at the end of the step, consume it
        # at the top of the next — bitwise the inline schedule
        self.overlap = bool(overlap or False)
        if self.overlap:
            from repro_torch.parallel import pipeline as PL
            PL.validate(buckets=self.buckets, reducer=self.reducer,
                        staleness=self.staleness)
        self._plan_cache: dict = {}

    def _plan(self, worker_params: Tree):
        """The cached `BucketPlan` for this model, from the per-worker
        shapes of a (W, ...) state tree."""
        from repro_torch.parallel import buckets as B
        return B.cached_plan(self._plan_cache, worker_params, self.buckets,
                             block=self.plan_block, strip_leading_axis=True,
                             wire_dtype=getattr(self.reducer, "comm_dtype",
                                                None))

    def init(self, params: Tree) -> TrainState:
        sdt = _STATE_DTYPES[self.cfg.state_dtype]
        wp = replicate_for_workers(params, self.n_workers)
        opt = _cast_slots(self.local_optimizer.init(wp), sdt)
        device = T.leaves(wp)[0].device
        # weight-mixing reducers never read the carried deltas
        if self._reduces_weights:
            comm = {}
        elif self.buckets:
            comm = {"delta_prev": self._plan(wp).zeros(
                sdt, lead=(self.n_workers,), device=device)}
        else:
            comm = {"delta_prev": T.map(
                lambda p: torch.zeros_like(p, dtype=sdt), wp)}
        if not self.staleness.stateless:
            comm["staleness"] = self.staleness.init(self.n_workers)
        # stateful (error-feedback compressed) reducers carry residuals /
        # warm-started factors across steps under comm["reducer"]
        if not self._reducer_stateless:
            comm["reducer"] = self.reducer.init(
                self.n_workers, self._plan(wp) if self.buckets else None,
                device=device)
        if self.overlap:
            # prime the pipeline with the call the inline schedule makes on
            # step 0: the reduce of the zero payload (the packed initial
            # weights for a weight-mixing reducer)
            from repro_torch.parallel import pipeline as PL
            wire0 = self._plan(wp).pack(wp) if self._reduces_weights \
                else comm["delta_prev"]
            comm["pipeline"], rs = PL.issue(self.reducer, wire0,
                                            comm.get("reducer"))
            if rs is not None:
                comm["reducer"] = rs
        return TrainState(params=wp, opt=opt, comm=comm, step=0)

    @property
    def _reducer_stateless(self) -> bool:
        return bool(getattr(self.reducer, "stateless", True))

    @property
    def _reduces_weights(self) -> bool:
        return bool(getattr(self.reducer, "reduces_weights", False))

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        """One DC-S3GD iteration for all workers at once.

        ``batch`` leaves are (W, per_worker_batch, ...); ``loss_fn(
        params_i, batch_i)`` is the per-worker loss."""
        cfg = self.cfg
        lr, wd = schedules(state.step, cfg)
        plan = self._plan(state.params) if self.buckets else None

        # --- MPI_Iallreduce of the carried deltas (bucketed when buckets>0),
        # or of the weights themselves for a weight-mixing reducer; depends
        # only on carried state, not on this step's gradients
        if self._reduces_weights:
            r_in = plan.pack(state.params) if plan is not None \
                else state.params
        else:
            r_in = state.comm["delta_prev"]
        rstate = None
        if self.overlap:
            # pipelined: the reduce of r_in was issued at the end of the
            # previous step (`_comm`); this step consumes what landed
            from repro_torch.parallel import pipeline as PL
            reduced = PL.landed(state.comm)
        else:
            # the `wire` scope marks the simulated wire's ops in an op
            # trace (repro_torch.analysis.lint), as the reference's
            # named scope marks its HLO
            with scope("wire"):
                if self._reducer_stateless:
                    reduced = self.reducer(r_in)
                else:
                    reduced, rstate = self.reducer(r_in,
                                                   state.comm["reducer"])

        # --- g_i = ∇l(w_i): per-worker gradients
        with scope("model"):
            grads, loss = _vgrads(loss_fn, state.params, batch,
                                  cfg.microbatches)

        # --- D_i = (1/N)·Δ̄w − Δw_i  (Eq. 9); for a weight-mixing reducer
        # D_i = R(w)_i − w_i, the same distance to the reduction target
        D = T.map(lambda r, x: r - x.float(), reduced, r_in)
        del reduced

        # --- staleness policy: a revoked window falls back to a blocking
        # pull toward the current worker mean (the SSP barrier analogue)
        pstate, pol_metrics = None, {}
        if not self.staleness.stateless:
            admit, pstate = self.staleness.admit(state.comm["staleness"])
            if not admit:
                pull = T.map(lambda w: _row_sum(w.float()) / w.shape[0]
                             - w.float(), state.params)
                D = plan.pack(pull) if plan is not None else pull
                if rstate is not None and hasattr(self.reducer, "revoke"):
                    # the compressed payload never reached the trajectory:
                    # it returns to the error-feedback residual
                    rstate = self.reducer.revoke(r_in, state.comm["reducer"],
                                                 rstate)
            pol_metrics = {"ssp_admit": float(admit)}

        if self.use_kernels:
            return self._fused_tail(state, grads, D, loss, lr, wd, plan=plan,
                                    rstate=rstate, pstate=pstate,
                                    pol_metrics=pol_metrics)

        if plan is not None:
            # leave the flat-buffer world: unpack is a static slice, so
            # the bucketed wire is bitwise the per-leaf wire
            D = plan.unpack(D)

        # --- g̃_i = g_i + λ_i g_i⊙g_i⊙D_i  (Eq. 10 + 17)
        g_t, lam = self.compensator(grads, D, axis0_is_worker=True)

        # --- Δw_i = U(g̃_i, η, μ)  (Eq. 11); the decay mask judges the
        # per-worker rank
        delta, opt = self.local_optimizer(
            g_t, state.opt, state.params, {"lr": lr, "weight_decay": wd},
            axis0_is_worker=True)

        # --- w_i = w_i + D_i + Δw_i  (Eq. 12)
        new_params = T.map(
            lambda w, d_i, dw: (w.float() + d_i + dw.float()).to(w.dtype),
            state.params, D, delta)

        sdt = _STATE_DTYPES[cfg.state_dtype]
        if isinstance(lam, torch.Tensor):
            lam_metric = lam.mean()
        else:   # per-tensor λ: the mean of the leaves' means
            lam_metric = torch.stack([v.mean() for v in T.leaves(lam)]).mean()
        metrics = {
            "loss": loss.mean(), "lr": lr, "wd": wd, "lambda": lam_metric,
            "distance_norm": _mean_worker_norm(D),
            "delta_norm": _mean_worker_norm(delta),
            **pol_metrics,
        }
        return TrainState(new_params, _cast_slots(opt, sdt),
                          self._comm(delta, sdt, rstate, pstate, plan=plan,
                                     prev_comm=state.comm,
                                     params=new_params),
                          state.step + 1), metrics

    def _comm(self, delta, sdt, rstate, pstate, *, plan=None,
              packed: bool = False, prev_comm=None, params=None) -> dict:
        """Next step's wire state: the carried deltas (packed by ``plan``
        unless ``packed`` says they already are; none for a weight-mixing
        reducer), a stateful reducer's state and a stateful staleness
        policy's counters.

        Under ``overlap`` this is also where the next reduce goes on the
        wire: the payload the inline schedule would reduce at the top of
        the next step (the carried delta buckets, or the packed new
        ``params`` for a weight-mixing reducer) is reduced now, and the
        result rides in ``comm["pipeline"]``."""
        comm = {}
        if not self._reduces_weights:
            wire = plan.pack(delta) if plan is not None and not packed \
                else delta
            comm["delta_prev"] = T.map(lambda d: d.to(sdt), wire)
        if rstate is not None:
            comm["reducer"] = rstate
        if pstate is not None:
            comm["staleness"] = pstate
        if self.overlap:
            from repro_torch.parallel import pipeline as PL
            wire = plan.pack(params) if self._reduces_weights \
                else comm["delta_prev"]
            rs_in = None if self._reducer_stateless \
                else prev_comm["reducer"]
            comm["pipeline"], rs_out = PL.issue(self.reducer, wire, rs_in)
            if rs_out is not None:
                comm["reducer"] = rs_out
        return comm

    def observe_progress(self, state: TrainState, worker_steps
                         ) -> TrainState:
        """Feed measured per-worker progress to the staleness policy (the
        launch layer calls this between steps); a no-op for stateless
        policies."""
        if self.staleness.stateless:
            return state
        comm = dict(state.comm)
        comm["staleness"] = self.staleness.observe(comm["staleness"],
                                                   worker_steps)
        return state._replace(comm=comm)

    def eval_params(self, state: TrainState) -> Tree:
        """w̄ for evaluation (paper Eq. 8), anchor-form consensus mean."""
        from repro_torch.core.reduce import consensus_mean
        return consensus_mean(state.params)

    def resize_state(self, state: TrainState, n_new: int) -> TrainState:
        """Reshard the carried state to ``n_new`` workers (elastic resize).

        A membership transition is a barrier: every worker-stacked piece
        collapses to its anchor-form consensus over all old workers,
        ``a[0] + mean(a − a[:1])`` in f32 (the formula of
        `consensus_mean`), and is restacked at the new count:

        * params and opt slots: leavers fold into the mean, joiners start
          from it, so ``eval_params`` after the resize is bitwise the
          value before (f32 params); 0-d slots (Adam's ``t``) stay;
        * ``delta_prev``: every worker then sits at the consensus, so the
          next step's D is zero, Algorithm 1's prologue after the barrier;
        * ``comm["staleness"]`` / ``comm["reducer"]``: the piece's own
          ``resize`` (counters collapse to the leader; error-feedback
          residual mass is conserved);
        * ``comm["pipeline"]``: `repro_torch.parallel.pipeline.resize`
          against the resized wire.

        The rows are materialised (``contiguous``), never expanded views:
        the kernels take contiguous operands and an in-place update of an
        expanded view would write every worker at once.  ``self`` still
        targets the old count: rebuild it for ``n_new`` with
        `repro_torch.cluster.membership.rebuild_algorithm`."""
        n_new = int(n_new)

        def restack(x):
            if x.dim() == 0:
                return x
            a = x.float()
            avg = a[0] + _row_sum(a - a[:1])[0] / a.shape[0]
            return avg.to(x.dtype).unsqueeze(0) \
                .expand((n_new,) + avg.shape).contiguous()

        params = T.map(restack, state.params)
        opt = T.map(restack, state.opt)
        comm = {}
        if "delta_prev" in state.comm:
            comm["delta_prev"] = T.map(restack, state.comm["delta_prev"])
        if "staleness" in state.comm:
            comm["staleness"] = self.staleness.resize(
                state.comm["staleness"], n_new)
        if "reducer" in state.comm:
            comm["reducer"] = self.reducer.resize(state.comm["reducer"],
                                                  n_new)
        if "pipeline" in state.comm:
            from repro_torch.parallel import pipeline as PL
            wire = self._plan(params).pack(params) \
                if self._reduces_weights else comm["delta_prev"]
            comm["pipeline"] = PL.resize(self.reducer,
                                         state.comm["pipeline"], wire)
        return TrainState(params, opt, comm, state.step)

    def _fused_tail(self, state: TrainState, grads, D, loss, lr: float,
                    wd: float, *, plan=None, rstate=None, pstate=None,
                    pol_metrics=None) -> Tuple[TrainState, Metrics]:
        if not (self.local_optimizer.name == "momentum"
                and not getattr(self.local_optimizer, "nesterov", False)
                and getattr(self.compensator, "mode", "global") == "global"):
            raise ValueError("fused kernel path: momentum + global-lambda "
                             "only")
        from repro_torch.kernels import ops as kops
        lambda0 = self.compensator.lambda0
        mu = self.local_optimizer.momentum
        sdt = _STATE_DTYPES[self.cfg.state_dtype]

        if plan is not None:
            # one launch per bucket (all W workers each); D is already
            # bucketed and the produced delta stays bucketed for the wire
            g_b = plan.pack(grads)
            gsq, csq = kops.dc_norms_buckets(g_b, D)
            lam = kops.dc_lambda(gsq, csq, lambda0)
            w_nb, m_nb, delta_b = kops.dc_fused_update_buckets(
                g_b, D, plan.pack(state.opt["m"]), plan.pack(state.params),
                lam=lam, mu=mu, eta=lr, wd=wd, decay=plan.bucket_decay)
            metrics = {
                "loss": loss.mean(), "lr": lr, "wd": wd, "lambda": lam.mean(),
                "distance_norm": _mean_worker_norm(D),
                "delta_norm": _mean_worker_norm(delta_b),
                **pol_metrics,
            }
            opt = {"m": T.map(lambda x: x.to(sdt), plan.unpack(m_nb))}
            new_params = plan.unpack(w_nb)
            return TrainState(new_params, opt,
                              self._comm(delta_b, sdt, rstate, pstate,
                                         plan=plan, packed=True,
                                         prev_comm=state.comm,
                                         params=new_params),
                              state.step + 1), metrics

        gsq, csq = kops.dc_norms_tree(grads, D)
        lam = kops.dc_lambda(gsq, csq, lambda0)
        new_params, m_new, delta = kops.dc_fused_update_tree(
            grads, D, state.opt["m"], state.params, lam=lam, mu=mu, eta=lr,
            wd=wd)
        metrics = {
            "loss": loss.mean(), "lr": lr, "wd": wd, "lambda": lam.mean(),
            "distance_norm": _mean_worker_norm(D),
            "delta_norm": _mean_worker_norm(delta),
            **pol_metrics,
        }
        return TrainState(new_params, {"m": T.map(lambda x: x.to(sdt), m_new)},
                          self._comm(delta, sdt, rstate, pstate),
                          state.step + 1), metrics


@registry.register(registry.ALGORITHM, "stale")
def _make_stale(cfg: DCS3GDConfig, **kw) -> DCS3GD:
    """Uncompensated stale-synchronous SGD: DC-S3GD with λ0 = 0."""
    kw.setdefault("compensator", "none")
    alg = DCS3GD(dataclasses.replace(cfg, lambda0=0.0), **kw)
    alg.name = "stale"
    return alg


# ---------------------------------------------------------------------------
# shared step internals
# ---------------------------------------------------------------------------


def _cast_slots(opt: Tree, sdt: torch.dtype) -> Tree:
    """Optimizer slots in the state dtype; 0-d slots (Adam's step count)
    keep theirs."""
    return T.map(lambda x: x.to(sdt) if x.dim() else x, opt)


def _vgrads(loss_fn, params: Tree, batch: Tree, microbatches: int = 1):
    """Per-worker (loss, gradients), one worker at a time: only one
    worker's activations are alive at once.  With ``microbatches > 1``
    each worker's batch splits into that many slices whose gradients are
    summed in f32, in slice order, and divided by the count.  Returns
    (grads tree (W, ...), loss (W,))."""
    leaves, treedef = T.flatten(params)
    W = leaves[0].shape[0]
    acc_dtype = None if microbatches <= 1 else torch.float32
    grads = [torch.empty(x.shape, dtype=acc_dtype or x.dtype,
                         device=x.device) for x in leaves]
    losses = []
    # materialize_grads: a leaf the loss does not read (a VLM's
    # vision_proj on a batch without patches) gets zeros, as jax.grad
    # gives it
    for i in range(W):
        p_i = [x[i].detach().requires_grad_() for x in leaves]
        tree_i = T.unflatten(treedef, p_i)
        b_i = T.map(lambda x: x[i], batch)
        if microbatches <= 1:
            loss = loss_fn(tree_i, b_i)
            g_i = torch.autograd.grad(loss, p_i, materialize_grads=True)
            for G, g in zip(grads, g_i):
                G[i].copy_(g)
            losses.append(loss.detach().float())
            continue
        if T.leaves(b_i)[0].shape[0] % microbatches:
            raise ValueError("the per-worker batch must split evenly into "
                             f"{microbatches} microbatches")
        l_acc = None
        for k in range(microbatches):
            mb = T.map(lambda x: x.chunk(microbatches)[k], b_i)
            loss = loss_fn(tree_i, mb)
            g_i = torch.autograd.grad(loss, p_i, materialize_grads=True)
            for G, g in zip(grads, g_i):
                if k == 0:
                    G[i].copy_(g.float())
                else:
                    G[i] += g.float()
            lv = loss.detach().float()
            l_acc = lv if l_acc is None else l_acc + lv
        for G in grads:
            G[i] /= float(microbatches)
        losses.append(l_acc / float(microbatches))
    return T.unflatten(treedef, grads), torch.stack(losses)


def _mean_worker_norm(tree: Tree) -> torch.Tensor:
    """Mean over workers of the per-worker Euclidean norm of a tree."""
    return torch.sqrt(sum(worker_sq_sum(x) for x in T.leaves(tree))).mean()

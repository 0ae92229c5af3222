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
the two hand-written CUDA kernels (`repro_torch.kernels`); on CPU tensors
the same calls run their plain versions.  ``buckets > 0`` packs the wire
state and the fused tail into a few flat buffers
(`repro_torch.parallel.buckets`); within the port the bucketed and
per-leaf trajectories are bitwise equal.

The reference fences the wire and D with ``lax.optimization_barrier`` so
XLA cannot fuse across them; eager PyTorch materialises every tensor, so
the port needs no counterpart.

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
from repro_torch.core.types import DCS3GDConfig
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

    def __init__(self, cfg: DCS3GDConfig, *, n_workers: int = 1,
                 local_optimizer=None, reducer=None, compensator=None,
                 staleness=None, use_kernels: bool = False,
                 buckets: Optional[int] = None,
                 overlap: Optional[bool] = None):
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
        if overlap:
            raise NotImplementedError(
                "overlap=True (the double-buffered bucket pipeline) is not "
                "ported yet: ROADMAP queue A9")
        if getattr(self.reducer, "reduces_weights", False):
            raise NotImplementedError(
                "weight-mixing reducers are not ported yet: ROADMAP A5")
        if not getattr(self.reducer, "stateless", True):
            raise NotImplementedError(
                "stateful (compressed) reducers are not ported yet: "
                "ROADMAP A8")
        if not self.staleness.stateless:
            raise NotImplementedError(
                "stateful staleness policies are not ported yet: ROADMAP A5")
        self.use_kernels = use_kernels
        self.buckets = int(cfg.buckets if buckets is None else buckets)
        self._plan_cache: dict = {}

    def _plan(self, worker_params: Tree):
        """The cached `BucketPlan` for this model, from the per-worker
        shapes of a (W, ...) state tree."""
        from repro_torch.parallel import buckets as B
        return B.cached_plan(self._plan_cache, worker_params, self.buckets,
                             strip_leading_axis=True)

    def init(self, params: Tree) -> TrainState:
        sdt = _STATE_DTYPES[self.cfg.state_dtype]
        wp = replicate_for_workers(params, self.n_workers)
        opt = T.map(lambda x: x.to(sdt), self.local_optimizer.init(wp))
        if self.buckets:
            device = T.leaves(wp)[0].device
            delta_prev = self._plan(wp).zeros(sdt, lead=(self.n_workers,),
                                              device=device)
        else:
            delta_prev = T.map(lambda p: torch.zeros_like(p, dtype=sdt), wp)
        return TrainState(params=wp, opt=opt, comm={"delta_prev": delta_prev},
                          step=0)

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        """One DC-S3GD iteration for all workers at once.

        ``batch`` leaves are (W, per_worker_batch, ...); ``loss_fn(
        params_i, batch_i)`` is the per-worker loss."""
        cfg = self.cfg
        lr, wd = schedules(state.step, cfg)
        plan = self._plan(state.params) if self.buckets else None

        # --- MPI_Iallreduce of the carried deltas (bucketed when buckets>0);
        # depends only on carried state, not on this step's gradients
        delta_prev = state.comm["delta_prev"]
        delta_bar = self.reducer(delta_prev)

        # --- g_i = ∇l(w_i): per-worker gradients
        grads, loss = _vgrads(loss_fn, state.params, batch, cfg.microbatches)

        # --- D_i = (1/N)·Δ̄w − Δw_i  (Eq. 9)
        D = T.map(lambda db, d: db - d.float(), delta_bar, delta_prev)
        del delta_bar

        if self.use_kernels:
            return self._fused_tail(state, grads, D, loss, lr, wd, plan=plan)

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
        metrics = {
            "loss": loss.mean(), "lr": lr, "wd": wd, "lambda": lam.mean(),
            "distance_norm": _mean_worker_norm(D),
            "delta_norm": _mean_worker_norm(delta),
        }
        delta_c = plan.pack(delta) if plan is not None else delta
        return TrainState(new_params, T.map(lambda x: x.to(sdt), opt),
                          {"delta_prev": T.map(lambda d: d.to(sdt), delta_c)},
                          state.step + 1), metrics

    def eval_params(self, state: TrainState) -> Tree:
        """w̄ for evaluation (paper Eq. 8), anchor-form consensus mean."""
        from repro_torch.core.reduce import consensus_mean
        return consensus_mean(state.params)

    def resize_state(self, state: TrainState, n_new: int) -> TrainState:
        raise NotImplementedError(
            "elastic resize is not ported yet: ROADMAP queue A10")

    def _fused_tail(self, state: TrainState, grads, D, loss, lr: float,
                    wd: float, *, plan=None) -> Tuple[TrainState, Metrics]:
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
            }
            opt = {"m": T.map(lambda x: x.to(sdt), plan.unpack(m_nb))}
            return TrainState(plan.unpack(w_nb), opt,
                              {"delta_prev": [b.to(sdt) for b in delta_b]},
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
        }
        return TrainState(new_params, {"m": T.map(lambda x: x.to(sdt), m_new)},
                          {"delta_prev": T.map(lambda d: d.to(sdt), delta)},
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
    for i in range(W):
        p_i = [x[i].detach().requires_grad_() for x in leaves]
        tree_i = T.unflatten(treedef, p_i)
        b_i = T.map(lambda x: x[i], batch)
        if microbatches <= 1:
            loss = loss_fn(tree_i, b_i)
            for G, g in zip(grads, torch.autograd.grad(loss, p_i)):
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
            for G, g in zip(grads, torch.autograd.grad(loss, p_i)):
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
    sq = sum(x.float().square().sum(dim=tuple(range(1, x.dim())))
             for x in T.leaves(tree))
    return torch.sqrt(sq).mean()

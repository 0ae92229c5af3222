"""The Engine: the mesh and its spec trees, the training loop,
checkpoints with the metadata that rebuilds their algorithm, and one-shot
generation (the port of ``repro.launch.engine.Engine``).

With ``mesh=None`` the W workers live in one process.  With a
``DeviceMesh`` (`repro_torch.launch.mesh`) the spec trees come from the
algorithm's own ``state_specs`` / ``batch_specs`` hooks
(`train_shardings`) and from the partition rules for serving
(`serve_shardings`); an executing Engine binds the algorithm to the
mesh's worker process group, and each rank holds the W / R worker rows
of its coordinate on the worker axes, pod-major (`shard`, `local_batch`,
`gather_state`).  A 'model' axis above 1 runs tensor-parallel: each
rank holds its shards of the leaves the partition rules shard over
'model' (`parallel.sharding.model_shard`), the model computes
Megatron-style over the axis (`models.transformer.Model.with_model_axis`)
and the algorithm sums its norms over it (``bind_model_axis``);
`gather_state`, `save` and `restore` cross both axes, so a checkpoint is
the one-process state.  An Engine built only to serve (``alg=None``)
binds the same axes: each rank holds its serve shards of the params
(`serve_params`) and its data rows of a batch (`serve_batch`), the model
prefills and decodes over 'model' on them, and `generate` gathers every
data rank's tokens, so every rank returns the whole batch.  Every
algorithm of the registry trains across the worker ranks, under every
reducer and staleness policy (hierarchical groups in any layout over
the ranks), and an elastic run resizes across them (each rank keeps
``W / R`` rows of the live W); over 'model' a compressed wire or a
quantized ``comm_dtype`` reduces the whole buckets on every model rank,
and its ``comm["reducer"]`` is whole there, so `gather_state` and
`restore` move it over the worker axis only.

A mesh that `repro_torch.launch.mesh.mesh_for_spec` laid over fewer
ranks than the world (a membership the world's ranks cannot split)
leaves the other ranks outside it: there the Engine holds no rows,
`init_state`, `gather_state`, `restore` and the algorithm's
``eval_params`` return None, `save` writes nothing and `fit` takes no
step; the mesh's own ranks train, gather, save (its first rank writes)
and restore among themselves.  ``fit`` keeps its mesh, as the
reference's does: a transition to a W the live ranks cannot split
raises before any rank changes state, naming ``mesh_for_spec``, and the
run goes on through ``Membership.apply(..., workers=...)`` and a new
Engine over the new mesh (`repro_torch.cluster.membership`).

Refused at construction, never run silently in one process: a W that
does not divide the mesh's worker capacity (the reference's
`validate_worker_count`), a sharded dim that does not divide the
'model' axis (the reference's GSPMD refuses the same sharding), and the
paged serving seam over 'model', which the reference runs in one
process only (``specs_only=True`` keeps any mesh's specs for the
dry-run).

PyTorch runs eagerly, so there is nothing to jit: ``fit`` calls the
algorithm's ``step`` directly, and where the reference lowers a step for
its analyzer (``lower_train_step``) the port runs one under an op trace
(`trace_train_step`).  `retrace_stats` reports the caches a steady loop
must not grow.  The loop stays on the device's queue:
metrics are fetched to the host only on ``log_every`` boundaries (and
the last step), with one device-to-host copy for the whole dict.  Only
``measure_skew`` synchronises every step, because it times them.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import (checkpoint_meta, restore_pytree,
                                    save_pytree)
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.tensor import (UNEVEN_LIMIT, gather_leaves,
                                         model_dims)
from repro_torch.serve.oneshot import OneShotGenerator

Tree = Any

# checkpoint metadata keys describing the algorithm that produced a state
CKPT_ALGO_KEYS = ("algo", "reducer", "reducer_opts", "local_optimizer",
                  "n_workers", "staleness", "ssp_threshold", "buckets",
                  "plan_block", "overlap")

# the metrics a step line shows, where the algorithm reports them
_SHOWN = ("loss", "lr", "distance_norm", "lambda")


def fetch_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Device metrics -> host floats, in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
        out.update(zip(keys, vals.tolist()))
    return out


def _synchronize(metrics: Dict[str, Any]) -> None:
    """Wait for the device work behind a step's metrics."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def _gather_floats(workers, x: float) -> List[float]:
    """Every worker rank's host float ``x``, in worker order (one small
    all-gather; over NCCL through the current device)."""
    import torch.distributed as dist
    dev = "cpu" if workers.host else torch.device(
        "cuda", torch.cuda.current_device())
    mine = torch.tensor([x], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(workers.size)]
    dist.all_gather(parts, mine, group=workers.group)
    return torch.cat(parts).tolist()


def _max_float(axis, x: float) -> float:
    """The largest of a host float ``x`` over the 'model' axis ``axis``
    (one small all-reduce; over NCCL through the current device)."""
    import torch.distributed as dist
    dev = "cpu" if dist.get_backend(axis.group) == "gloo" else \
        torch.device("cuda", torch.cuda.current_device())
    return float(axis.max(torch.tensor([x], dtype=torch.float64,
                                       device=dev))[0])


# comm entries that live on the host, outside the param layout (a
# staleness policy's counters): never gathered or cut over 'model'
_HOST_COMM = ("staleness",)
# comm entries whole on every model rank (a compressed reducer's state in
# the whole plan's layout): never gathered or cut over 'model', moved
# over the worker axis by their own specs
_WHOLE_COMM = ("reducer",)

# why an algorithm without a worker seam is refused across ranks: every
# registered one has the seam; an algorithm built outside the registry
# without ``bind_workers`` cannot split its worker rows over the ranks
_NO_WORKER_SEAM = ("it has no bind_workers, so it cannot split its "
                   "worker rows over the ranks; every registered algorithm "
                   "has one")


class Engine:
    """Runs one (model, algorithm) pair's step loop, or generates from a
    model (the algorithm is then not needed); ``mesh`` lays the worker
    axis over the ranks of a `DeviceMesh`."""

    def __init__(self, model, alg=None, *, mesh=None,
                 specs_only: bool = False):
        self.model = model
        self.alg = alg
        self.mesh = mesh
        self.workers = None
        # the tensor-parallel context of a mesh whose 'model' axis is > 1
        self.model_axis = None
        self._oneshot: Optional[OneShotGenerator] = None
        # algorithm rebuilds by the last `fit` loop (elastic transitions)
        self._fit_rejits = 0
        # fail fast on a worker count the mesh cannot carry
        if alg is not None:
            shd.validate_worker_count(getattr(alg, "n_workers", None), mesh)
        if mesh is not None and not specs_only:
            self._bind(mesh)

    # -- the mesh seam -------------------------------------------------------

    def _bind(self, mesh) -> None:
        """Refuse what cannot run across this mesh's ranks, then bind the
        model to the 'model' axis and the algorithm (when there is one)
        to its worker process group."""
        from repro_torch.launch import mesh as M
        model_size = M.model_size(mesh)
        if model_size > 1:
            self._refuse_over_model(model_size)
        self.workers = M.make_workers(mesh)
        if model_size > 1 and self.workers.holds:
            self.model_axis = M.model_axis(mesh)
            if hasattr(self.model, "with_model_axis"):
                self.model = self.model.with_model_axis(self.model_axis)
        self._bind_alg()

    def _bind_alg(self) -> None:
        """Bind the algorithm (a rebuilt one too) to the 'model' axis and
        the worker group."""
        alg = self.alg
        if alg is None or self.workers is None:
            return
        if self.model_axis is not None:
            alg.bind_model_axis(self.model_axis,
                                getattr(self.model, "cfg", None))
        if not hasattr(alg, "bind_workers"):
            if self.workers.size == 1:
                return
            raise ValueError(
                f"{alg.name} has no worker seam and is refused on a worker "
                f"group of {self.workers.size} ranks ({_NO_WORKER_SEAM})")
        alg.bind_workers(self.workers)

    def _refuse_over_model(self, model_size: int) -> None:
        """Raise for what does not run over a 'model' axis of
        ``model_size``: a sharded dim that does not divide the axis,
        which the reference's GSPMD refuses as well.  Every algorithm,
        reducer and wire runs over it (a compressed wire or a quantized
        ``comm_dtype`` over the whole buckets,
        `repro_torch.parallel.tensor.WholeWire`), and so does serving
        (``alg=None``)."""
        cfg = getattr(self.model, "cfg", None)
        if cfg is not None:
            from repro_torch.launch import specs as S
            try:
                shd.validate_model_axis(cfg, S.abstract_params(self.model),
                                        model_size=model_size)
            except ValueError as e:
                raise ValueError(f"{cfg.name}: {e} ({UNEVEN_LIMIT})") \
                    from None

    def mesh_axes(self):
        if self.mesh is None:
            return None
        from repro_torch.launch.mesh import make_axes
        return make_axes(self.mesh)

    def train_shardings(self, state, batch):
        """(state specs, batch specs) from the algorithm's own
        ``state_specs`` / ``batch_specs`` hooks; (None, None) without a
        mesh.  ``state`` / ``batch`` may be fake tensors."""
        axes = self.mesh_axes()
        if axes is None:
            return None, None
        cfg = getattr(self.model, "cfg", None)
        return (self.alg.state_specs(cfg, state, axes),
                self.alg.batch_specs(cfg, batch, axes))

    def _data_axes(self, global_batch: int):
        """Serving batch axis: the worker mesh axes when they divide the
        batch (long_500k has global_batch 1: it stays replicated)."""
        from repro_torch.launch.mesh import n_workers
        axes = self.mesh_axes()
        return axes.worker_spec if global_batch % n_workers(self.mesh) == 0 \
            else None

    def serve_shardings(self, params, *, global_batch: int, batch=None,
                        cache=None):
        """(param, batch, cache) specs for serving: the training partition
        rules minus the worker axis; (None, None, None) without a mesh."""
        axes = self.mesh_axes()
        if axes is None:
            return None, None, None
        cfg = self.model.cfg
        da = self._data_axes(global_batch)
        p = shd.param_specs(cfg, params, model_size=axes.model_size,
                            worker_axes=None)
        b = None if batch is None else shd.batch_specs(cfg, batch,
                                                       data_axes=da)
        c = None if cache is None else shd.cache_specs(
            cfg, cache, model_size=axes.model_size, data_axes=da)
        return p, b, c

    def _coord(self):
        from repro_torch.launch import mesh as M
        return M.axis_sizes(self.mesh), M.coordinate(self.mesh)

    def shard(self, tree, specs):
        """This rank's shard of every leaf of a global ``tree`` under its
        spec tree (host ints and numpy leaves pass through)."""
        sizes, coord = self._coord()
        flat = dict(shd.flat_specs(specs, tree))

        def take(path, x):
            if not isinstance(x, torch.Tensor):
                return x
            sl = shd.local_slices(tuple(x.shape), flat[path], sizes, coord)
            return x[sl].clone()
        return shd.map_with_path(take, tree)

    def local_batch(self, batch):
        """A global (W, b, ...) batch's rows of this rank (the batch
        itself without a bound mesh); an Engine without an algorithm
        takes a serving batch's rows (`serve_batch`)."""
        if self.workers is None:
            return batch
        if self.alg is None:
            return self.serve_batch(batch)
        return self.shard(batch, self.alg.batch_specs(
            getattr(self.model, "cfg", None), batch, self.mesh_axes()))

    def serve_params(self, params):
        """This rank's serve shards of a whole parameter tree: the
        partition rules minus the worker axis (`serve_shardings`), so
        every data rank holds the same shards (the tree itself without a
        bound mesh)."""
        if self.workers is None:
            return params
        specs, _, _ = self.serve_shardings(params, global_batch=1)
        return self.shard(params, specs)

    def serve_batch(self, batch):
        """This rank's rows of a global serving batch (B, ...): the data
        ranks split the rows when they divide B, else every rank takes
        every row (the reference's ``_data_axes``: long_500k's batch of
        1 stays replicated); ``pos`` and a VLM's ``mrope_positions`` are
        every rank's (the batch itself without a bound mesh)."""
        if self.workers is None:
            return batch
        rows = batch["tokens"].shape[0]
        return self.shard(batch, shd.batch_specs(
            self.model.cfg, batch, data_axes=self._data_axes(rows)))

    def _idle(self) -> bool:
        """This rank lies outside the bound mesh: it holds no rows."""
        return self.workers is not None and not self.workers.holds

    def init_state(self, params):
        """The algorithm's state from ``params`` (the whole tree); over a
        'model' axis each rank keeps its shards of it, and on a mesh every
        rank then takes worker rank 0's params (a broadcast), so all start
        from bitwise the same weights.  None on a rank outside the mesh."""
        if self._idle():
            return None
        if self.model_axis is not None:
            params = shd.model_shard(getattr(self.model, "cfg", None), params,
                                     model_size=self.model_axis.size,
                                     rank=self.model_axis.rank)
        if self.workers is not None and self.workers.size > 1:
            import torch.distributed as dist
            for x in T.leaves(params):
                dist.broadcast(x, group_src=0, group=self.workers.group)
        return self.alg.init(params)

    def gather_state(self, state):
        """The global state of a sharded one: every worker-sharded leaf
        all-gathered over the worker group along its sharded dim (the
        state itself without a bound mesh).  Over gloo the leaves travel
        through host copies (gloo gathers CPU tensors only) and come back
        on the CPU.  None on a rank outside the mesh."""
        if self._idle():
            return None
        if self.workers is None or (self.workers.size == 1
                                    and self.model_axis is None):
            return state
        import torch.distributed as dist
        if hasattr(self.alg, "drain"):
            self.alg.drain()
        if self.model_axis is not None:
            state = self._whole_over_model(state)
            if self.workers.size == 1:
                return state
        specs, _ = self.train_shardings(state, {})
        flat = dict(shd.flat_specs(specs, state))
        group = self.workers.group
        host = dist.get_backend(group) == "gloo"
        worker = set(self.mesh_axes().worker)

        def gather(path, x):
            if not isinstance(x, torch.Tensor):
                return x
            spec = flat[path]
            dims = [d for d, e in enumerate(spec)
                    if worker & set(e if isinstance(e, tuple) else (e,))]
            if not dims:
                return x.cpu() if host else x
            d = dims[0]
            src = x.cpu() if host else x
            parts = [torch.empty_like(src) for _ in range(self.workers.size)]
            dist.all_gather(parts, src.contiguous(), group=group)
            return torch.cat(parts, dim=d)
        return shd.map_with_path(gather, state)

    # -- the 'model' axis of a state ------------------------------------------

    def _model_trees(self, state, fn):
        """``state`` with ``fn(tree)`` applied to each of its param-shaped
        trees: params, each optimizer slot but a 0-d one (Adam's step
        count), each comm entry but a staleness policy's host counters
        and the entries whole over 'model' (the callers unpack the bucket
        lists into their trees first, `_unpack_comm`)."""
        return state._replace(
            params=fn(state.params),
            opt={k: fn(v) if isinstance(v, dict) else v
                 for k, v in state.opt.items()},
            comm={k: v if k in _HOST_COMM + _WHOLE_COMM else fn(v)
                  for k, v in state.comm.items()})

    def _unpack_comm(self, state, plan):
        """``state`` with its bucket lists (the carried ``delta_prev``,
        the overlap pipeline's landed buffers) unpacked by ``plan`` into
        param-shaped trees."""
        comm = dict(state.comm)
        if self._bucketed(state):
            comm["delta_prev"] = plan.unpack(comm["delta_prev"])
        if "pipeline" in comm:
            comm["pipeline"] = plan.unpack(comm["pipeline"]["reduced"])
        return state._replace(comm=comm)

    def _pack_comm(self, state, plan, like):
        """The inverse of `_unpack_comm` by ``plan``, for the entries
        ``like`` (the state before it) held as bucket lists."""
        comm = dict(state.comm)
        if self._bucketed(like):
            comm["delta_prev"] = plan.pack(comm["delta_prev"])
        if "pipeline" in comm:
            comm["pipeline"] = {"reduced": plan.pack(comm["pipeline"])}
        return state._replace(comm=comm)

    def _has_buckets(self, state) -> bool:
        """Whether ``state`` holds bucket lists (`_unpack_comm`)."""
        return self._bucketed(state) or "pipeline" in state.comm

    def _bucketed(self, state) -> bool:
        return isinstance(state.comm.get("delta_prev"), list)

    def _whole_over_model(self, state):
        """This rank's rows of the whole state: every leaf sharded over
        'model' all-gathered over the axis along its sharded dim, the
        carried delta buckets repacked by the whole tree's plan, a
        compressed reducer's state (whole already) as it is (over gloo
        through host copies, back on the CPU)."""
        import torch.distributed as dist
        axis = self.model_axis
        cfg = getattr(self.model, "cfg", None)
        host = dist.get_backend(axis.group) == "gloo"
        like = state
        if self._has_buckets(state):
            state = self._unpack_comm(state, self.alg._plan(state.params))

        def whole(tree):
            leaves, treedef = T.flatten(tree)
            if host:
                leaves = [x.cpu() for x in leaves]
            return T.unflatten(treedef, gather_leaves(
                axis, leaves, model_dims(axis, cfg, tree)))
        out = self._model_trees(state, whole)
        if host:
            out = out._replace(comm={
                k: T.map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                         else x, v) if k in _WHOLE_COMM else v
                for k, v in out.comm.items()})
        if self._has_buckets(like):
            out = self._pack_comm(out, self.alg._plan(out.params, whole=True),
                                  like)
        return out

    def _shard_whole(self, full):
        """This rank's shards, on both axes, of a whole state (the
        inverse of `gather_state`)."""
        alg = self.alg
        like = full
        if self._has_buckets(full):
            full = self._unpack_comm(full, alg._plan(full.params, whole=True))
        cfg = getattr(self.model, "cfg", None)
        wa = self.mesh_axes().worker_spec \
            if getattr(alg, "worker_stacked", False) else None

        def cut(tree, workers=wa):
            return self.shard(tree, shd.param_specs(
                cfg, tree, model_size=self.model_axis.size,
                worker_axes=workers))
        # what is not cut as a param tree: the host counters (whole on
        # every rank), a compressed reducer's state (cut over the worker
        # axis by its own specs) and a mean-style pipeline's (1, n)
        # buffers
        apart = {k: v for k, v in full.comm.items() if k in _HOST_COMM}
        if "reducer" in full.comm:
            specs, _ = self.train_shardings(like, {})
            apart["reducer"] = self.shard(full.comm["reducer"],
                                          specs.comm["reducer"])
        if "pipeline" in full.comm and not getattr(
                getattr(alg, "reducer", None), "reduces_weights", False):
            apart["pipeline"] = cut(full.comm["pipeline"], None)
        out = self._model_trees(full._replace(comm={
            k: v for k, v in full.comm.items() if k not in apart}), cut)
        out = out._replace(comm={**out.comm, **apart})
        if self._has_buckets(like):
            out = self._pack_comm(out, alg._plan(out.params), like)
        return out

    # -- the analysis seam (repro_torch.analysis) ----------------------------

    def _wire_sizes(self, state) -> List[int]:
        """Per-worker element counts the reducer moves each step: the
        padded `BucketPlan` sizes when bucketed, else the leaves' sizes
        (per worker for a worker-stacked state); over 'model' a wire of
        the whole buckets (`WholeWire`) counts the whole plan's, as the
        reference's accounting does."""
        alg = self.alg
        wire = alg._whole_wire(state.params) \
            if hasattr(alg, "_whole_wire") else None
        if wire is not None:
            # over 'model': the whole buckets (leaves) the reducer moves
            return list(wire.sizes)
        if getattr(alg, "buckets", 0):
            return [int(n) for n in alg._plan(state.params).bucket_sizes]
        stacked = getattr(alg, "worker_stacked", False)
        return [x.numel() // (x.shape[0] if stacked else 1)
                for x in T.leaves(state.params)]

    def trace_train_step(self, state, batch, *, watch=None):
        """Run one step of the algorithm under an op trace
        (`repro_torch.analysis.optrace`): the counterpart of the
        reference's ``lower_train_step``, whose HLO the port does not
        have.  Returns ``(trace, new_state, metrics)``; the step really
        runs, so the caller drops ``state`` as after any step.

        ``trace.meta`` carries what the analyzers cross-check: the
        ``wire`` (its element ``sizes``, ``n_workers``, ``comm_dtype`` and
        the reducer's ``bytes``), the ``device``, whether f32 matmuls may
        use TF32 and the model's ``compute_dtype``.  ``watch`` (label ->
        tensor) marks tensors whose readers the trace lists."""
        from repro_torch.analysis import optrace
        red = getattr(self.alg, "reducer", None)
        meta = {"device": T.leaves(state.params)[0].device.type,
                "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
                "compute_dtype": getattr(getattr(self.model, "cfg", None),
                                         "compute_dtype", None)}
        if red is not None:
            sizes = self._wire_sizes(state)
            meta["wire"] = {"sizes": sizes,
                            "n_workers": getattr(self.alg, "n_workers", 1),
                            "comm_dtype": red.comm_dtype,
                            "bytes": int(red.wire_bytes(sizes))}
        with optrace.trace(watch=watch) as tr:
            new_state, metrics = self.alg.step(state, batch,
                                               loss_fn=self.model.loss)
        tr.meta.update(meta)
        return tr, new_state, metrics

    def retrace_stats(self) -> dict:
        """The caches a steady step loop must not grow (the counterpart of
        the reference's jit cache-miss counters): the algorithm's bucket
        plans (``plan_cache_size``), the loaded kernel libraries
        (``kernel_builds``), the last `fit` loop's algorithm rebuilds
        (``fit_rejits``, > 0 only across elastic transitions).
        `repro_torch.analysis.lint`'s retrace pass fails a loop whose
        counters move after its first step."""
        from repro_torch.kernels.build import _LOADED
        return {"plan_cache_size":
                    len(getattr(self.alg, "_plan_cache", None) or {}),
                "kernel_builds": len(_LOADED),
                "fit_rejits": self._fit_rejits}

    def fit(self, state, batch_fn: Callable[..., Tree], *, steps: int,
            start: int = 0, log_every: int = 10, measure_skew: bool = False,
            skew_probe: Optional[Callable[[int, float], Any]] = None,
            skew_warmup: int = 1, membership=None
            ) -> Tuple[Any, list, float]:
        """Run steps ``start .. steps-1``; returns (state, metric history,
        wall seconds).  Each history entry carries ``wall_s``, the seconds
        since the loop started, read after that step's metrics reached the
        host.  A resumed run passes the checkpoint's step as ``start``:
        ``batch_fn`` is called with each step's index and the schedules
        follow ``state.step``.

        ``measure_skew=True`` drives a stateful staleness policy (and the
        ejection policy of an elastic run) from measured step times: each
        step is synchronised and timed, and every worker's virtual clock
        advances by the steps it would have completed free-running within
        the step (``max(durs) / durs[w]``; a non-positive duration is a
        stalled worker) before the counters go to ``alg.observe_progress``
        and the controller.  In the one-process simulation every worker
        shares the measured time (skew 0); ``skew_probe(it, dt) ->
        per-worker durations`` plugs in real ones.  On a revoked step
        (``ssp_admit == 0``) the clocks collapse to the leader, as the
        policy's counters do.  The first ``skew_warmup`` steps, and as many
        after each membership transition, do not advance the clocks (such
        a step's time is set-up, not worker speed).

        ``membership`` (a `repro_torch.cluster.Membership`) makes the run
        elastic: scripted faults and queued ejections are polled before
        every step and applied as a collapse-to-consensus resize
        (``alg.resize_state`` + `rebuild_algorithm`), after which the loop
        steps with the controller's rebuilt algorithm.  Elastic runs call
        ``batch_fn(it, n_workers)``, so the batch follows the live worker
        count; a scripted slowdown multiplies the measured durations.

        On a mesh each rank times its own step (over a 'model' axis the
        worker's time is the slowest of its model ranks', one small
        all-reduce); one small all-gather brings every rank every
        worker rank's time, so all advance the same clocks (a worker's duration is its rank's, or ``skew_probe(it,
        the slowest rank's time)``) and take the same admit decisions.
        An elastic run re-binds each rebuilt algorithm to the worker
        group, and every rank takes its ``W / R`` rows of the live W.  A
        transition to a W the live ranks cannot split raises before it is
        applied (the run goes on over the mesh that carries it:
        `repro_torch.cluster.membership`).  On a rank outside the mesh
        ``fit`` takes no step and returns ``(state, [], 0.0)``."""
        if self._idle():
            return state, [], 0.0
        elastic = membership is not None
        self._fit_rejits = 0
        if elastic:
            self.alg = membership.alg
            self._bind_alg()
        cur_w = getattr(self.alg, "n_workers", 1)

        def stateful_policy():
            return hasattr(self.alg, "observe_progress") and not getattr(
                getattr(self.alg, "staleness", None), "stateless", True)

        stateful = stateful_policy()
        measuring = measure_skew and (stateful or elastic)
        n_workers = cur_w if measuring else 0
        vprogress = [0.0] * n_workers   # free-running step counts
        warmup = max(int(skew_warmup), 0)
        warm_until = start + warmup     # steps below this: set-up time
        history = []
        t0 = time.perf_counter()
        for it in range(start, steps):
            if elastic:
                events = membership.peek(it)
                if events:
                    self._check_carried(membership.preview(events), it)
                events = membership.poll(it)
                if events:
                    state, changed = membership.apply(events, state,
                                                      step=it)
                    if changed:
                        self.alg = membership.alg
                        self._bind_alg()
                        self._fit_rejits += 1
                        cur_w = membership.n_workers
                        stateful = stateful_policy()
                        n_workers = cur_w if measuring else 0
                        # the transition is a barrier: everyone leaves it
                        # at the leader's virtual clock
                        vprogress = [max(vprogress, default=0.0)] \
                            * n_workers
                        warm_until = it + warmup
            batch = batch_fn(it, cur_w) if elastic else batch_fn(it)
            batch = self.local_batch(batch)
            ts = time.perf_counter()
            state, metrics = self.alg.step(state, batch,
                                           loss_fn=self.model.loss)
            if measuring:
                _synchronize(metrics)
                dt = time.perf_counter() - ts
                if self.model_axis is not None:
                    # the model ranks of a worker each time their own
                    # share of its step: one time per worker (their
                    # slowest), or they would admit different windows
                    dt = _max_float(self.model_axis, dt)
                if self.workers is not None and self.workers.size > 1:
                    dts = _gather_floats(self.workers, dt)
                    dt = max(dts)
                else:
                    dts = [dt]
                if it >= warm_until:
                    rows = n_workers // len(dts)
                    durs = list(skew_probe(it, dt)) \
                        if skew_probe is not None \
                        else [dts[w // rows] for w in range(n_workers)]
                    if len(durs) != n_workers:
                        raise ValueError(f"skew_probe gave {len(durs)} "
                                         f"durations for {n_workers} workers")
                    slow = membership.slowdown_factors(it) if elastic \
                        else None
                    if slow is not None:
                        durs = [d * f for d, f in zip(durs, slow)]
                    if metrics.get("ssp_admit", 1.0) == 0.0:
                        # the revoked step's pull resolved the skew
                        vprogress = [max(vprogress)] * n_workers
                    wall = max(durs)
                    vprogress = [p + (wall / d if d > 0 else 0.0)
                                 for p, d in zip(vprogress, durs)]
                progress = [int(p) for p in vprogress]
                if stateful:
                    state = self.alg.observe_progress(state, progress)
                if elastic:
                    membership.observe_progress(it, vprogress)
            if it % log_every == 0 or it == steps - 1:
                m = fetch_metrics(metrics)
                m["step"] = it
                m["wall_s"] = time.perf_counter() - t0
                if measuring:
                    m["measured_skew"] = max(progress) - min(progress)
                if elastic:
                    m["n_workers"] = cur_w
                history.append(m)
                print(f"[train] step {it:5d} " + " ".join(
                    f"{k}={m[k]:.4g}" for k in _SHOWN if k in m))
        return state, history, time.perf_counter() - t0

    def _check_carried(self, spec, step: int) -> None:
        """Raise where the live ranks cannot split the membership ``spec``
        (before anything changes): the reference's ``fit`` keeps its mesh
        and fails there in its jit."""
        if self.workers is not None and spec.n_workers % self.workers.size:
            raise ValueError(
                f"step {step}: the membership of {spec.n_workers} workers "
                f"does not split over this mesh's {self.workers.size} worker"
                f" ranks; rebuild the mesh for it "
                f"(launch.mesh.mesh_for_spec), resize onto its seam "
                f"(Membership.apply(..., workers=launch.mesh.make_workers("
                f"mesh))) and fit on with an Engine over it")

    # -- checkpoints with the algorithm's metadata ---------------------------

    def ckpt_meta(self) -> dict:
        """What a restore site needs to rebuild the algorithm that trained
        a state: its name and worker count, the reducer with its
        hyper-parameters (a gossip ring or a topk density rebuilt with
        the defaults would resume another topology), the local optimizer,
        the staleness policy and its threshold, and the bucket count,
        padding block and overlap flag, which decide the structure of
        ``comm``."""
        alg = self.alg
        return {
            "algo": alg.name,
            "n_workers": getattr(alg, "n_workers", None),
            "reducer": getattr(getattr(alg, "reducer", None), "name", None),
            "reducer_opts": getattr(
                getattr(alg, "reducer", None), "hparams", None),
            "local_optimizer": getattr(
                getattr(alg, "local_optimizer", None), "name", None),
            "staleness": getattr(
                getattr(alg, "staleness", None), "name", None),
            "ssp_threshold": getattr(
                getattr(alg, "staleness", None), "threshold", None),
            "buckets": getattr(alg, "buckets", None),
            "plan_block": getattr(alg, "plan_block", None),
            "overlap": getattr(alg, "overlap", None),
        }

    def save(self, path, state, *, step: Optional[int] = None):
        """Save ``state`` with the metadata `algorithm_for_checkpoint`
        reads; returns the path written.  An in-flight overlap reduce is
        waited on first; on a mesh the global state is gathered and worker
        rank 0 writes it (a rank outside the mesh writes nothing)."""
        if self._idle():
            return path
        if hasattr(self.alg, "drain"):
            self.alg.drain()
        if self.workers is None or (self.workers.size == 1
                                    and self.model_axis is None):
            return save_pytree(path, state, step=step,
                               extra_meta=self.ckpt_meta())
        import torch.distributed as dist
        full = self.gather_state(state)
        out = path
        first = self.model_axis is None or self.model_axis.rank == 0
        if self.workers.rank == 0 and first:
            out = save_pytree(path, full, step=step,
                              extra_meta=self.ckpt_meta())
        # the writer's worker group, then each worker's model group: no
        # rank returns before the file is written
        dist.barrier(group=self.workers.group)
        if self.model_axis is not None:
            dist.barrier(group=self.model_axis.group)
        return out

    def restore(self, path, state):
        """``path``'s state in the structure (and on the devices) of the
        template ``state``; on a mesh, this rank's shard of it (None on a
        rank outside the mesh)."""
        if self._idle():
            return None
        if self.workers is None or (self.workers.size == 1
                                    and self.model_axis is None):
            return restore_pytree(path, state)
        full = restore_pytree(path, self.gather_state(state))
        if self.model_axis is not None:
            local = self._shard_whole(full)
        else:
            specs, _ = self.train_shardings(full, {})
            local = self.shard(full, specs)
        return T.map(lambda x, t: x.to(t.device)
                     if isinstance(x, torch.Tensor) else x, local, state)

    def generate(self, params, prompts: torch.Tensor, *, gen: int,
                 sampler: Optional[str] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cache_len: Optional[int] = None,
                 extra_batch: Optional[dict] = None) -> torch.Tensor:
        """prompts: (B, P) int -> (B, gen) generated ids on the prompts'
        device.  The one-shot case of the serve subsystem
        (`repro_torch.serve.oneshot.OneShotGenerator`): one prefill, then
        the decode loop over the dense layout.  ``sampler`` is a `SAMPLERS`
        name; by default greedy at ``temperature <= 0`` and categorical
        above, drawing from ``generator``.  ``extra_batch``: a VLM's
        ``patches`` and ``mrope_positions``, an encoder-decoder's
        ``frames``.  For request streams (continuous batching, paged KV)
        use `repro_torch.serve.scheduler.Scheduler`, one process's only.

        On a bound mesh ``params`` are this rank's serve shards
        (`serve_params`) and ``prompts`` / ``extra_batch`` the whole
        batch: each data rank generates its rows (`serve_batch`) over the
        'model' axis, the (B, gen) tokens are all-gathered over the worker
        group in rank order, and every rank returns the whole batch.
        Greedy tokens are one process's; ``categorical`` draws each data
        rank's rows from its own ``generator`` (seed the model ranks'
        alike)."""
        if self._oneshot is None:
            self._oneshot = OneShotGenerator(self.model)
        local = self.serve_batch({"tokens": prompts, **(extra_batch or {})})
        out = self._oneshot(params, local.pop("tokens"), gen=gen,
                            sampler=sampler, temperature=temperature,
                            generator=generator, cache_len=cache_len,
                            extra_batch=local or None)
        if self.workers is None or self.workers.size == 1 \
                or self._data_axes(prompts.shape[0]) is None:
            return out
        import torch.distributed as dist
        src = out.cpu() if self.workers.host else out
        parts = [torch.empty_like(src) for _ in range(self.workers.size)]
        dist.all_gather(parts, src.contiguous(), group=self.workers.group)
        return torch.cat(parts).to(out.device)


# ---------------------------------------------------------------------------
# rebuilding the algorithm a checkpoint was trained with
# ---------------------------------------------------------------------------


def algorithm_for_checkpoint(path, *, algo: str = "dc_s3gd",
                             n_workers: int = 1,
                             local_optimizer: str = "momentum",
                             reducer: str = "mean_allreduce",
                             reducer_opts: Optional[dict] = None,
                             staleness: str = "fixed",
                             ssp_threshold: int = 4, buckets: int = 0,
                             plan_block: Optional[int] = None,
                             overlap: bool = False,
                             dc_cfg: Optional[DCS3GDConfig] = None
                             ) -> Tuple[Any, dict]:
    """The `DistributedOptimizer` that trained a checkpoint, and the
    resolved ``{algo, n_workers, local_optimizer, reducer, reducer_opts,
    staleness, ssp_threshold, buckets, overlap}``, and ``plan_block``
    where one was set (the reference's resolution has no such key).

    Metadata recorded by `Engine.save` wins; the keyword arguments are
    fallbacks for checkpoints written without it.  ``reducer_opts`` (the
    reducer's recorded ``hparams``) rebuild the exact topology or
    compressor."""
    meta = checkpoint_meta(path)
    resolved = {"algo": algo, "n_workers": n_workers,
                "local_optimizer": local_optimizer, "reducer": reducer,
                "reducer_opts": reducer_opts,
                "staleness": staleness, "ssp_threshold": ssp_threshold,
                "buckets": buckets, "overlap": overlap}
    if plan_block is not None:
        resolved["plan_block"] = plan_block
    for k in CKPT_ALGO_KEYS:
        if meta.get(k) is not None:
            resolved[k] = meta[k]
    cfg = dc_cfg if dc_cfg is not None else \
        DCS3GDConfig(local_optimizer=resolved["local_optimizer"],
                     ssp_threshold=int(resolved["ssp_threshold"]))
    red = registry.make_reducer(resolved["reducer"], cfg,
                                **(resolved["reducer_opts"] or {}))
    alg = registry.make(resolved["algo"], cfg,
                        n_workers=int(resolved["n_workers"]),
                        local_optimizer=resolved["local_optimizer"],
                        reducer=red, staleness=resolved["staleness"],
                        buckets=int(resolved["buckets"] or 0),
                        plan_block=resolved.get("plan_block"),
                        overlap=bool(resolved["overlap"] or False))
    return alg, resolved

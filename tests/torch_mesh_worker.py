"""The spawned ranks of `tests/test_torch_mesh.py` and
`tests/test_torch_mesh_reducers.py` (not a test file; it imports no jax,
so the ranks never load it).

`spawn` starts ``world`` processes, each with one torch thread and a gloo
process group met through a ``file://`` store under the test's
``tmp_path`` (no TCP port), runs one of `CASES` in each and returns each
rank's result, read back from a file the rank wrote (and deleted).  Rank
0 also makes each run with ``mesh=None`` from the same weights and
batches, the one-process port, and reports how far the mesh's gathered
state lies from it; only the runs the caller keeps travel back whole.
"""
from __future__ import annotations

import multiprocessing as mp
import traceback
import types
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.cluster import FaultSchedule, Membership
from repro_torch.configs import get_config, reduced
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.data.pipeline import (SyntheticImageDataset,
                                       SyntheticLMDataset, worker_batches)
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.models.cnn import cnn_loss_fn, init_resnet, resnet_apply
from repro_torch.models.transformer import Model

STEPS, BPW, SEQ = 3, 2, 16
# tests/test_torch_dc_s3gd.py's hyper-parameters
HP = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1)
CNN_NET = dict(stages=(1, 1), width=8, n_classes=8)
CNN_PER_WORKER = 4


def _numpy(tree):
    return T.map(lambda x: x.detach().cpu().numpy()
                 if isinstance(x, torch.Tensor) else np.asarray(x), tree)


# the keys of a run's spec that drive `Engine.fit`, not the algorithm
RUN_KEYS = ("skew", "elastic", "spread", "relayout", "steps", "model")


def _make(spec: dict, W: int):
    """The algorithm of a run's spec: ``algo`` (default dc_s3gd), ``cfg``
    (overrides of `HP`), ``reducer_opts`` (the reducer's constructor
    knobs), the rest registry keywords."""
    kw = {k: v for k, v in spec.items() if k not in RUN_KEYS}
    algo = kw.pop("algo", "dc_s3gd")
    cfg = DCS3GDConfig(**{**HP, **kw.pop("cfg", {})})
    opts = kw.pop("reducer_opts", None)
    if opts is not None:
        kw["reducer"] = registry.make_reducer(kw.get("reducer"), cfg, **opts)
    return registry.make(algo, cfg, n_workers=W, **kw)


class _PinnedMembership(Membership):
    """`Membership` that records, at each transition, whether
    ``eval_params`` after the resize is bitwise the value before it (on
    the resizing algorithm's own workers, which a resize onto another
    mesh binds to that mesh's), where this rank holds rows both before
    and after."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.pins = []

    def apply(self, events, state, *, step, workers=None):
        old = self.alg
        before = None if state is None else old.eval_params(state)
        state, changed = super().apply(events, state, step=step,
                                       workers=workers)
        if changed:
            after = None if state is None else old.eval_params(state)
            if before is not None and after is not None:
                self.pins.append(all(
                    torch.equal(x, y) for x, y in
                    zip(T.leaves(before), T.leaves(after))))
        return state, changed


def _fit_options(spec: dict, alg) -> dict:
    """`Engine.fit` keywords of a run's spec: ``skew`` = (slow, fast)
    scripted durations (worker 0 slow) under ``measure_skew``; ``elastic``
    = the events of a `FaultSchedule`."""
    kw = {}
    if "skew" in spec:
        slow, fast = spec["skew"]
        kw.update(measure_skew=True, skew_probe=lambda it, dt: [slow] + [
            fast] * (alg.n_workers - 1))
    if "elastic" in spec:
        kw["membership"] = _PinnedMembership(
            alg, faults=FaultSchedule.from_json(
                {"seed": 0, "events": spec["elastic"]}))
    return kw


def _relayout(model, alg, params, batch_of, steps, spec) -> dict:
    """An elastic run over the mesh `launch.mesh.mesh_for_spec` lays each
    membership on, on every rank of the world: ``Engine.fit`` to each
    transition step, then `Membership.sync`, ``poll``, ``preview``, the
    new mesh, ``apply`` onto its worker seam and a new Engine over it.
    Returns the last segment's state and Engine, the metrics, and per
    segment this rank's ``[W, steps taken, A1 launches, A2 launches,
    whether it holds rows, the mesh's shape, whether the mesh is one
    built earlier in the run]``."""
    from repro_torch.kernels import dc_update as KD
    from repro_torch.launch import mesh as M
    mem = _fit_options(spec, alg)["membership"]
    tp = spec.get("model", 1)
    mesh = M.mesh_for_spec(mem.spec, model=tp, device_type="cpu")
    engine = Engine(model, alg, mesh=mesh)
    state = engine.init_state(params)
    hist, segments, t, built = [], [], 0, []
    for b in sorted({e["step"] for e in spec["elastic"]
                     if e["step"] < steps}) + [steps]:
        KD.dc_norms.launches = KD.dc_fused_update.launches = 0
        state, h, _ = engine.fit(state, batch_of, steps=b, start=t,
                                 log_every=1, membership=mem)
        segments.append([mem.n_workers, len(h), KD.dc_norms.launches,
                         KD.dc_fused_update.launches, M.holds_rows(mesh),
                         dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
                         any(mesh is m for m in built)])
        built.append(mesh)
        hist += h
        if b == steps:
            break
        mem.sync()
        events = mem.poll(b)
        mesh = M.mesh_for_spec(mem.preview(events), model=tp,
                               device_type="cpu")
        state, _ = mem.apply(events, state, step=b,
                             workers=M.make_workers(mesh))
        engine = Engine(model, mem.alg, mesh=mesh)
        t = b
    return {"state": state, "engine": engine, "hist": hist,
            "segments": segments, "membership": mem}


def _run(model, alg, params, batch_of, mesh, steps, ckpt=None, fit=None):
    """``steps`` steps through `Engine.fit` (which takes this rank's rows
    of each global batch); returns the gathered state as numpy and the
    per-step metrics.  With ``ckpt`` (a path) the state also goes through
    `Engine.save` / `Engine.restore`, and ``restored`` says whether this
    rank got its shards back bit for bit.  ``fit``: the run's spec, whose
    `RUN_KEYS` become `Engine.fit` keywords (an elastic run also reports
    its ``pins`` and its ``log``)."""
    if mesh is not None and (fit or {}).get("relayout"):
        got = _relayout(model, alg, params, batch_of, steps, fit)
        engine, state = got["engine"], got["state"]
        full = engine.gather_state(state)
        ev = engine.alg.eval_params(state)
        if engine.model_axis is not None:
            # the consensus of this rank's shards, whole over 'model'
            from repro_torch.parallel.tensor import gather_leaves, model_dims
            leaves, treedef = T.flatten(ev)
            ev = T.unflatten(treedef, gather_leaves(
                engine.model_axis, leaves,
                model_dims(engine.model_axis, engine.model.cfg, ev)))
        return {"params": _numpy(full.params), "opt": _numpy(full.opt),
                "comm": _numpy({k: v for k, v in full.comm.items()
                                if k != "pipeline"}),
                "eval": _numpy(ev),
                "hist": [{k: v for k, v in m.items() if k != "wall_s"}
                         for m in got["hist"]],
                "pins": got["membership"].pins,
                "log": got["membership"].log,
                "segments": got["segments"]}
    engine = Engine(model, alg, mesh=mesh)
    state = engine.init_state(params)
    if (fit or {}).get("spread") is not None:
        # per-worker starting weights (W, ...): this rank's rows
        rows = alg.workers.rows(alg.n_workers)
        lo = alg.workers.rank * rows
        state = state._replace(params=T.map(
            lambda x: x[lo:lo + rows].clone(),
            params_from_numpy(fit["spread"], device="cpu")))
    kw = _fit_options(fit or {}, alg)
    state, hist, _ = engine.fit(state, batch_of, steps=steps, log_every=1,
                                **kw)
    alg = engine.alg
    full = engine.gather_state(state)
    out = {"params": _numpy(full.params), "opt": _numpy(full.opt),
           "comm": _numpy({k: v for k, v in full.comm.items()
                           if k != "pipeline"}),
           "eval": _numpy(alg.eval_params(state)),
           "hist": [{k: v for k, v in m.items() if k != "wall_s"}
                    for m in hist]}
    if "membership" in kw:
        out["pins"] = kw["membership"].pins
        out["log"] = kw["membership"].log
    if ckpt is not None:
        engine.save(ckpt, state, step=steps)
        back = engine.restore(ckpt, state)
        out["restored"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor)
            else bool(np.array_equal(a, b))
            for a, b in zip(T.leaves(back), T.leaves(state)))
    return out


def run_lm(spec: dict, W: int, weights, mesh=None, steps: int = None,
           ckpt=None, spread=None):
    """The reduced qwen3-0.6b from ``weights`` (a numpy tree), ``W``
    workers, tests/test_torch_dc_s3gd.py's batches, for ``steps``
    (default: the spec's ``steps``, else `STEPS`)."""
    steps = spec.get("steps", STEPS) if steps is None else steps
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg, remat=False)
    data = SyntheticLMDataset(cfg.vocab_size, SEQ, seed=0)
    return _run(model, _make(spec, W), params_from_numpy(weights,
                                                         device="cpu"),
                lambda t, w=W: worker_batches(data, t, w, BPW, device="cpu"),
                mesh, steps, ckpt,
                {**spec, "spread": spread} if spec.get("spread") else spec)


def run_cnn(spec: dict, W: int, mesh=None, steps: int = None):
    """The reduced ResNet of the CNN example, seed 0, ``W`` workers, for
    ``steps`` (default: the spec's ``steps``, else `STEPS`)."""
    steps = spec.get("steps", STEPS) if steps is None else steps
    params = init_resnet(torch.Generator().manual_seed(0), **CNN_NET)
    data = SyntheticImageDataset(CNN_NET["n_classes"], image_size=16,
                                 seed=0, noise=0.4)
    model = types.SimpleNamespace(loss=cnn_loss_fn(resnet_apply))
    return _run(model, _make(spec, W), params,
                lambda t, w=W: worker_batches(data, t, w, CNN_PER_WORKER,
                                              device="cpu"),
                mesh, steps, fit=spec)


def _mesh(layout, world):
    from repro_torch.launch import mesh as M
    if layout == "pods":
        from repro_torch.cluster import ClusterSpec
        return M.mesh_for_spec(ClusterSpec.uniform(2 * world, pods=2),
                               device_type="cpu")
    return M.make_debug_mesh(world, 1, device_type="cpu")


PARTS = ("params", "opt", "comm", "eval")


def _compare(a, b, scales=None) -> tuple:
    """(the largest over leaves of max|a − b| / max|b|, bitwise equal?);
    ``scales``: per leaf, a larger scale to divide by."""
    worst, same = 0.0, True
    lb = T.leaves(b)
    scales = scales or [0.0] * len(lb)
    for x, y, s in zip(T.leaves(a), lb, scales):
        same = same and x.dtype == y.dtype and np.array_equal(x, y)
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        scale = max(float(np.abs(y).max()) if y.size else 0.0, s)
        if scale:
            worst = max(worst, float(np.abs(x - y).max()) / scale)
    return worst, bool(same)


def _compare_comm(a, b) -> tuple:
    """`_compare` of the carried wire state, where an error-feedback
    residual (what compression left of the payload Δw + residual, whose
    own largest value is about the selection threshold) is held at the
    scale of its bucket's payload, the carried delta's."""
    if "reducer" not in b or "delta_prev" not in b:
        return _compare(a, b)
    rest = [k for k in b if k != "reducer"]
    w0, s0 = _compare({k: a[k] for k in rest}, {k: b[k] for k in rest})
    scales = [float(np.abs(np.asarray(d)).max()) for d in b["delta_prev"]]
    w1, s1 = _compare(a["reducer"]["residual"], b["reducer"]["residual"],
                      scales)
    keys = [k for k in b["reducer"] if k != "residual"]
    w2, s2 = _compare({k: a["reducer"][k] for k in keys},
                      {k: b["reducer"][k] for k in keys})
    return max(w0, w1, w2), s0 and s1 and s2


def _digest(res) -> str:
    import hashlib
    h = hashlib.sha256()
    for part in PARTS:
        for x in T.leaves(res[part]):
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def case_runs(world, *, runs, layout="data", weights=None, keep=(),
              ckpt_dir=None, spread=None):
    """Every ``(model, spec, W)`` of ``runs`` (``model``: "lm" or "cnn")
    on this rank's mesh: each rank's metrics and a digest of the
    gathered state; rank 0 adds, per part, `_compare` against the
    one-process run, that run's metrics, and the whole gathered state of
    the runs whose index is in ``keep``, which (with ``ckpt_dir``) also
    go through a checkpoint and report ``restored``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import worker_index
    mesh = _mesh(layout, world)
    out = []

    def one(model, spec, W, m, ckpt=None):
        return run_lm(spec, W, weights, m, ckpt=ckpt, spread=spread) \
            if model == "lm" else run_cnn(spec, W, m)
    for i, (model, spec, W) in enumerate(runs):
        ckpt = f"{ckpt_dir}/run{i}.npz" \
            if ckpt_dir is not None and i in keep else None
        got = one(model, spec, W, mesh, ckpt)
        if ckpt is not None:
            dist.barrier()
            if worker_index(mesh) == 0:
                Path(ckpt).unlink()
        rec = {"hist": got["hist"], "digest": _digest(got),
               "restored": got.get("restored"), "pins": got.get("pins"),
               "log": got.get("log"), "segments": got.get("segments")}
        if worker_index(mesh) == 0:
            want = one(model, spec, W, None)
            rec["diff"] = {p: (_compare_comm if p == "comm" else _compare)(
                got[p], want[p]) for p in PARTS}
            rec["hist_one"] = want["hist"]
            rec["log_one"] = want.get("log")
            if i in keep:
                rec["state"] = got
        out.append(rec)
    return {"runs": out, "worker_index": worker_index(mesh),
            "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}


# ---------------------------------------------------------------------------
# one call of each reducer on a seeded wire (tests/test_torch_mesh_reducers.py)
# ---------------------------------------------------------------------------


class _Plan:
    def __init__(self, sizes):
        self.bucket_sizes = tuple(sizes)


def _reducer_inputs(W: int, sizes, seed: int):
    """The (W, n) wire and residual buckets, from a numpy seed: heavy
    tailed, so the top-k selections are not ties."""
    rng = np.random.default_rng(seed)

    def draw(n):
        return torch.from_numpy((rng.standard_normal((W, n))
                                 * rng.random((W, n)) ** 3)
                                .astype(np.float32))
    return [draw(n) for n in sizes], [draw(n) * 0.1 for n in sizes]


def _reducer_call(name, opts, W, sizes, seed, workers):
    """One call of reducer ``name`` (with ``opts``; ``use_kernels`` routes
    topk / topk_exact through B3's wrapper) bound to ``workers``, on this
    rank's rows of the seeded wire: ``(out, new_state)``."""
    from repro_torch.core.reduce import LOCAL
    opts = dict(opts)
    kernels = opts.pop("use_kernels", False)
    red = registry.make_reducer(name, DCS3GDConfig(**HP), **opts)
    red.workers = workers
    if kernels:
        red.use_kernels = True
    wire, res = _reducer_inputs(W, sizes, seed)
    lo = workers.rank * workers.rows(W) if workers is not LOCAL else 0
    hi = lo + workers.rows(W)
    wire = [w[lo:hi] for w in wire]
    if getattr(red, "stateless", True):
        return red(wire), None
    state = red.init(W, _Plan(sizes))
    state["residual"] = [r[lo:hi].clone() for r in res]
    return red(wire, state)


def _rows_of(x, mesh_workers, mean_style: bool):
    """The global rows of a rank's (W / R, n) tensor (all-gathered);
    a mean-style (1, n) output is already global."""
    import torch.distributed as dist
    if mean_style:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh_workers.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh_workers.group)
    return torch.cat(parts)


def case_reducers(world, *, reducers, W, sizes, seed=0, layout="data"):
    """Every ``name: (registry name, opts)`` of ``reducers`` once on the
    seeded wire: rank 0 reports, per reducer, `_compare` of the gathered
    output and new residual against the one-process call; every rank the
    digests of what must be the same on every rank (a mean-style output,
    powersgd's warm start)."""
    from repro_torch.core.reduce import LOCAL
    from repro_torch.launch import mesh as M
    mesh = _mesh(layout, world)
    wk = M.make_workers(mesh)
    out = {}
    for key, (name, opts) in reducers.items():
        got, st = _reducer_call(name, opts, W, sizes, seed, wk)
        red = registry.make_reducer(name, DCS3GDConfig(**HP))
        mean_style = not getattr(red, "reduces_weights", False)
        rec = {"shared": _digest_tree(
            (got if mean_style else []) + list((st or {}).get("q", [])))}
        got = [_rows_of(o, wk, mean_style) for o in T.leaves(got)]
        res = [] if st is None else [_rows_of(r, wk, False)
                                      for r in st["residual"]]
        if wk.rank == 0:
            want, wst = _reducer_call(name, opts, W, sizes, seed, LOCAL)
            rec["out"] = _compare(_numpy(got), _numpy(T.leaves(want)))
            if st is not None:
                rec["res"] = _compare(_numpy(res), _numpy(wst["residual"]))
            if st is not None and "q" in st:
                rec["q"] = _compare(_numpy(st["q"]), _numpy(wst["q"]))
        out[key] = rec
    return out


def _digest_tree(tree) -> str:
    import hashlib
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def case_suite(world, *, reducers=None, reducer_kw=None, cut=None,
               **runs_kw):
    """`case_reducers` and `case_runs` in one group of ranks (one spawn
    per world size); ``cut``: a second set of reducer calls, ``(reducers,
    reducer_kw)`` at another W (hierarchical groups across ranks)."""
    res = {"reducers": case_reducers(world, reducers=reducers,
                                     **reducer_kw)} if reducers else {}
    if cut:
        res["cut"] = case_reducers(world, reducers=cut[0], **cut[1])
    res.update(case_runs(world, **runs_kw))
    return res


CASES = {"runs": case_runs, "reducers": case_reducers, "suite": case_suite}


def _entry(rank, world, store, case, kwargs, out, module=None):
    torch.set_num_threads(1)
    import importlib
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group
    cases = CASES if module is None else \
        importlib.import_module(module).CASES
    try:
        init_process_group(device_type="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=world)
        res = cases[case](world, **kwargs)
    except Exception:  # noqa: BLE001 — reported to the parent
        res = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(res, out)


def spawn(world: int, case: str, kwargs: dict, tmp: Path,
          timeout: float = 300.0, module: str = None) -> list:
    """Run ``CASES[case]`` on ``world`` spawned gloo ranks; their results
    in rank order.  A rank's exception fails the caller with its
    traceback.  ``module`` names another module whose ``CASES`` to run
    (it must import no jax either)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    store = tmp / "store"
    procs = [ctx.Process(target=_entry,
                         args=(r, world, str(store), case, kwargs,
                               str(tmp / f"rank{r}.pt"), module))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    res = []
    for r in range(world):
        f = tmp / f"rank{r}.pt"
        res.append(torch.load(f, weights_only=False))
        f.unlink()
    for r, x in enumerate(res):
        assert "error" not in x, f"rank {r}:\n{x['error']}"
    return res

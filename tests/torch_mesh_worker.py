"""The spawned ranks of `tests/test_torch_mesh.py` (not a test file; it
imports no jax, so the ranks never load it).

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


def _make(spec: dict, W: int):
    kw = dict(spec)
    algo = kw.pop("algo", "dc_s3gd")
    return registry.make(algo, DCS3GDConfig(**HP), n_workers=W, **kw)


def _run(model, alg, params, batch_of, mesh, steps, ckpt=None):
    """``steps`` steps through `Engine.fit` (which takes this rank's rows
    of each global batch); returns the gathered state as numpy and the
    per-step metrics.  With ``ckpt`` (a path) the state also goes through
    `Engine.save` / `Engine.restore`, and ``restored`` says whether this
    rank got its shards back bit for bit."""
    engine = Engine(model, alg, mesh=mesh)
    state = engine.init_state(params)
    state, hist, _ = engine.fit(state, batch_of, steps=steps, log_every=1)
    full = engine.gather_state(state)
    out = {"params": _numpy(full.params), "opt": _numpy(full.opt),
           "comm": _numpy({k: v for k, v in full.comm.items()
                           if k != "pipeline"}),
           "eval": _numpy(alg.eval_params(state)),
           "hist": [{k: v for k, v in m.items() if k != "wall_s"}
                    for m in hist]}
    if ckpt is not None:
        engine.save(ckpt, state, step=steps)
        back = engine.restore(ckpt, state)
        out["restored"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor)
            else bool(np.array_equal(a, b))
            for a, b in zip(T.leaves(back), T.leaves(state)))
    return out


def run_lm(spec: dict, W: int, weights, mesh=None, steps: int = STEPS,
           ckpt=None):
    """The reduced qwen3-0.6b from ``weights`` (a numpy tree), ``W``
    workers, tests/test_torch_dc_s3gd.py's batches."""
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, SEQ, seed=0)
    return _run(model, _make(spec, W), params_from_numpy(weights,
                                                         device="cpu"),
                lambda t: worker_batches(data, t, W, BPW, device="cpu"),
                mesh, steps, ckpt)


def run_cnn(spec: dict, W: int, mesh=None, steps: int = STEPS):
    """The reduced ResNet of the CNN example, seed 0, ``W`` workers."""
    params = init_resnet(torch.Generator().manual_seed(0), **CNN_NET)
    data = SyntheticImageDataset(CNN_NET["n_classes"], image_size=16,
                                 seed=0, noise=0.4)
    model = types.SimpleNamespace(loss=cnn_loss_fn(resnet_apply))
    return _run(model, _make(spec, W), params,
                lambda t: worker_batches(data, t, W, CNN_PER_WORKER,
                                         device="cpu"),
                mesh, steps)


def _mesh(layout, world):
    from repro_torch.launch import mesh as M
    if layout == "pods":
        from repro_torch.cluster import ClusterSpec
        return M.mesh_for_spec(ClusterSpec.uniform(2 * world, pods=2),
                               device_type="cpu")
    return M.make_debug_mesh(world, 1, device_type="cpu")


PARTS = ("params", "opt", "comm", "eval")


def _compare(a, b) -> tuple:
    """(the largest over leaves of max|a − b| / max|b|, bitwise equal?)."""
    worst, same = 0.0, True
    for x, y in zip(T.leaves(a), T.leaves(b)):
        same = same and x.dtype == y.dtype and np.array_equal(x, y)
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        scale = float(np.abs(y).max()) if y.size else 0.0
        if scale:
            worst = max(worst, float(np.abs(x - y).max()) / scale)
    return worst, bool(same)


def _digest(res) -> str:
    import hashlib
    h = hashlib.sha256()
    for part in PARTS:
        for x in T.leaves(res[part]):
            h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def case_runs(world, *, runs, layout="data", weights=None, keep=(),
              ckpt_dir=None):
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
        return run_lm(spec, W, weights, m, ckpt=ckpt) if model == "lm" \
            else run_cnn(spec, W, m)
    for i, (model, spec, W) in enumerate(runs):
        ckpt = f"{ckpt_dir}/run{i}.npz" \
            if ckpt_dir is not None and i in keep else None
        got = one(model, spec, W, mesh, ckpt)
        if ckpt is not None:
            dist.barrier()
            if worker_index(mesh) == 0:
                Path(ckpt).unlink()
        rec = {"hist": got["hist"], "digest": _digest(got),
               "restored": got.get("restored")}
        if worker_index(mesh) == 0:
            want = one(model, spec, W, None)
            rec["diff"] = {p: _compare(got[p], want[p]) for p in PARTS}
            rec["hist_one"] = want["hist"]
            if i in keep:
                rec["state"] = got
        out.append(rec)
    return {"runs": out, "worker_index": worker_index(mesh),
            "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))}


CASES = {"runs": case_runs}


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

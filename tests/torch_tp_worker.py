"""The spawned ranks of `tests/test_torch_tensor_parallel.py` (not a test
file; it imports no jax, so the ranks never load it).

`tests/torch_mesh_worker.spawn` starts the ranks (gloo, one torch thread,
a ``file://`` store under the test's ``tmp_path``) and runs one of
`CASES` here in each.  Every rank trains each run of its case over a
('data', 'model') mesh and reports what only it can see (its local
shapes, a digest of its replicated leaves after every step, its
per-leaf gradients' distance from the one-process ones); rank 0 also
runs each configuration with ``mesh=None`` from the same weights and
reports how far the gathered state lies from it, and returns the
gathered states the caller holds against the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.models.transformer import Model, chunked_xent
from repro_torch.parallel import sharding as shd

import torch_mesh_worker as MW

# the four configurations of the slice, reduced: qk norm and GQA; one KV
# head (replicated k / v); layernorm; routed experts
ARCHS = {"qwen3": "qwen3-0.6b", "granite": "granite-20b",
         "stablelm": "stablelm-3b", "olmoe": "olmoe-1b-7b"}


def config(name: str):
    """A reduced config by name; ``<name>_bf16`` computes in bf16 (the
    published configs' compute dtype) from the same f32 weights."""
    base, _, dt = name.partition("_")
    cfg = reduced(get_config(ARCHS[base]))
    return dataclasses.replace(cfg, compute_dtype="bfloat16") if dt else cfg


def _digest(xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _replicated_digest(engine, state) -> str:
    """A digest of every leaf (bucket) this rank holds whole: params, opt
    and the carried deltas of the leaves the rules replicate over
    'model'."""
    alg = engine.alg
    flags = shd.sharded_over_model(engine.model.cfg, state.params,
                                   model_size=engine.model_axis.size)
    xs = [x for f, x in zip(flags, T.leaves(state.params)) if not f]
    xs += [x for f, x in zip(flags, T.leaves(state.opt["m"])) if not f]
    dp = state.comm.get("delta_prev")
    if isinstance(dp, list):
        xs += [b for f, b in zip(alg._plan(state.params).sharded, dp)
               if not f]
    elif dp is not None:
        xs += [x for f, x in zip(flags, T.leaves(dp)) if not f]
    return _digest(xs)


def _whole_tree(engine, tree):
    """A (local) param-shaped tree gathered over 'model'."""
    import torch.distributed as dist
    axis = engine.model_axis
    dims = engine._model_dims(tree)

    def gather(path, x):
        d = dims[path]
        if d is None:
            return x
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=d)
    return shd.map_with_path(gather, tree)


def _rel(a, b) -> float:
    """The largest over leaves of max|a − b| / max|b|."""
    worst = 0.0
    for x, y in zip(T.leaves(a), T.leaves(b)):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        scale = float(np.abs(y).max()) if y.size else 0.0
        if scale:
            worst = max(worst, float(np.abs(x - y).max()) / scale)
    return worst


def _grads(model, params, batch):
    p = [x.detach().requires_grad_() for x in T.leaves(params)]
    tree = T.unflatten(T.flatten(params)[1], p)
    loss = model.loss(tree, batch)
    return T.unflatten(T.flatten(params)[1],
                       list(torch.autograd.grad(loss, p))), loss.detach()


def _run(name, spec, W, weights, mesh, steps, ckpt):
    """One configuration ``steps`` steps through `Engine.fit` on ``mesh``;
    returns (what this rank reports, the gathered state as numpy)."""
    cfg = config(name)
    params = params_from_numpy(weights, device="cpu")
    data = SyntheticLMDataset(cfg.vocab_size, MW.SEQ, seed=0)

    def batch_of(t):
        return worker_batches(data, t, W, MW.BPW, device="cpu")
    alg = MW._make(spec, W)
    engine = Engine(Model(cfg), alg, mesh=mesh)
    state = engine.init_state(params)
    rec = {}
    if mesh is not None:
        axis = engine.model_axis
        # each leaf held as `local_slices` cuts it from the whole tree
        specs = dict(shd.flat_specs(shd.param_specs(
            cfg, params, model_size=axis.size), params))
        want = [tuple(x[shd.local_slices(
            tuple(x.shape), tuple(e if e == "model" else None
                                  for e in specs[p]),
            {"model": axis.size}, {"model": axis.rank})].shape)
            for p, x in shd.leaves_with_path(params)]
        lead = 1 if getattr(alg, "worker_stacked", False) else 0
        rec["local_shapes_ok"] = want == [tuple(x.shape[lead:]) for x in
                                          T.leaves(state.params)]
        rec["n_sharded"] = sum(shd.sharded_over_model(
            cfg, params, model_size=axis.size))
        # per-leaf gradients of worker 0's first batch, gathered
        b0 = T.map(lambda x: x[0], engine.local_batch(batch_of(0)))
        p0 = T.map(lambda x: x[0], state.params) if lead else state.params
        g, loss = _grads(engine.model, p0, b0)
        rec["grads"] = MW._numpy(_whole_tree(engine, g))
        rec["grad_loss"] = float(loss)
        # the vocabulary's columns gathered over the axis
        with torch.no_grad():
            rec["logits"] = engine.model.logits(p0, b0).numpy()
    hist, digests = [], []
    for t in range(steps):
        state, h, _ = engine.fit(state, batch_of, steps=t + 1, start=t,
                                 log_every=1)
        hist += [{k: v for k, v in m.items() if k != "wall_s"} for m in h]
        if mesh is not None:
            digests.append(_replicated_digest(engine, state))
    full = engine.gather_state(state)
    out = {"params": MW._numpy(full.params), "opt": MW._numpy(full.opt),
           "comm": MW._numpy(full.comm)}
    rec.update(hist=hist, digests=digests,
               digest=MW._digest({**out, "eval": {}}))
    if ckpt is not None:
        engine.save(ckpt, state, step=steps)
        back = engine.restore(ckpt, state)
        rec["restored"] = all(torch.equal(a, b) for a, b in zip(
            T.leaves(back.params) + T.leaves(back.opt)
            + T.leaves(back.comm), T.leaves(state.params)
            + T.leaves(state.opt) + T.leaves(state.comm)))
    return rec, out


def _one_process(name, spec, W, weights, steps, ckpt):
    """The same run with ``mesh=None``, and worker 0's gradients of the
    first batch; with ``ckpt`` also the file the mesh wrote, restored
    into this run's structure."""
    rec, state = _run(name, spec, W, weights, None, steps, None)
    cfg = config(name)
    if ckpt is not None:
        engine = Engine(Model(cfg), MW._make(spec, W))
        tmpl = engine.init_state(params_from_numpy(weights, device="cpu"))
        back = engine.restore(ckpt, tmpl)
        rec["restored_state"] = {"params": MW._numpy(back.params),
                                 "opt": MW._numpy(back.opt),
                                 "comm": MW._numpy(back.comm)}
    data = SyntheticLMDataset(cfg.vocab_size, MW.SEQ, seed=0)
    params = params_from_numpy(weights, device="cpu")
    b0 = T.map(lambda x: x[0], worker_batches(data, 0, W, MW.BPW,
                                             device="cpu"))
    grads, loss = _grads(Model(cfg), params, b0)
    rec["grads"] = MW._numpy(grads)
    rec["grad_loss"] = float(loss)
    with torch.no_grad():
        rec["logits"] = Model(cfg).logits(params, b0).numpy()
    return rec, state


def case_tp(world, *, shape, runs, weights, keep=(), ckpt_dir=None,
            steps=MW.STEPS):
    """Every ``(config, spec, W)`` of ``runs`` on a ('data', 'model') mesh
    of ``shape``.  Each rank: its records (`_run`); rank 0 adds, per part,
    the distance from the one-process run, that run's metrics and
    gradients' distance, and the gathered states of ``keep``'s runs, which
    (with ``ckpt_dir``) are also saved under the mesh and restored with
    ``mesh=None``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(*shape, device_type="cpu")
    first = dist.get_rank() == 0
    out = []
    for i, (name, spec, W) in enumerate(runs):
        ckpt = f"{ckpt_dir}/tp{i}.npz" \
            if ckpt_dir is not None and i in keep else None
        rec, got = _run(name, spec, W, weights[name], mesh, steps, ckpt)
        if first:
            one, want = _one_process(name, spec, W, weights[name], steps,
                                     ckpt)
            rec["diff"] = {p: MW._compare(got[p], want[p])
                           for p in ("params", "opt", "comm")}
            rec["grad_diff"] = _rel(rec.pop("grads"), one["grads"])
            rec["logits_diff"] = _rel(rec.pop("logits"), one["logits"])
            rec["grad_loss_one"] = one["grad_loss"]
            rec["hist_one"] = one["hist"]
            if ckpt is not None:
                rec["ckpt_bitwise"] = all(
                    MW._compare(got[p], one["restored_state"][p])[1]
                    for p in ("params", "opt", "comm"))
            if i in keep:
                rec["state"] = got
        else:
            rec.pop("grads", None)
            rec.pop("logits", None)
        out.append(rec)
        if ckpt is not None:
            dist.barrier()
    return {"runs": out, "model_index": M.model_index(mesh),
            "worker_index": M.worker_index(mesh)}


def case_xent(world, *, vocab, d, chunk):
    """Vocab-parallel `chunked_xent` against the one-process loss: random
    x, an unembedding of ``vocab`` columns (padded to a multiple of 256
    first, the padded columns inside the logsumexp as the model's are),
    labels with masked (-1) positions; the loss and the gradients of x
    and of this rank's columns."""
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(1, world, device_type="cpu")
    axis = M.model_axis(mesh)
    gen = torch.Generator().manual_seed(0)
    vp = -(-vocab // 256) * 256
    x = torch.randn(2, 7, d, generator=gen)
    w = torch.randn(d, vp, generator=gen) * 0.5
    labels = torch.randint(0, vocab, (2, 7), generator=gen)
    labels[0, 2] = labels[1, 5] = -1
    labels[1, 0] = vocab - 1
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = chunked_xent(xa, wa, labels, chunk)
    gx, gw = torch.autograd.grad(want, (xa, wa))
    lo = axis.shard_start(vp // world)
    hi = lo + vp // world
    xb = x.clone().requires_grad_()
    wb = w[:, lo:hi].clone().requires_grad_()
    got = chunked_xent(xb, wb, labels, chunk, axis)
    hx, hw = torch.autograd.grad(got, (xb, wb))
    return {"loss": float(got), "loss_one": float(want),
            "gx": float((hx - gx).abs().max() / gx.abs().max()),
            "gw": float((hw - gw[:, lo:hi]).abs().max()
                        / gw.abs().max())}


def case_cnn(world, *, spec, W):
    """The paper's CNN (no `ModelConfig`: replicated over 'model') on a
    (1, ``world``) mesh: a digest of the gathered state on every rank;
    rank 0 adds `_compare` against the one-process run."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(1, world, device_type="cpu")
    got = MW.run_cnn(spec, W, mesh)
    rec = {"digest": MW._digest(got), "hist": got["hist"]}
    if dist.get_rank() == 0:
        want = MW.run_cnn(spec, W, None)
        rec["diff"] = {p: MW._compare(got[p], want[p]) for p in MW.PARTS}
        rec["hist_one"] = want["hist"]
    return rec


CASES = {"tp": case_tp, "xent": case_xent, "cnn": case_cnn}

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
from repro_torch.parallel.tensor import gather_leaves, model_dims

import torch_mesh_worker as MW

# the configurations, reduced: qk norm and GQA; one KV head (replicated
# k / v); layernorm; routed experts; Mamba; RG-LRU + windowed attention
# on one KV head; MLA; an encoder-decoder (bidirectional encoder, cross
# attention); a VLM (the patch projection, M-RoPE); a second MoE (GQA)
ARCHS = {"qwen3": "qwen3-0.6b", "granite": "granite-20b",
         "stablelm": "stablelm-3b", "olmoe": "olmoe-1b-7b",
         "mamba": "falcon-mamba-7b", "rgemma": "recurrentgemma-9b",
         "minicpm": "minicpm3-4b", "whisper": "whisper-large-v3",
         "qwen2vl": "qwen2-vl-7b", "phi": "phi3.5-moe-42b-a6.6b"}


def config(name: str):
    """A reduced config by name; ``<name>_bf16`` computes in bf16 (the
    published configs' compute dtype) from the same f32 weights;
    ``<name>_dense`` is the same config (the model takes the MoE
    oracle, `make_model`)."""
    base, _, var = name.partition("_")
    cfg = reduced(get_config(ARCHS[base]))
    return dataclasses.replace(cfg, compute_dtype="bfloat16") \
        if var == "bf16" else cfg


def make_model(name: str) -> Model:
    """The port's model of ``name``: ``<name>_dense`` takes the
    all-experts MoE oracle (``moe_dense``)."""
    return Model(config(name), remat=False,
                 moe_dense=name.endswith("_dense"))


def extras(cfg, t: int, W: int) -> dict:
    """The batch's inputs besides the tokens, numpy from a seed of the
    step ``t``: an encoder-decoder's frames (W, b, n_frames, d); a VLM's
    patch embeddings (W, b, n_patches, d) and M-RoPE positions (W, 3,
    n_patches + S), their t / h / w components distinct."""
    rng = np.random.default_rng(1000 + t)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (W, MW.BPW, cfg.encoder.n_frames, cfg.d_model)).astype(
                np.float32)
    if cfg.vlm is not None:
        n = cfg.vlm.n_patches
        out["patches"] = rng.standard_normal(
            (W, MW.BPW, n, cfg.d_model)).astype(np.float32)
        pos = np.arange(n + MW.SEQ)
        out["mrope_positions"] = np.broadcast_to(
            np.stack([pos, pos // 2, pos % 5]), (W, 3, n + MW.SEQ)).copy()
    return out


def batches(name: str, W: int):
    """``batch_of(t, w=W)``: the step's token batch (`worker_batches`) of
    ``w`` workers (an elastic run's live count) and `extras`, torch on
    the CPU."""
    cfg = config(name)
    data = SyntheticLMDataset(cfg.vocab_size, MW.SEQ, seed=0)

    def batch_of(t, w=W):
        b = worker_batches(data, t, w, MW.BPW, device="cpu")
        b.update({k: torch.from_numpy(v) for k, v in extras(cfg, t,
                                                            w).items()})
        return b
    return batch_of


def _digest(xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _replicated_digest(engine, state) -> str:
    """A digest of every leaf (bucket) this rank holds whole: params, opt
    and the carried deltas of the leaves the rules replicate over
    'model', a compressed reducer's state (whole on every model rank:
    residuals, randk's counter and the coordinates of its last draw,
    powersgd's warm start)."""
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
    rs = state.comm.get("reducer")
    if rs is not None:
        xs += [x if isinstance(x, torch.Tensor) else torch.tensor(x)
               for x in T.leaves(rs)]
        if hasattr(alg.reducer, "support"):
            xs += [alg.reducer.support(b, r.shape[-1], rs["step"] - 1,
                                       r.device)
                   for b, r in enumerate(rs["residual"])]
    return _digest(xs)


def _whole_tree(engine, tree):
    """A (local) param-shaped tree gathered over 'model'."""
    axis = engine.model_axis
    leaves, treedef = T.flatten(tree)
    return T.unflatten(treedef, gather_leaves(
        axis, leaves, model_dims(axis, engine.model.cfg, tree)))


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
    returns (what this rank reports, the gathered state as numpy).  A
    spec with ``skew`` (a scripted straggler, `MW._fit_options`) runs
    one `Engine.fit` over every step, so the measured clocks carry
    across them, and reports its staleness counters."""
    cfg = config(name)
    params = params_from_numpy(weights, device="cpu")
    batch_of = batches(name, W)
    alg = _alg(spec, W)
    engine = Engine(make_model(name), alg, mesh=mesh)
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
    fit = MW._fit_options(spec, alg)
    for t in range(steps) if not fit else (steps - 1,):
        state, h, _ = engine.fit(state, batch_of, steps=t + 1,
                                 start=0 if fit else t, log_every=1, **fit)
        hist += [{k: v for k, v in m.items() if k != "wall_s"} for m in h]
        if mesh is not None:
            digests.append(_replicated_digest(engine, state))
    if "staleness" in state.comm:
        rec["worker_steps"] = state.comm["staleness"][
            "worker_steps"].tolist()
    full = engine.gather_state(state)
    out = {"params": MW._numpy(full.params), "opt": MW._numpy(full.opt),
           "comm": MW._numpy(full.comm)}
    rec.update(hist=hist, digests=digests,
               digest=MW._digest({**out, "eval": {}}),
               # the trajectory without the overlap pipeline's buffers
               # and a stateful reducer's state (one call ahead of the
               # inline run's under overlap)
               trajectory=MW._digest({
                   "params": out["params"], "opt": out["opt"],
                   "comm": {k: v for k, v in out["comm"].items()
                            if k not in ("pipeline", "reducer")},
                   "eval": {}}))
    if ckpt is not None:
        engine.save(ckpt, state, step=steps)
        back = engine.restore(ckpt, state)
        rec["restored"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor)
            else bool(np.array_equal(a, b)) for a, b in zip(
            T.leaves(back.params) + T.leaves(back.opt)
            + T.leaves(back.comm), T.leaves(state.params)
            + T.leaves(state.opt) + T.leaves(state.comm)))
    return rec, out


def _one_process(name, spec, W, weights, steps, ckpt):
    """The same run with ``mesh=None``, and worker 0's gradients of the
    first batch; with ``ckpt`` also the file the mesh wrote, restored
    into this run's structure."""
    rec, state = _run(name, spec, W, weights, None, steps, None)
    if ckpt is not None:
        engine = Engine(make_model(name), _alg(spec, W))
        tmpl = engine.init_state(params_from_numpy(weights, device="cpu"))
        back = engine.restore(ckpt, tmpl)
        rec["restored_state"] = {"params": MW._numpy(back.params),
                                 "opt": MW._numpy(back.opt),
                                 "comm": MW._numpy(back.comm)}
    params = params_from_numpy(weights, device="cpu")
    b0 = T.map(lambda x: x[0], batches(name, W)(0))
    grads, loss = _grads(make_model(name), params, b0)
    rec["grads"] = MW._numpy(grads)
    rec["grad_loss"] = float(loss)
    with torch.no_grad():
        rec["logits"] = make_model(name).logits(params, b0).numpy()
    return rec, state


# the keys of a run's spec that this module reads, not the algorithm:
# ``nudge`` (rank 0 also makes the one-process run from weights one ulp
# up, `_nudged_moves`), ``steps`` (this run's step count, for the case's)
SPEC_KEYS = ("nudge", "steps")


def _alg(spec: dict, W: int):
    """The algorithm of a run's spec, without this module's keys."""
    return MW._make({k: v for k, v in spec.items() if k not in SPEC_KEYS},
                    W)


# a coordinate more than TOL of its leaf's scale (of a weight's update,
# for params) from the one-process run's counts as flipped
TOL = 1e-4


def flips(got, want, base) -> dict:
    """Per part of two gathered states, the coordinates more than ``TOL``
    of their leaf's scale apart: params as moves from the weights
    ``base`` (at least one ulp of the leaf's largest weight), opt and
    comm as they are; ``total`` the coordinates counted."""
    out = {"total": 0}
    for part in ("params", "opt", "comm"):
        n = 0
        bs = T.leaves(base) if part == "params" else None
        for j, (a, b) in enumerate(zip(T.leaves(got[part]),
                                       T.leaves(want[part]))):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if not b.size:
                continue
            tol = 0.0
            if bs is not None:
                w0 = np.asarray(bs[j], np.float64)
                a, b = a - w0, b - w0
                tol = float(np.spacing(np.abs(w0).max()))
            tol = max(tol, TOL * float(np.abs(b).max()))
            n += int((np.abs(a - b) > tol).sum())
            out["total"] += b.size
        out[part] = n
    return out


def _nudged_moves(one, nudged):
    """How far the one-process trajectory moves when every weight starts
    one ulp up: per part, each leaf's max|a − b|; per step, each
    metric's |a − b|."""
    moves = {p: [float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).max())
                 if np.asarray(b).size else 0.0
                 for a, b in zip(T.leaves(one[p]), T.leaves(nudged[p]))]
             for p in ("params", "opt", "comm")}
    return moves


def case_tp(world, *, shape, runs, weights, keep=(), states=(),
            ckpt_dir=None, steps=MW.STEPS):
    """Every ``(config, spec, W)`` of ``runs`` on a ('data', 'model') mesh
    of ``shape``.  Each rank: its records (`_run`); rank 0 adds, per part,
    the distance from the one-process run, that run's metrics and
    gradients' distance, and the gathered states of ``keep``'s and
    ``states``' runs (``states``' with the one-process run's beside);
    ``keep``'s (with ``ckpt_dir``) are also saved under the mesh and
    restored with ``mesh=None``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(*shape, device_type="cpu")
    first = dist.get_rank() == 0
    out = []
    for i, (name, spec, W) in enumerate(runs):
        ckpt = f"{ckpt_dir}/tp{i}.npz" \
            if ckpt_dir is not None and i in keep else None
        n = spec.get("steps", steps)
        rec, got = _run(name, spec, W, weights[name], mesh, n, ckpt)
        if first:
            one, want = _one_process(name, spec, W, weights[name], n, ckpt)
            rec["diff"] = {p: MW._compare(got[p], want[p])
                           for p in ("params", "opt", "comm")}
            rec["flips"] = flips(got, want, weights[name])
            rec["grad_diff"] = _rel(rec.pop("grads"), one["grads"])
            rec["logits_diff"] = _rel(rec.pop("logits"), one["logits"])
            rec["grad_loss_one"] = one["grad_loss"]
            rec["hist_one"] = one["hist"]
            rec["worker_steps_one"] = one.get("worker_steps")
            if spec.get("nudge"):
                up = T.map(lambda x: np.nextafter(x, np.float32(np.inf)),
                           weights[name])
                two, nudged = _run(name, spec, W, up, None, n, None)
                rec["moves"] = _nudged_moves(want, nudged)
                rec["hist_moves"] = [{k: abs(a[k] - b[k]) for k in a}
                                     for a, b in zip(one["hist"],
                                                     two["hist"])]
                rec["leaf_diff"] = {p: [
                    (float(np.abs(np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)).max()),
                     float(np.abs(np.asarray(b, np.float64)).max()))
                    if np.asarray(b).size else (0.0, 0.0)
                    for a, b in zip(T.leaves(got[p]), T.leaves(want[p]))]
                    for p in ("params", "opt", "comm")}
            if ckpt is not None:
                rec["ckpt_bitwise"] = all(
                    MW._compare(got[p], one["restored_state"][p])[1]
                    for p in ("params", "opt", "comm"))
            if i in keep or i in states:
                rec["state"] = got
            if i in states:
                rec["state_one"] = want
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


def case_edge(world):
    """The Mamba block's in-projection pattern on a (1, ``world``) mesh:
    x @ w (d, 2e) with each rank holding a contiguous block of the 2e
    columns, the product gathered, each rank keeping its e / world
    channels of the x half and of the z half and adding up its own part
    of a loss.  Per edge (``gather_reduce`` and the narrow-only
    ``gather``), the largest relative distance of this rank's gradients
    (x's, its block of w's) from one-process autograd of the whole
    loss."""
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(1, world, device_type="cpu")
    axis = M.model_axis(mesh)
    gen = torch.Generator().manual_seed(0)
    B, S, d, e = 2, 5, 6, 4 * world
    x = torch.randn(B, S, d, generator=gen)
    w = torch.randn(d, 2 * e, generator=gen)
    c = torch.randn(e, generator=gen)

    def part(xi, z, cc):
        return (xi * torch.nn.functional.silu(z) * cc).sum()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xi, z = (xa @ wa).chunk(2, dim=-1)
    gx, gw = torch.autograd.grad(part(xi, z, c), (xa, wa))
    n = 2 * e // world
    lo = axis.shard_start(n)
    e_l = e // world
    out = {}
    for edge in ("gather_reduce", "gather"):
        xb = x.clone().requires_grad_()
        wb = w[:, lo:lo + n].clone().requires_grad_()
        full = getattr(axis, edge)(axis.copy(xb) @ wb, -1)
        xi, z = full.chunk(2, dim=-1)
        k = axis.shard_start(e_l)
        loss = part(xi[..., k:k + e_l], z[..., k:k + e_l], c[k:k + e_l])
        hx, hw = torch.autograd.grad(loss, (xb, wb))
        out[edge] = max(float((hx - gx).abs().max() / gx.abs().max()),
                        float((hw - gw[:, lo:lo + n]).abs().max()
                              / gw.abs().max()))
    return out


def case_remat(world, *, names, seq, chunk):
    """Each config of ``names`` (``<name>_window``: a 12-token sliding
    window) on a (1, ``world``) mesh: this rank's loss and gradients of
    its shards (the serve specs' cut of one set of weights) under
    ``remat`` x ``seq_parallel`` on and off, a digest each; attention in
    blocks of ``chunk``, two tokens rows of ``seq``."""
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(1, world, device_type="cpu")
    out = {}
    for name in names:
        base, _, var = name.partition("_")
        cfg = reduced(get_config(ARCHS[base]))
        if var == "window":
            cfg = dataclasses.replace(cfg, sliding_window=12)
        engine = Engine(Model(cfg), mesh=mesh)
        local = engine.serve_params(
            engine.model.init(torch.Generator().manual_seed(0)))
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.encoder is not None:
            batch["frames"] = torch.randn(2, cfg.encoder.n_frames,
                                          cfg.d_model, generator=gen)
        variants = {}
        for remat in (False, True):
            for sp in (False, True):
                model = Model(cfg, remat=remat, seq_parallel=sp,
                              q_chunk=chunk, kv_chunk=chunk,
                              loss_chunk=16).with_model_axis(
                                  engine.model_axis)
                grads, loss = _grads(model, local, batch)
                variants[f"remat={remat} seq_parallel={sp}"] = _digest(
                    [loss] + T.leaves(grads))
        out[name] = variants
    return out


CASES = {"tp": case_tp, "xent": case_xent, "cnn": case_cnn,
         "edge": case_edge, "remat": case_remat}

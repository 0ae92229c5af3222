"""The spawned ranks of `tests/test_torch_tp_serve.py` (not a test file;
it imports no jax, so the ranks never load it).

`tests/torch_mesh_worker.spawn(..., module="torch_tp_serve_worker")`
starts the ranks (gloo, one torch thread, a ``file://`` store under the
test's ``tmp_path``); `case_serve` serves every arch of its list on one
('data', 'model') mesh through an `Engine` built without an algorithm.
Each rank also serves the same batch with ``mesh=None`` (the reduced
models are small) and reports how far its own prefill logits, its
caches and its tokens lie from that run's: its caches are held both to
`Engine.shard` of the one-process caches under their cache specs and,
gathered back (`parallel.sharding.gather_shards`), to the whole
one-process caches.  Rank 0 returns its greedy loop's logits and tokens,
which the test holds against the reference's GSPMD run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.models.transformer import Model
from repro_torch.parallel import sharding as shd

import torch_tp_worker as TW

# the served batch: rows, prompt length, generated tokens
ROWS, PROMPT, GEN = 2, 8, 8


def prompts(cfg, seed: int = 7) -> dict:
    """The served batch as numpy, from a seed: ``tokens`` (ROWS, PROMPT)
    and the inputs besides them (an encoder-decoder's frames, a VLM's
    patches and M-RoPE positions, their t / h / w components
    distinct)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, PROMPT))}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (ROWS, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        n = cfg.vlm.n_patches
        out["patches"] = rng.standard_normal(
            (ROWS, n, cfg.d_model)).astype(np.float32)
        pos = np.arange(n + PROMPT)
        out["mrope_positions"] = np.stack([pos, pos // 2, pos % 5])
    return out


def cache_len(cfg, model_size: int) -> int:
    """The one-shot loop's cache length (prompt, patches, GEN and one),
    rounded up to a multiple of the 'model' axis as `generate` rounds
    it."""
    n = cfg.vlm.n_patches if cfg.vlm is not None else 0
    need = PROMPT + n + GEN + 1
    return -(-need // model_size) * model_size


def greedy(model, params, batch: dict, length: int):
    """`OneShotGenerator`'s loop, keeping every step's logits: (the
    prefill's logits, the prefill's caches (a copy), each decode step's
    logits, the GEN greedy tokens (B, GEN))."""
    vlm = model.cfg.vlm is not None
    logits, cache = model.prefill(params, batch, cache_len=length)
    first = T.map(torch.clone, cache)
    tok = logits.argmax(-1)
    pos = torch.tensor(batch["tokens"].shape[1]
                       + (batch["patches"].shape[1] if vlm else 0))
    steps, out = [], [tok]
    for _ in range(GEN - 1):
        step = {"tokens": tok[:, None], "pos": pos}
        if vlm:
            step["mrope_positions"] = pos.expand(3, 1)
        lg, cache = model.decode_step(params, cache, step)
        steps.append(lg)
        tok = lg.argmax(-1)
        out.append(tok)
        pos = pos + 1
    return logits, first, steps, torch.stack(out, dim=1)


def _rel(a, b) -> float:
    """The largest over leaves of max|a − b| / max|b|."""
    worst = 0.0
    for x, y in zip(T.leaves(a), T.leaves(b)):
        x = x.double() if isinstance(x, torch.Tensor) else torch.tensor(x)
        y = y.double() if isinstance(y, torch.Tensor) else torch.tensor(y)
        scale = float(y.abs().max()) if y.numel() else 0.0
        if scale:
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst


def serve_one(name: str, weights, mesh, mine: bool) -> dict:
    """Serve ``name`` on ``mesh`` and with ``mesh=None``; what this rank
    reports (``mine``: also its greedy loop's logits and tokens)."""
    cfg = TW.config(name)
    params = params_from_numpy(weights, device="cpu")
    data = {k: torch.from_numpy(np.asarray(v))
            for k, v in prompts(cfg).items()}
    engine = Engine(Model(cfg), mesh=mesh)
    size = engine.model_axis.size if engine.model_axis is not None else 1
    length = cache_len(cfg, size)
    local = engine.serve_params(params)
    one = Model(cfg)
    with torch.no_grad():
        w_lg, w_cache, w_steps, w_tok = greedy(one, params, data, length)
        batch = engine.serve_batch(data)
        lg, cache, steps, tok = greedy(engine.model, local, batch, length)
        _, _, specs = engine.serve_shardings(
            params, global_batch=ROWS, cache=w_cache)
        rows = engine.serve_batch({"tokens": w_lg})["tokens"]
        want_steps = [engine.serve_batch({"tokens": s})["tokens"]
                      for s in w_steps]
        gen = engine.generate(local, data["tokens"], gen=GEN,
                              extra_batch={k: v for k, v in data.items()
                                           if k != "tokens"})
        whole = shd.gather_shards(cache, specs, mesh)
    sizes = {a: n for a, n in zip(mesh.mesh_dim_names, tuple(mesh.shape))}
    rec = {
        "logits": _rel(lg, rows),
        "steps": max(_rel(a, b) for a, b in zip(steps, want_steps)),
        "cache": _rel(cache, engine.shard(w_cache, specs)),
        "cache_shapes": [tuple(x.shape) for x in T.leaves(cache)] == [
            tuple(x.shape) for x in T.leaves(engine.shard(w_cache, specs))],
        "whole": _rel(whole, w_cache),
        "cache_bytes": sum(x.numel() * x.element_size()
                           for x in T.leaves(cache)),
        "shard_bytes": shd.shard_bytes(w_cache, specs, sizes),
        "tokens": torch.equal(tok, engine.serve_batch(
            {"tokens": w_tok})["tokens"]),
        # `OneShotGenerator`'s loop is `greedy`'s: the whole batch's
        # one-process tokens
        "generate": torch.equal(gen, w_tok),
        "generate_tokens": gen.tolist(),
    }
    if mine:
        rec["loop"] = {"logits": [lg.numpy()] + [s.numpy() for s in steps],
                       "tokens": tok.numpy()}
    return rec


def case_serve(world, *, shape, names, weights):
    """Every arch of ``names`` served on a ('data', 'model') mesh of
    ``shape``: per arch, each rank's `serve_one` record."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    mesh = M.make_debug_mesh(*shape, device_type="cpu")
    first = dist.get_rank() == 0
    return {"model_index": M.model_index(mesh),
            "worker_index": M.worker_index(mesh),
            "archs": {n: serve_one(n, weights[n], mesh, first)
                      for n in names}}


CASES = {"serve": case_serve}

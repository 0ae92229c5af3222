"""Roofline-driven autotuner for the two hot paths (the port of
``repro.analysis.autotune``).

The hand-picked constants the repo carries (the bucket count of the train
wire, the fused kernels' bucket padding block, the paged cache's
``page_size``, the scheduler's ``decode_burst``) are knobs a roofline cost
model can rank.  Two stages:

1. **Predict**: every candidate gets an analytic estimate from the H100
   constants (`repro_torch.analysis.roofline`) plus the reducer's own
   ``wire_bytes`` at the *padded* `BucketPlan` layout: bucket count trades
   per-reduce latency against padding, ``page_size`` trades internal
   fragmentation against block-table width, ``decode_burst`` amortizes
   the per-dispatch host overhead.  The train probe adds the roofline of
   one traced step (compute and memory terms, the same for every
   candidate) so a prediction stands beside each measured step.

2. **Probe**: the candidates (the ``top_k`` best predicted when a count is
   given) PLUS THE DEFAULT are measured for real, on the card unless the
   caller asks for the CPU: each train step timed alone (CUDA events on
   the card), each serve run's tokens/s.  The model only ranks.
   Greedy tokens must be identical across every serve candidate (page
   size and burst may never change a token): the probe raises otherwise.

3. **Adopt** (`pick`): the best-measured candidate becomes the tuned
   config only when it beats the default by more than the measured
   spread (the larger of the two candidates' `spread`); otherwise the
   default stays tuned.  A winner by noise is no recommendation.

The card's probes: training qwen3-0.6b at its published widths cut to 4
layers (374,351,872 params), W = 2, 4 x 256 tokens a worker, fused
kernels (A1/A2 at every candidate's buckets); serving qwen3-0.6b at all 28
layers over 16 slots, paged (B4 every decode step, B5 every prefill), on
16 requests drawn from ``seed`` at the serve cell's lengths (prompts
128-512, generation 16-64), two rounds over the candidates in turn.  On
the CPU (``device="cpu"``) both run the reduced qwen3 at the reference's
sizes.

The result is the reference's JSON **config blob** (``version: 1``)::

    {"version": 1, "hardware": {...},
     "train": {"default": {...}, "tuned": {"buckets": 8, "plan_block": null},
               "default_ms": ..., "tuned_ms": ..., "candidates": [...]},
     "serve": {"default": {...}, "tuned": {"page_size": 32,
               "decode_burst": 8}, "default_tps": ..., "tuned_tps": ...,
               "candidates": [...]}}

read by the launchers (``--tuned-config blob.json`` / ``--autotune`` on
`repro_torch.launch.train` and `repro_torch.launch.serve`)::

    PYTHONPATH=src python -m repro_torch.analysis.autotune --out tuned.json
    PYTHONPATH=src python -m repro_torch.analysis.autotune --smoke \\
        --device cpu --out tuned.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# per-reduce launch latency (s): the fixed cost each bucket's reduce pays
# whatever its payload, the reason a thousand buckets are slow though the
# padding shrinks
COLL_LATENCY_S = 8e-6
# per-dispatch host overhead (s) of one scheduler decode burst (Python
# bookkeeping and launches), amortized over decode_burst steps
DISPATCH_OVERHEAD_S = 1.5e-3

TRAIN_DEFAULT = {"buckets": 4, "plan_block": None}
SERVE_DEFAULT = {"page_size": 16, "decode_burst": 4}


def train_space(smoke: bool = False) -> List[dict]:
    from repro_torch.parallel.buckets import BLOCK
    buckets = (2, 4, 8) if smoke else (1, 2, 4, 8)
    blocks = (None,) if smoke else (None, 2 * BLOCK)
    return [{"buckets": b, "plan_block": blk}
            for b in buckets for blk in blocks]


def serve_space(smoke: bool = False) -> List[dict]:
    sizes = (8, 16, 32)
    bursts = (4, 8) if smoke else (1, 4, 8, 16)
    return [{"page_size": p, "decode_burst": d}
            for p in sizes for d in bursts]


# ---------------------------------------------------------------------------
# analytic predictors (stage 1)
# ---------------------------------------------------------------------------


def predict_train(cand: dict, *, leaf_sizes: Sequence[int], n_workers: int,
                  reducer, flops: float = 0.0, hbm_bytes: float = 0.0
                  ) -> float:
    """Predicted step seconds for one train candidate.

    The compute and memory terms do not depend on the candidate (same
    model, same batch) and may be 0 when only ranking; the candidate's
    part is the wire: the reducer's ``wire_bytes`` at the candidate's
    padded bucket layout over NVLink, plus one launch latency per
    bucket."""
    from repro_torch.parallel.buckets import BLOCK
    block = cand["plan_block"] or BLOCK
    # mirror plan_buckets' greedy fill: no bucket over ceil(total / n)
    cap = -(-sum(leaf_sizes) // max(cand["buckets"], 1))
    parts: List[List[int]] = [[]]
    for n in leaf_sizes:
        if parts[-1] and sum(parts[-1]) + n > cap:
            parts.append([])
        parts[-1].append(n)
    padded = [-(-sum(p) // block) * block for p in parts if p]
    wire = float(reducer.wire_bytes(padded))
    comm_s = wire / NVLINK_BW + len(padded) * COLL_LATENCY_S
    return flops / PEAK_FLOPS_BF16 + hbm_bytes / HBM_BW + comm_s


def predict_serve(cand: dict, *, kv_bytes_per_token: int, param_bytes: int,
                  slots: int, mean_len: float, decode_flops: float = 0.0
                  ) -> float:
    """Predicted seconds per generated token (lower is better).

    A decode step streams the params plus every live row's KV, including
    the allocated but empty tail of each row's last page (on average
    ``(page_size - 1) / 2`` slots): that is how ``page_size`` enters;
    ``decode_burst`` divides the per-dispatch host overhead over the
    burst's steps."""
    frag_tokens = (cand["page_size"] - 1) / 2.0
    kv_bytes = slots * (mean_len + frag_tokens) * kv_bytes_per_token
    step_s = max((param_bytes + kv_bytes) / HBM_BW,
                 decode_flops / PEAK_FLOPS_BF16)
    step_s += DISPATCH_OVERHEAD_S / cand["decode_burst"]
    return step_s / max(slots, 1)


# ---------------------------------------------------------------------------
# measured probes (stage 2): ALWAYS include the default config
# ---------------------------------------------------------------------------


def _default_first(cands: List[dict], default: dict) -> List[dict]:
    return [dict(default)] + [c for c in cands if c != default]


def spread(samples: Sequence[float]) -> float:
    """The spread of one candidate's repeated measurements: their range
    (the serve probe has two runs a candidate, where quartiles would
    halve the one difference there is)."""
    return float(max(samples) - min(samples))


def pick(probed: List[dict], default: dict, *, key: str, samples: str,
         higher_is_better: bool) -> Tuple[dict, float, bool]:
    """``(record, margin, adopted)``: the best record by ``key`` when it
    beats the default's by more than ``margin``, the larger `spread` of
    the two records' ``samples``; else the default's record."""
    d = next(r for r in probed if r["config"] == default)
    best = (max if higher_is_better else min)(probed, key=lambda r: r[key])
    margin = max(spread(best[samples]), spread(d[samples]))
    gain = best[key] - d[key] if higher_is_better else d[key] - best[key]
    adopted = best is not d and gain > margin
    return (best if adopted else d), margin, adopted


def train_entry(probed: List[dict]) -> dict:
    """The blob's ``train`` side from `probe_train`'s records."""
    rec, margin, adopted = pick(probed, TRAIN_DEFAULT, key="ms_per_step",
                                samples="step_ms", higher_is_better=False)
    d = next(r for r in probed if r["config"] == TRAIN_DEFAULT)
    return {"default": dict(TRAIN_DEFAULT), "tuned": dict(rec["config"]),
            "default_ms": d["ms_per_step"], "tuned_ms": rec["ms_per_step"],
            "margin_ms": margin, "adopted": adopted, "candidates": probed}


def serve_entry(probed: List[dict]) -> dict:
    """The blob's ``serve`` side from `probe_serve`'s records (which
    raised unless every candidate's greedy tokens were identical)."""
    rec, margin, adopted = pick(probed, SERVE_DEFAULT, key="tokens_per_s",
                                samples="run_tps", higher_is_better=True)
    d = next(r for r in probed if r["config"] == SERVE_DEFAULT)
    return {"default": dict(SERVE_DEFAULT), "tuned": dict(rec["config"]),
            "default_tps": d["tokens_per_s"],
            "tuned_tps": rec["tokens_per_s"], "margin_tps": margin,
            "adopted": adopted, "candidates": probed,
            "tokens_identical": True}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_model(device: torch.device, n_layers: Optional[int], **kw):
    """The probes' qwen3 (`_qwen3`), without remat, as the reference's
    probe model (src/repro/analysis/autotune.py); on the CPU its 16-wide
    attention and scan blocks, on the card the Model's own sizes (the
    card's, not the reference's: its 16 are a CPU smoke's)."""
    from repro_torch.models.transformer import Model
    blocks = {} if device.type == "cuda" else {
        "q_chunk": 16, "kv_chunk": 16, "scan_chunk": 16}
    return Model(_qwen3(device, n_layers), remat=False, **blocks, **kw)


def _qwen3(device: torch.device, n_layers: Optional[int]):
    from repro_torch.configs import get_config, reduced
    cfg = get_config("qwen3-0.6b")
    if device.type == "cuda":
        return cfg if n_layers is None else \
            dataclasses.replace(cfg, n_layers=n_layers)
    return reduced(cfg)


def probe_train(candidates: List[dict], *, model=None, algo: str = "dc_s3gd",
                reducer: str = "mean_allreduce",
                comm_dtype: Optional[str] = None, n_workers: int = 2,
                batch_per_worker: Optional[int] = None,
                seq: Optional[int] = None, steps: Optional[int] = None,
                warmup: int = 2,
                top_k: Optional[int] = None, device="cuda",
                use_kernels: Optional[bool] = None) -> List[dict]:
    """Measure ms/step for each candidate (default first).  On the card:
    qwen3-0.6b x4 at its widths, 4 x 256 tokens a worker, fused kernels,
    10 steps each timed by CUDA events; on the CPU the reduced qwen3,
    2 x 32 tokens, no kernels, 3 steps on the host clock.  With
    ``top_k`` only the best-predicted ``top_k`` candidates (and the
    default) are measured.  Each entry: the config, ``step_ms`` (every
    timed step), ``ms_per_step`` (their median), ``predicted_comm_s``
    (the candidate's wire term, the reference's key) and
    ``predicted_ms`` (the traced roofline step plus that term)."""
    from repro_torch import tree as T
    from repro_torch.analysis.roofline import analyze
    from repro_torch.core import registry
    from repro_torch.core.types import DCS3GDConfig, InputShape
    from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
    from repro_torch.launch.engine import Engine

    device = torch.device(device)
    cuda = device.type == "cuda"
    if model is None:
        model = _probe_model(device, 4, loss_chunk=256 if cuda else 64)
    batch_per_worker = batch_per_worker or (4 if cuda else 2)
    seq = seq or (256 if cuda else 32)
    steps = steps or (10 if cuda else 3)
    use_kernels = cuda if use_kernels is None else use_kernels
    data = SyntheticLMDataset(model.cfg.vocab_size, seq, seed=0)
    dc_cfg = DCS3GDConfig(learning_rate=0.05, momentum=0.9, lambda0=0.2,
                          warmup_steps=1, total_steps=max(steps, 2))

    def batch(it):
        return worker_batches(data, it, n_workers, batch_per_worker,
                              device=device)

    def build(cand):
        red = registry.make_reducer(reducer, dc_cfg, **(
            {"comm_dtype": comm_dtype} if comm_dtype else {}))
        alg = registry.make(algo, dc_cfg, n_workers=n_workers, reducer=red,
                            buckets=cand["buckets"],
                            plan_block=cand["plan_block"],
                            use_kernels=use_kernels)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return red, alg, params

    cands = _default_first(candidates, TRAIN_DEFAULT)
    # the step's compute and memory terms, from one traced step of the
    # default (the same model and batch for every candidate)
    red, alg, params = build(cands[0])
    sizes = [x.numel() for x in T.leaves(params)]
    engine = Engine(model, alg)
    tr, _, _ = engine.trace_train_step(alg.init(params), batch(0))
    del params, engine
    shape = InputShape("probe", seq, n_workers * batch_per_worker, "train")
    base_s = analyze(tr, model.cfg, shape, 1).step_s
    del tr

    def comm_s(cand, red):
        return predict_train(cand, leaf_sizes=sizes, n_workers=n_workers,
                             reducer=red)

    if top_k is not None:
        ranked = sorted(cands[1:], key=lambda c: comm_s(c, red))
        cands = [cands[0]] + ranked[:top_k]
    out = []
    for cand in cands:
        red, alg, params = build(cand)
        state = alg.init(params)
        del params
        for it in range(warmup):
            state, m = alg.step(state, batch(it), loss_fn=model.loss)
        step_ms = []
        for it in range(warmup, warmup + steps):
            b = batch(it)
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
                ev[0].record()
                state, m = alg.step(state, b, loss_fn=model.loss)
                ev[1].record()
                step_ms.append(ev)
            else:
                t0 = time.perf_counter()
                state, m = alg.step(state, b, loss_fn=model.loss)
                step_ms.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
        if cuda:
            step_ms = [a.elapsed_time(z) for a, z in step_ms]
        pred = comm_s(cand, red)
        out.append({"config": dict(cand), "step_ms": step_ms,
                    "ms_per_step": float(np.median(step_ms)),
                    "predicted_comm_s": pred,
                    "predicted_ms": (base_s + pred) * 1e3})
        del state, m, alg
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _serve_workload(n_requests: int, vocab: int, *, prompt_lens=(128, 512),
                   gens=(16, 64), seed: int = 0) -> list:
    """``n_requests`` requests from ``seed``: prompt lengths and generation
    lengths uniform over the given inclusive ranges."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        g = int(rng.integers(gens[0], gens[1] + 1))
        reqs.append(Request(rid=i, prompt=rng.integers(0, vocab, p).tolist(),
                            max_new=g))
    return reqs


def probe_serve(candidates: List[dict], *, model=None, params=None,
                slots: Optional[int] = None, n_requests: Optional[int] = None,
                prompt_lens=None, gens=None, kv_dtype: Optional[str] = None,
                seed: int = 0, reps: Optional[int] = None,
                device="cuda") -> List[dict]:
    """Measure serve tokens/s for each candidate (default first), every
    candidate over the same requests, ``reps`` rounds over all candidates
    in turn (so a drift of the host spreads over every candidate), the
    tokens/s of a candidate its tokens over its summed wall time and
    ``run_tps`` each round's.  Raises
    if any run's greedy tokens differ from the default's first run.  On
    the card: qwen3-0.6b at 28 layers, 16 slots, 16 requests (prompts
    128-512, generation 16-64), 2 rounds; on the CPU the reduced qwen3,
    8 slots, 16 requests of 8-16 prompt tokens and 1-8 generated, one
    round.  The default runs once untimed first (the kernels' first
    calls, the allocator)."""
    from repro_torch import tree as T
    from repro_torch.serve import Scheduler

    device = torch.device(device)
    cuda = device.type == "cuda"
    if model is None:
        model = _probe_model(device, None)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    slots = slots or (16 if cuda else 8)
    n_requests = n_requests or 16
    prompt_lens = prompt_lens or ((128, 512) if cuda else (8, 16))
    gens = gens or ((16, 64) if cuda else (1, 8))
    reps = reps or (2 if cuda else 1)
    max_len = prompt_lens[1] + gens[1] + 1
    param_bytes = sum(x.numel() * x.element_size() for x in T.leaves(params))

    def workload():
        return _serve_workload(n_requests, model.cfg.vocab_size,
                               prompt_lens=prompt_lens, gens=gens,
                               seed=seed)

    def scheduler(cand):
        ps = cand["page_size"]
        max_pages = -(-max_len // ps)
        return Scheduler(model, params, slots=slots,
                         pages=slots * max_pages + 1 + max_pages,
                         page_size=ps, max_len=max_len,
                         decode_burst=cand["decode_burst"],
                         kv_dtype=kv_dtype)

    cands = _default_first(candidates, SERVE_DEFAULT)
    scheduler(cands[0]).run(workload())         # warm
    walls: List[List[float]] = [[] for _ in cands]
    out, first = [], None
    for _ in range(reps):
        for i, cand in enumerate(cands):
            sch = scheduler(cand)
            reqs = workload()
            _sync(device)
            t0 = time.perf_counter()
            sch.run(reqs)
            _sync(device)
            walls[i].append(time.perf_counter() - t0)
            tokens = {r.rid: list(r.out) for r in sch.finished}
            if first is None:
                first = tokens
            elif tokens != first:
                bad = sorted(r for r in first if tokens.get(r) != first[r])
                raise RuntimeError(
                    f"probe_serve: {cand} changes the greedy tokens of "
                    f"requests {bad} (page size and burst may never change "
                    f"a token)")
            if len(out) < len(cands):
                out.append({"config": dict(cand),
                            "kv_bytes_per_token":
                                sch.layout.kv_bytes_per_token(),
                            "decode_steps": sch.stats["decode_steps"]})
            del sch
    toks = sum(len(t) for t in first.values())
    for rec, wall in zip(out, walls):
        pred = predict_serve(
            rec["config"], kv_bytes_per_token=rec.pop("kv_bytes_per_token"),
            param_bytes=param_bytes, slots=slots,
            mean_len=(sum(prompt_lens) + sum(gens) / 2) / 2)
        rec.update(tokens_per_s=toks * reps / sum(wall),
                   run_tps=[toks / w for w in wall],
                   predicted_s_per_token=pred,
                   predicted_tokens_per_s=1.0 / pred, tokens=toks,
                   runs=reps)
    return out


# ---------------------------------------------------------------------------
# the blob
# ---------------------------------------------------------------------------


def autotune(*, smoke: bool = False, skip_train: bool = False,
             skip_serve: bool = False, top_k: Optional[int] = None,
             kv_dtype: Optional[str] = None, device="cuda",
             n_requests: Optional[int] = None) -> dict:
    """Run the predict-then-probe loop on ``device``; returns the blob."""
    blob: Dict = {"version": 1, "smoke": bool(smoke),
                  "device": torch.device(device).type,
                  "hardware": {"peak_flops_bf16": PEAK_FLOPS_BF16,
                               "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW}}
    if not skip_train:
        blob["train"] = train_entry(
            probe_train(train_space(smoke), top_k=top_k, device=device))
    if not skip_serve:
        cands = serve_space(smoke)
        if top_k is not None:
            cands = cands[:top_k]
        blob["serve"] = serve_entry(
            probe_serve(cands, kv_dtype=kv_dtype, device=device,
                        n_requests=n_requests))
    return blob


def load_tuned(path) -> dict:
    """Read a blob written by `autotune` (or the reference's); checks its
    version."""
    blob = json.loads(Path(path).read_text())
    if not isinstance(blob, dict) or blob.get("version") != 1:
        raise ValueError(f"{path}: not an autotune config blob (version 1)")
    return blob


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.autotune")
    ap.add_argument("--out", type=Path, default=Path("tuned.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="the small candidate grids")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--top-k", type=int, default=None,
                    help="probe only the best-predicted K train candidates "
                         "(and the first K serve ones) besides the default")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("bfloat16", "float32", "int8", "fp8"))
    ap.add_argument("--device", default="cuda",
                    help="where the probes run (cuda or cpu)")
    args = ap.parse_args(argv)
    from repro_torch.launch.train import resolve_device
    blob = autotune(smoke=args.smoke, skip_train=args.skip_train,
                    skip_serve=args.skip_serve, top_k=args.top_k,
                    kv_dtype=args.kv_dtype,
                    device=resolve_device(args.device))
    args.out.write_text(json.dumps(blob, indent=2))
    for side in ("train", "serve"):
        if side in blob:
            b = blob[side]
            print(f"[autotune] {side}: default {b['default']} -> "
                  f"tuned {b['tuned']} (best adopted: {b['adopted']})")
    print(f"[autotune] wrote {args.out}")


if __name__ == "__main__":
    main()

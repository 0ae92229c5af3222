"""Serving entry point (the port of ``repro.launch.serve``).

Three modes, as in the reference:

* **one-shot** (default): prefill a fixed batch of equal-length random
  prompts and decode them together over the dense cache
  (`repro_torch.serve.oneshot` through `Engine.generate`);
* **offline request file** (``--requests file.jsonl``): continuous
  batching over the paged KV cache (`repro_torch.serve.scheduler`); each
  line is ``{"prompt": [ids...], "gen": N}`` or ``{"prompt_len": P,
  "gen": N}`` (tokens drawn from ``--seed``);
* **synthetic Poisson load** (``--poisson RATE --num-requests N``): the
  same scheduler under open-loop arrivals at RATE req/s.  The drawn
  schedule is written to ``--schedule-out``.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --requests r.jsonl \\
      --slots 16 --pages 641 --page-size 16 --paged-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --requests r.jsonl \\
      --slots 16 --pages 641 --prefill-chunk 128 --prefix-cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --requests r.jsonl --slots 16 --decode-burst 4
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --requests r.jsonl --slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
      --batch 4 --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --batch 8 --prompt-len 64 --gen 64

``--arch`` is qwen3-0.6b, stablelm-3b (layernorm, hd 80) or granite-20b
(MQA: one kv head for 48 query heads), attention over the paged KV
cache; falcon-mamba-7b (the Mamba state, O(1) per request) or
recurrentgemma-9b (RG-LRU state and a 2,048-token local-attention ring
per request, whatever the prompt's length): their state is slot-indexed,
so the page pool stays untouched, ``--pages`` / ``--page-size`` /
``--kv-dtype`` do not apply to them, and ``--prefill-chunk`` /
``--prefix-cache`` are refused, as in the reference.  qwen2-vl-7b (a VLM:
M-RoPE, its prompt 1,024 patch positions before the text) and
whisper-large-v3 (an encoder over 1,500 frames, then a decoder with
cross-attention) serve one-shot only, as in the reference: their
prompts carry stub inputs the request file cannot, so the patches (B,
n_patches, d), the tiled M-RoPE positions and the frames (B, n_frames,
d) are drawn from ``--seed``, and the scheduler refuses both.
``--prefill-chunk N`` forwards prompts N
tokens per scheduler step, interleaved with decode; ``--prefix-cache``
shares committed prompt pages between requests, with copy-on-write where
a prompt diverges inside a page.

Runs on the card (``--device cuda``, the default) unless asked for the
CPU.  On the card the paged decode reads the pages through the CUDA
paged-attention kernel; on the CPU it gathers them, and ``--paged-kernel``
routes it through the kernel's wrapper (its plain version there) as the
reference's flag does.  Every prefill takes the flash-attention (windowed
for recurrentgemma's local attention) or the selective-scan kernel on the
card and their plain versions on the CPU.

Weights are random, drawn from ``--seed``, unless ``--train-ckpt`` points
at a `repro_torch.launch.train` checkpoint (or the reference's): its
metadata rebuilds the algorithm that trained it (``--algo``,
``--workers``, ``--local-optimizer`` and ``--reducer`` are fallbacks for a
file without metadata), and its ``eval_params`` (the DC-S3GD worker
average, paper Eq. 8, in anchor form) are served.  ``--layers`` cuts the
depth as the training entry point's flag does, so a checkpoint of a cut
model loads.  ``--tuned-config BLOB`` (`repro_torch.analysis.autotune`)
takes ``page_size`` and ``decode_burst`` from the blob's ``serve.tuned``
for the scheduler modes; ``--autotune`` probes them first (the smoke
grid, on the run's device).  The pool keeps ``--pages`` pages, so a
larger tuned page size is a larger pool in tokens, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core import registry
from repro_torch.launch.engine import Engine, algorithm_for_checkpoint
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve import SAMPLERS, Request, Scheduler


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept), "
                         "as a cut training run's checkpoint holds")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--sampler", choices=sorted(SAMPLERS), default=None,
                    help="token sampler (default: greedy at temperature 0, "
                         "categorical above)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=Path, default=None,
                    help="JSONL request file -> offline continuous "
                         "batching over the paged KV cache")
    ap.add_argument("--poisson", type=float, default=None, metavar="RATE",
                    help="synthetic open-loop load: Poisson arrivals at "
                         "RATE req/s (with --num-requests)")
    ap.add_argument("--num-requests", type=int, default=12,
                    help="request count for --poisson")
    ap.add_argument("--schedule-out", type=Path,
                    default=Path("serve_schedule.json"),
                    help="where --poisson records its arrival schedule")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (continuous batching)")
    ap.add_argument("--pages", type=int, default=96,
                    help="KV page pool size")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-dtype", default=None,
                    choices=("bfloat16", "float32", "int8", "fp8"),
                    help="storage dtype of the paged KV pools (default: "
                         "compute dtype); int8/fp8 quantize per token "
                         "slot with f32 scales stored beside the pages")
    ap.add_argument("--paged-kernel", action="store_true", default=None,
                    help="read the pages through the paged-attention "
                         "kernel's wrapper on any device (default: the "
                         "kernel on the card, a gather on the CPU)")
    ap.add_argument("--decode-burst", type=int, default=4,
                    help="decode steps per dispatch, tokens left on the "
                         "device in between (admissions/evictions land on "
                         "burst boundaries)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: forward prompts this many "
                         "tokens per step, interleaved with decode (0 = "
                         "whole-prompt prefill on join)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share committed prompt-prefix pages between "
                         "requests (copy-on-write on divergence; implies "
                         "chunked prefill, default chunk 4*page_size)")
    ap.add_argument("--tuned-config", type=Path, default=None,
                    help="autotuner config blob (repro_torch.analysis."
                         "autotune): its serve.tuned {page_size, "
                         "decode_burst} override the flag defaults")
    ap.add_argument("--autotune", action="store_true",
                    help="run the serve-side autotuner probe first and "
                         "adopt its tuned config")
    ap.add_argument("--train-ckpt", type=Path, default=None,
                    help="serve eval_params of a training checkpoint (its "
                         "metadata selects the algorithm)")
    ap.add_argument("--algo", choices=registry.names(), default="dc_s3gd",
                    help="fallback for a checkpoint without metadata")
    ap.add_argument("--workers", type=int, default=4,
                    help="fallback for a checkpoint without metadata")
    ap.add_argument("--local-optimizer", default="momentum",
                    choices=registry.names(registry.LOCAL_OPTIMIZER),
                    help="fallback for a checkpoint without metadata")
    ap.add_argument("--reducer", default="mean_allreduce",
                    choices=registry.names(registry.REDUCER),
                    help="fallback for a checkpoint without metadata")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    return ap


def params_from_train_ckpt(model, path, *, algo: str, n_workers: int,
                           local_optimizer: str = "momentum",
                           reducer: str = "mean_allreduce", device="cuda"):
    """Restore a training checkpoint on ``device`` and return (the served
    weights, the resolved algorithm metadata): ``eval_params`` of the
    state, through the algorithm its metadata records (the arguments are
    fallbacks for a file without metadata)."""
    alg, resolved = algorithm_for_checkpoint(
        path, algo=algo, n_workers=n_workers,
        local_optimizer=local_optimizer, reducer=reducer)
    template = alg.init(model.init(torch.Generator(device=device)
                                   .manual_seed(0)))
    state = restore_pytree(path, template)
    del template
    return alg.eval_params(state), resolved


def build(args):
    """(model, params, device) for ``args``: random params from
    ``args.seed``, or the served weights of ``args.train_ckpt``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg)            # routed MoE, as the reference serves
    if args.train_ckpt is not None:
        params, resolved = params_from_train_ckpt(
            model, args.train_ckpt, algo=args.algo, n_workers=args.workers,
            local_optimizer=args.local_optimizer, reducer=args.reducer,
            device=device)
        print(f"[serve] weights from {args.train_ckpt} (algo="
              f"{resolved['algo']}, W={resolved['n_workers']}, "
              f"eval_params)")
    else:
        params = model.init(torch.Generator(device=device)
                            .manual_seed(args.seed))
    return model, params, device


def generate(model, params, prompts: torch.Tensor, *, gen: int,
             temperature: float = 0.0, generator=None, sampler=None,
             extra_batch=None):
    """prompts: (B, P) int.  Returns (B, gen) generated ids: a thin wrapper
    over `Engine.generate`."""
    return Engine(model).generate(params, prompts, gen=gen,
                                  temperature=temperature,
                                  generator=generator, sampler=sampler,
                                  extra_batch=extra_batch)


def stub_inputs(cfg, batch: int, prompt_len: int,
                generator: torch.Generator) -> dict:
    """What a one-shot prompt carries besides its tokens, as the
    reference's launcher draws it: a VLM's ``patches`` (batch, n_patches,
    d) and ``mrope_positions``, ``arange(n_patches + prompt_len)`` in all
    three components; an encoder-decoder's ``frames`` (batch, n_frames,
    d); standard normal draws from ``generator``, on its device."""
    dev, extra = generator.device, {}
    if cfg.vlm is not None:
        extra["patches"] = torch.randn(
            (batch, cfg.vlm.n_patches, cfg.d_model), generator=generator,
            device=dev)
        total = prompt_len + cfg.vlm.n_patches
        extra["mrope_positions"] = torch.arange(total, device=dev) \
            .expand(3, total)
    if cfg.encoder is not None:
        extra["frames"] = torch.randn(
            (batch, cfg.encoder.n_frames, cfg.d_model), generator=generator,
            device=dev)
    return extra


def load_requests(path: Path, vocab: int, default_gen: int,
                  seed: int = 0) -> list:
    """Parse a JSONL request file.  Lines carry explicit token ids
    (``{"prompt": [...]}``) or a synthetic length (``{"prompt_len": P}``,
    tokens drawn from a seeded numpy stream); ``gen`` defaults to
    ``default_gen``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        spec = json.loads(line)
        if "prompt" in spec:
            prompt = [int(t) for t in spec["prompt"]]
        else:
            prompt = rng.integers(0, vocab,
                                  int(spec["prompt_len"])).tolist()
        reqs.append(Request(rid=spec.get("id", i), prompt=prompt,
                            max_new=int(spec.get("gen", default_gen))))
    return reqs


def synthetic_requests(n: int, vocab: int, gen: int, seed: int = 0,
                       rng=None) -> list:
    """Staggered synthetic workload: prompt lengths cycle over a few
    buckets, gen lengths spread 1..gen.  Pass ``rng`` to draw contents
    from a caller-owned stream."""
    rng = np.random.default_rng(seed) if rng is None else rng
    p_lens = [8, 16, 24, 32]
    reqs = []
    for i in range(n):
        P = p_lens[i % len(p_lens)]
        g = 1 + int(rng.integers(0, gen))
        reqs.append(Request(rid=i, prompt=rng.integers(0, vocab, P).tolist(),
                            max_new=g))
    return reqs


def record_arrival_schedule(args, reqs, arrivals, path: Path) -> None:
    """Write the Poisson workload (stream seeds, per-request shape, the
    drawn arrival offsets) to ``path`` as JSON, so a load run is exactly
    reproducible.  ``path`` is the caller's: nothing else is written."""
    data = {"poisson": {
        "rate_req_s": args.poisson,
        "num_requests": len(reqs),
        "content_stream_seed": [args.seed, 0],
        "arrival_stream_seed": [args.seed, 1],
        "requests": [{"rid": r.rid, "prompt_len": len(r.prompt),
                      "gen": r.max_new} for r in reqs],
        "arrivals_s": [round(float(a), 6) for a in arrivals],
    }}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2))
    print(f"[serve] arrival schedule recorded in {path}")


def make_scheduler(model, params, args, max_len=None) -> Scheduler:
    """The `Scheduler` ``args`` describe, on the params' device; its block
    tables ``max_len`` tokens wide (default: the whole pool)."""
    return Scheduler(model, params, slots=args.slots, pages=args.pages,
                     page_size=args.page_size, max_len=max_len,
                     sampler=args.sampler, temperature=args.temperature,
                     seed=args.seed, use_kernel=args.paged_kernel,
                     decode_burst=args.decode_burst,
                     prefill_chunk=args.prefill_chunk,
                     prefix_cache=args.prefix_cache,
                     kv_dtype=args.kv_dtype)


def report(sch: Scheduler, wall: float, args) -> dict:
    """Print a drained scheduler's summary (``wall`` seconds of serving)
    and return `Scheduler.latency_summary`."""
    done = sch.finished
    summary = sch.latency_summary()
    toks = summary["tokens"]
    print(f"[serve] continuous batching: {len(done)} requests, "
          f"{toks} tokens in {wall:.1f}s ({toks / wall:.1f} tok/s), "
          f"slots={args.slots} pages={args.pages}x{args.page_size} "
          f"device={sch.device}")
    for k in ("p50_token_latency_s", "p95_token_latency_s",
              "p50_ttft_s", "p95_ttft_s",
              "mean_pool_utilization", "mean_internal_fragmentation",
              "preemptions", "prefill_chunks", "cow_copies",
              "prefix_hits", "prefix_hit_tokens", "prefix_evictions"):
        if k in summary:
            print(f"[serve]   {k} = {summary[k]:.4g}")
    for req in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"[serve]   req {req.rid}: prompt={len(req.prompt)} "
              f"-> {len(req.out)} tokens {req.out[:8]}...")
    return summary


def run_scheduler(model, params, reqs, args, arrivals=None) -> Scheduler:
    """Serve ``reqs`` with a `Scheduler` built from ``args``; prints the
    summary and returns the drained scheduler."""
    sch = make_scheduler(model, params, args)
    t0 = time.perf_counter()
    sch.run(reqs, arrivals=arrivals)
    report(sch, time.perf_counter() - t0, args)
    return sch


def apply_tuned(args, device) -> None:
    """``--autotune`` probes, ``--tuned-config`` reads a blob; either way
    its ``serve.tuned`` sets ``args.page_size`` and ``args.decode_burst``."""
    tuned = None
    if args.autotune:
        from repro_torch.analysis.autotune import autotune
        tuned = autotune(smoke=True, skip_train=True, kv_dtype=args.kv_dtype,
                         device=device)["serve"]["tuned"]
    elif args.tuned_config is not None:
        from repro_torch.analysis.autotune import load_tuned
        tuned = load_tuned(args.tuned_config).get("serve", {}).get("tuned")
    if tuned:
        args.page_size = int(tuned["page_size"])
        args.decode_burst = int(tuned["decode_burst"])
        print(f"[serve] autotuned: page_size={args.page_size} "
              f"decode_burst={args.decode_burst}")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    model, params, device = build(args)
    apply_tuned(args, device)
    cfg = model.cfg
    if args.requests is not None:
        reqs = load_requests(args.requests, cfg.vocab_size, args.gen,
                             seed=args.seed)
        return run_scheduler(model, params, reqs, args)
    if args.poisson is not None:
        # independently seeded streams: prompt contents and arrival gaps
        # never read the same bits
        content_rng = np.random.default_rng([args.seed, 0])
        arrival_rng = np.random.default_rng([args.seed, 1])
        reqs = synthetic_requests(args.num_requests, cfg.vocab_size,
                                  args.gen, rng=content_rng)
        gaps = arrival_rng.exponential(1.0 / max(args.poisson, 1e-6),
                                       len(reqs))
        arrivals = np.cumsum(gaps).tolist()
        record_arrival_schedule(args, reqs, arrivals, args.schedule_out)
        return run_scheduler(model, params, reqs, args, arrivals=arrivals)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device)
    extra = stub_inputs(cfg, args.batch, args.prompt_len, gen)
    t0 = time.perf_counter()
    ids = generate(model, params, prompts, gen=args.gen,
                   temperature=args.temperature, generator=gen,
                   sampler=args.sampler, extra_batch=extra).cpu()
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} -> {tuple(ids.shape)} in {dt:.1f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) device={device}")
    print("[serve] first sequence:", ids[0].tolist())
    return ids


if __name__ == "__main__":
    main()

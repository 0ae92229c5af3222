"""Batched serving across architecture families (the twin of the
repository's ``examples/serve_batched.py``): prefill a prompt batch,
decode greedily with the family-appropriate cache (KV / MLA latent / SSM
state / RG-LRU state / ring buffer), then a continuous-batching stream
through the paged-KV scheduler.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

Runs on the card unless ``--device cpu``.  Weights are random from seed 0
and prompts, patches and frames are drawn from torch generators; a
caller passes another package's weights (``params=``, numpy) and draws
(``prompts=``, ``extra=``) instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import generate, stub_inputs
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve.scheduler import Request, Scheduler

# the families the example serves, each with its cache kind
ARCHS = ("qwen3-0.6b",          # dense GQA + qk-norm
         "minicpm3-4b",         # MLA latent cache
         "falcon-mamba-7b",     # SSM O(1) state
         "recurrentgemma-9b",   # RG-LRU + local-attention ring
         "whisper-large-v3",    # enc-dec with cross-attention cache
         "olmoe-1b-7b")         # MoE (dropless at decode)
BATCH, PROMPT_LEN = 4, 16


def _on(x, device) -> torch.Tensor:
    """A tensor, or a copy of a numpy array, on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


def _model(arch: str, device, params):
    cfg = reduced(get_config(arch))
    model = Model(cfg, remat=False, q_chunk=32, kv_chunk=32, scan_chunk=32)
    params = model.init(torch.Generator(device=device).manual_seed(0)) \
        if params is None else params_from_numpy(params, device=device)
    return cfg, model, params


def demo(arch: str, gen: int = 8, *, device="cuda", params=None,
         prompts=None, extra=None) -> torch.Tensor:
    """Greedy decoding of a (4, 16) prompt batch for ``gen`` tokens;
    returns the (4, gen) ids.  ``prompts`` / ``extra`` (a VLM's patches
    and M-RoPE positions, an encoder-decoder's frames) default to draws
    from a seed-0 generator (`repro_torch.launch.serve.stub_inputs`)."""
    device = resolve_device(device)
    cfg, model, params = _model(arch, device, params)
    g = torch.Generator(device=device).manual_seed(0)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                                generator=g, device=device)
    if extra is None:
        extra = stub_inputs(cfg, BATCH, PROMPT_LEN, g)
    prompts, extra = _on(prompts, device), {k: _on(v, device)
                                            for k, v in extra.items()}
    t0 = time.time()
    ids = generate(model, params, prompts, gen=gen, temperature=0.0,
                   extra_batch=extra or None)
    print(f"  {arch:25s} family={cfg.family:7s} -> {tuple(ids.shape)} "
          f"in {time.time()-t0:4.1f}s  first: {ids[0, :6].tolist()}")
    return ids


def demo_continuous(arch: str = "qwen3-0.6b", *, device="cuda",
                    params=None, prompts=None) -> list:
    """Continuous batching: 6 staggered requests (prompts of 8, 12 and 16
    tokens, 3 + 3i new tokens) through the paged-KV scheduler over 2
    slots, 48 pages of 8 tokens, decode bursts of 2: short requests evict
    early, waiting ones join mid-flight, pages recycle through the pool.
    ``prompts``: the 6 prompts' token lists (default: seed-1 draws).
    Returns the finished requests."""
    device = resolve_device(device)
    cfg, model, params = _model(arch, device, params)
    if prompts is None:
        g = torch.Generator().manual_seed(1)
        prompts = [torch.randint(0, cfg.vocab_size, (8 + 4 * (i % 3),),
                                 generator=g).tolist() for i in range(6)]
    reqs = [Request(rid=i, prompt=list(prompts[i]), max_new=3 + 3 * i)
            for i in range(6)]
    sch = Scheduler(model, params, slots=2, pages=48, page_size=8,
                    decode_burst=2)
    t0 = time.time()
    done = sch.run(reqs)
    s = sch.latency_summary()
    print(f"\n[serve_batched] continuous batching: {len(done)} staggered "
          f"requests over 2 slots in {time.time()-t0:.1f}s "
          f"({s['tokens']} tokens, {s['prefills']} prefill groups, "
          f"pool util {s.get('mean_pool_utilization', 0):.0%})")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt={len(r.prompt):2d} -> "
              f"{len(r.out):2d} tokens")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    args = ap.parse_args(argv)
    print("[serve_batched] greedy decode, 4 sequences x 8 tokens each:")
    ids = {arch: demo(arch, device=args.device) for arch in ARCHS}
    done = demo_continuous(device=args.device)
    return {"ids": ids, "done": done}


if __name__ == "__main__":
    main()

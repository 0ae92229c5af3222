"""End-to-end training entry point (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --layers 4 --steps 6 --workers 2 --batch-per-worker 4 --seq 256 \\
      --algo dc_s3gd --buckets 4 --use-kernels

Runs on the card (``--device cuda``, the default) unless asked for the
CPU.  Weights are random, drawn from ``--seed``; the data is the
synthetic LM stream of `repro_torch.data.pipeline`.  ``--layers`` cuts the
depth and keeps every width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.launch.engine import Engine
from repro_torch.models.transformer import Model


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--algo", choices=registry.names(), default="dc_s3gd",
                    help="'stale' = DC-S3GD with lambda0=0 (no compensation)")
    ap.add_argument("--reducer", choices=registry.names(registry.REDUCER),
                    default="mean_allreduce")
    ap.add_argument("--comm-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="wire dtype for the reducer payload")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--lambda0", type=float, default=0.2)
    ap.add_argument("--warmup-frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", type=Path, default=None)
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the update tail through the fused kernels")
    ap.add_argument("--buckets", type=int, default=0,
                    help="pack comm state into this many contiguous flat "
                         "buckets; 0 = per-leaf reduce/update")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    return ap


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card
    raises rather than running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def build(args, *, device=None):
    """The run ``args`` describe, ready to step: (model, algorithm, initial
    `TrainState`, ``batch_fn(step)``), on ``device`` (default
    ``args.device``)."""
    device = resolve_device(args.device if device is None else device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg, loss_chunk=256)
    dc_cfg = DCS3GDConfig(
        learning_rate=args.lr, momentum=args.momentum, lambda0=args.lambda0,
        warmup_steps=max(int(args.warmup_frac * args.steps), 1),
        total_steps=args.steps, comm_dtype=args.comm_dtype)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    n_params = sum(x.numel() for x in T.leaves(params))
    alg = registry.make(args.algo, dc_cfg, n_workers=args.workers,
                        reducer=args.reducer,
                        use_kernels=args.use_kernels, buckets=args.buckets)
    state = alg.init(params)
    del params
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=args.seed)
    print(f"[train] {cfg.name} x{cfg.n_layers} layers "
          f"({n_params / 1e6:.1f}M params) algo={alg.name} W={args.workers} "
          f"b={args.batch_per_worker} seq={args.seq} buckets={args.buckets} "
          f"kernels={args.use_kernels} device={device}")

    def batch_fn(it):
        return worker_batches(data, it, args.workers, args.batch_per_worker,
                              device=device)

    return model, alg, state, batch_fn


def run(args, *, device=None) -> dict:
    """Train per ``args`` (a `build_argparser` namespace) on ``device``
    (default ``args.device``).  Returns the run summary with its metric
    history; ``result["state"]`` is the final `TrainState`."""
    model, alg, state, batch_fn = build(args, device=device)
    state, history, wall = Engine(model, alg).fit(
        state, batch_fn, steps=args.steps, log_every=args.log_every)
    result = {
        "arch": model.cfg.name, "n_layers": model.cfg.n_layers,
        "algo": args.algo, "steps": args.steps, "workers": args.workers,
        "device": str(T.leaves(state.params)[0].device),
        "final_loss": history[-1]["loss"], "wall_s": wall,
        "tokens_per_s": (args.steps * args.workers * args.batch_per_worker
                         * args.seq / wall),
        "history": history,
    }
    if args.metrics_out:
        args.metrics_out.parent.mkdir(parents=True, exist_ok=True)
        args.metrics_out.write_text(json.dumps(result, indent=2))
    result["state"] = state
    return result


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

"""End-to-end example: train a ~100M-param decoder LM with DC-S3GD, with
checkpointing and the paper's LR/WD schedule (the twin of the
repository's ``examples/train_lm_100m.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m \\
      --steps 20 --layers 2 --device cpu

Runs on the card unless ``--device cpu``.  Weights are random from seed 0
(``params=`` carries another package's weights over as numpy).  The
checkpoints hold the averaged weights (paper Eq. 8) in the ``.npz``
layout the reference's ``restore_pytree`` reads.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import save_pytree
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig, ModelConfig
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import fetch_metrics
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import Model


def config_100m(n_layers: int) -> ModelConfig:
    """~100M params at 12 layers (GPT-2-small-ish dims, qwen3-style
    blocks), the reference example's."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=n_layers, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000, head_dim=64,
        qk_norm=True, param_dtype="float32", compute_dtype="float32",
        source="example driver (deliverable b)")


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--out", type=Path, default=Path("experiments/lm100m"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    return ap


def main(argv=None, *, params=None) -> dict:
    """Returns the logged ``history`` (every 10th step and the last, host
    floats), the checkpoint paths written (``ckpts``), the final
    ``state``, the algorithm (``alg``) and ``wall_s``."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_100m(args.layers)
    model = Model(cfg, remat=False, loss_chunk=256)
    params = model.init(torch.Generator(device=device).manual_seed(0)) \
        if params is None else params_from_numpy(params, device=device)
    n = sum(x.numel() for x in T.leaves(params))
    print(f"[lm100m] {n/1e6:.1f}M params, {args.workers} DC workers, "
          f"seq={args.seq}")

    dc_cfg = DCS3GDConfig(learning_rate=0.02, momentum=0.9, lambda0=0.2,
                          weight_decay=1e-4,
                          warmup_steps=max(args.steps // 6, 1),
                          total_steps=args.steps)
    alg = registry.make("dc_s3gd", dc_cfg, n_workers=args.workers)
    state = alg.init(params)
    del params

    data = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=0)
    history, ckpts = [], []
    t0 = time.time()
    for it in range(args.steps):
        batch = worker_batches(data, it, args.workers,
                               args.batch_per_worker, device=device)
        state, m = alg.step(state, batch, loss_fn=model.loss)
        if it % 10 == 0 or it == args.steps - 1:
            m = fetch_metrics(m)
            history.append({"step": it, **m})
            tok_s = (it + 1) * args.workers * args.batch_per_worker * \
                args.seq / (time.time() - t0)
            print(f"[lm100m] step {it:4d} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.4f} |D|={m['distance_norm']:.2e} "
                  f"({tok_s:.0f} tok/s)")
        if args.ckpt_every and it and it % args.ckpt_every == 0:
            ckpts.append(save_pytree(args.out / f"step{it}.npz",
                                     alg.eval_params(state), step=it))
    ckpts.append(save_pytree(args.out / "final.npz", alg.eval_params(state),
                             step=args.steps))
    wall = time.time() - t0
    print(f"[lm100m] done in {wall:.0f}s; "
          f"final checkpoint -> {args.out}/final.npz")
    return {"history": history, "ckpts": ckpts, "state": state, "alg": alg,
            "wall_s": wall}


if __name__ == "__main__":
    main()

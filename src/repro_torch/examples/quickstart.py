"""Quickstart: DC-S3GD on a small LM (the twin of the repository's
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on the card unless ``--device cpu``.  Weights are random from seed 0
(``params=`` carries another package's weights over as numpy).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import fetch_metrics
from repro_torch.launch.train import resolve_device
from repro_torch.models.transformer import Model


def run(*, device="cuda", params=None, steps: int = 60) -> dict:
    """The example's run: the reduced qwen3 under DC-S3GD at W = 4 for
    ``steps`` steps, then the averaged-weight evaluation (paper Eq. 8).
    Returns the logged ``history`` (every 10th step and the last, as
    host floats), ``eval_loss`` and the final ``state``."""
    device = resolve_device(device)
    # 1. pick an architecture (any of the 10 assigned ones) at smoke scale
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg, remat=False, q_chunk=32, kv_chunk=32, scan_chunk=32,
                  loss_chunk=64)
    params = model.init(torch.Generator(device=device).manual_seed(0)) \
        if params is None else params_from_numpy(params, device=device)
    print(f"model: {cfg.name}, "
          f"{sum(x.numel() for x in T.leaves(params))/1e6:.1f}M params")

    # 2. wrap it in the paper's optimizer: 4 decentralized workers,
    #    stale-synchronous with delay compensation (Algorithm 1).  The
    #    registry builds the algorithm from config: swap "dc_s3gd" for
    #    "ssgd" / "stale" / "dc_asgd", or pass reducer="gossip", and
    #    nothing else changes.
    dc_cfg = DCS3GDConfig(learning_rate=0.1, momentum=0.9, lambda0=0.2,
                          warmup_steps=10, total_steps=steps)
    alg = registry.make("dc_s3gd", dc_cfg, n_workers=4)
    state = alg.init(params)

    # 3. train: each worker sees a disjoint shard of the stream
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=64, seed=0)
    history = []
    for t in range(steps):
        batch = worker_batches(data, t, alg.n_workers, per_worker=4,
                               device=device)
        state, m = alg.step(state, batch, loss_fn=model.loss)
        if t % 10 == 0 or t == steps - 1:
            m = fetch_metrics(m)
            history.append({"step": t, **m})
            print(f"step {t:3d}  loss={m['loss']:.4f}  "
                  f"lr={m['lr']:.3f}  lambda={m['lambda']:.3f}  "
                  f"|D_i|={m['distance_norm']:.2e}")

    # 4. evaluate with the averaged weights (paper Eq. 8)
    avg = alg.eval_params(state)
    eval_batch = {k: v[0] for k, v in
                  worker_batches(data, 999, 1, 8, device=device).items()}
    eval_loss = float(model.loss(avg, eval_batch))
    print("averaged-weight eval loss:", eval_loss)
    return {"history": history, "eval_loss": eval_loss, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()

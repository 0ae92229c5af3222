"""Paper-faithful reproduction example: the CNN experiment family (the
twin of the repository's ``examples/cnn_paper_repro.py``).

Trains the (reduced) ResNet with the exact hyper-parameter recipe of
§IV-A — momentum SGD, theoretical LR = N*eta_sn, linear warm-up stopped
early + linear decay applied to BOTH lr and weight decay (k = 2.3), no
decay on rank-1 params — comparing SSGD / stale(λ0=0) / DC-S3GD.

  PYTHONPATH=src python -m repro_torch.examples.cnn_paper_repro --workers 8
  PYTHONPATH=src python -m repro_torch.examples.cnn_paper_repro \\
      --workers 4 --steps 6 --device cpu

Runs on the card unless ``--device cpu``; TF32 is off for matmuls and
convolutions, as the reference computes in f32.  Weights are random from
seed 0 (``params=`` carries another package's weights over as numpy).
"""
from __future__ import annotations

import argparse
import types

import torch

from repro_torch import tree as T
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.data.pipeline import (SyntheticImageDataset, prefetch,
                                       worker_batches)
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.launch.train import resolve_device
from repro_torch.models.cnn import (cnn_loss_fn, init_resnet, resnet_apply,
                                    strict_f32, top1_error)
from repro_torch.optim.schedules import theoretical_lr

# the example's reduced ResNet and data
NET = {"stages": (1, 1), "width": 8, "n_classes": 8}
IMAGE_SIZE, NOISE, PER_WORKER = 16, 0.4, 16


def recipe(n_workers: int, steps: int, eta_sn: float = 0.05
           ) -> DCS3GDConfig:
    """The §IV-A hyper-parameters for ``n_workers`` and ``steps``."""
    return DCS3GDConfig(
        learning_rate=theoretical_lr(eta_sn, n_workers),  # Eq. 16
        momentum=0.9, lambda0=0.2,
        weight_decay=1e-4, weight_decay_k=2.3,            # §IV-A
        warmup_steps=max(steps // 6, 1),                  # early-stopped warmup
        total_steps=steps)


def build(algo: str, cfg: DCS3GDConfig, n_workers: int, steps: int, *,
          device="cuda", params=None, seed: int = 0, net=None,
          image_size: int = IMAGE_SIZE, per_worker: int = PER_WORKER,
          start: int = 0, **make_kw):
    """A ResNet run ready to step: (model with ``.loss``, algorithm,
    initial state, ``batch_fn(step, n_workers=None)``, dataset), on
    ``device``.

    ``net`` holds `init_resnet`'s keywords (default `NET`); ``params`` (a
    numpy tree) replaces the seeded init; ``make_kw`` (``use_kernels``,
    ``buckets``, ``overlap``, ``reducer``, ``local_optimizer``,
    ``staleness`` ...) pass through to ``registry.make``.  Batches for
    steps ``start .. steps-1`` (``start``: a resumed run's step) are
    drawn on a prefetch thread and copied to the device when ``batch_fn``
    is called, which must be in step order.  An elastic run passes its
    live worker count: worker w's batch depends on (seed, step, w) alone,
    so a smaller count takes the first rows of the prefetched batch and a
    larger one draws its batch there and then."""
    device = resolve_device(device)
    strict_f32()
    net = dict(NET if net is None else net)
    params = init_resnet(torch.Generator(device=device).manual_seed(seed),
                         **net) if params is None \
        else params_from_numpy(params, device=device)
    ds = SyntheticImageDataset(n_classes=net["n_classes"],
                               image_size=image_size, seed=seed, noise=NOISE)
    alg = registry.make(algo, cfg, n_workers=n_workers, **make_kw)
    state = alg.init(params)
    del params
    host = prefetch((t, worker_batches(ds, t, n_workers, per_worker,
                                       device="cpu"))
                    for t in range(start, steps))

    def batch_fn(it, n=None):
        t, batch = next(host)
        if t != it:
            raise ValueError(f"batch_fn({it}) called out of step order: the "
                             f"next prefetched batch is step {t}")
        n = n_workers if n is None else n
        if n > n_workers:
            batch = worker_batches(ds, it, n, per_worker, device="cpu")
        return T.map(lambda x: x[:n].to(device), batch)

    model = types.SimpleNamespace(loss=cnn_loss_fn(resnet_apply))
    return model, alg, state, batch_fn, ds


def run(algo: str, cfg: DCS3GDConfig, n_workers: int, steps: int, *,
        device="cuda", per_worker: int = PER_WORKER, log_every=None,
        measure_skew: bool = False, **kw) -> dict:
    """Train with ``algo`` for ``steps`` steps (`build` takes ``kw``),
    then evaluate the consensus weights: top-1 error over 4 batches of
    64.  Returns ``loss`` (the last step's), ``top1_err``, the metric
    ``history``, ``wall_s``, ``images_per_s`` and the final ``state``."""
    device = resolve_device(device)
    model, alg, state, batch_fn, ds = build(
        algo, cfg, n_workers, steps, device=device, per_worker=per_worker,
        **kw)
    state, history, wall = Engine(model, alg).fit(
        state, batch_fn, steps=steps, log_every=log_every or steps,
        measure_skew=measure_skew)
    final = alg.eval_params(state)
    errs = [float(top1_error(resnet_apply, final, {
        k: torch.from_numpy(v).to(device)
        for k, v in ds.batch(10_000 + i, 0, 64).items()})) for i in range(4)]
    return {"loss": history[-1]["loss"], "top1_err": sum(errs) / len(errs),
            "history": history, "wall_s": wall,
            "images_per_s": steps * n_workers * per_worker / wall,
            "state": state}


def train(algo: str, n_workers: int, steps: int, eta_sn: float = 0.05, *,
          use_kernels: bool = False, buckets: int = 0, **kw) -> dict:
    """The example's run: `run` with the §IV-A `recipe`."""
    return run(algo, recipe(n_workers, steps, eta_sn), n_workers, steps,
               use_kernels=use_kernels, buckets=buckets, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    print(f"[cnn_repro] ResNet (reduced), N={args.workers} workers, "
          f"{args.steps} steps — paper Table I analogue")
    print(f"{'algo':10s} {'train_loss':>11s} {'val_top1_err':>13s}")
    for algo in ("ssgd", "stale", "dc_s3gd"):
        r = train(algo, args.workers, args.steps, device=args.device)
        print(f"{algo:10s} {r['loss']:11.4f} {r['top1_err']:13.3f}")
    print("expected ordering: dc_s3gd ~ ssgd <= stale "
          "(the correction recovers the synchronous trajectory)")


if __name__ == "__main__":
    main()

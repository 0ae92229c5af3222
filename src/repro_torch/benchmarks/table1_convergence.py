"""Paper Table I analogue — final accuracy of DC-S3GD vs baselines (the
twin of the repository's ``benchmarks/table1_convergence.py``).

Trains the paper's own model family — a reduced ResNet on synthetic
prototype images — with every requested algorithm (default: ssgd / stale /
dc_s3gd), each built through ``registry.make``, and prints CSV rows
``name,us_per_call,derived``.  Writes no file.

  PYTHONPATH=src python -m repro_torch.benchmarks.table1_convergence \\
      [--algo dc_s3gd ...] [--reducer gossip] [--steps 60] [--device cpu]

Claim validated: dc_s3gd ~ ssgd >= stale, i.e. the first-order correction
recovers the synchronous trajectory while retaining the overlap.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import emit, requested_algos
from repro_torch.core.types import DCS3GDConfig
from repro_torch.examples.cnn_paper_repro import run


def run_cnn(algo: str, n_workers: int = 4, steps: int = 60,
            lr: float = 0.4, seed: int = 0, reducer: str = "mean_allreduce",
            *, device="cuda", params=None):
    """(final loss, top-1 error) of one algorithm; ``params`` (numpy)
    replaces the seeded init."""
    cfg = DCS3GDConfig(learning_rate=lr, momentum=0.9, lambda0=0.2,
                       weight_decay=1e-4, warmup_steps=max(steps // 6, 1),
                       total_steps=steps)
    r = run(algo, cfg, n_workers, steps, device=device, params=params,
            seed=seed, reducer=reducer)
    return r["loss"], r["top1_err"]


def main(args=None):
    """Rows for ``args.algos`` (default all three) with ``args.reducer``,
    ``args.steps`` (default 60) and ``args.device`` (default cuda)."""
    algos = requested_algos(args)
    reducer = getattr(args, "reducer", None) or "mean_allreduce"
    steps = getattr(args, "steps", None) or 60
    device = getattr(args, "device", None) or "cuda"
    rows = []
    for algo in algos:
        loss, err = run_cnn(algo, steps=steps, reducer=reducer,
                            device=device)
        rows.append((algo, loss, err))
        emit(f"table1_resnet_{algo}", 0.0,
             f"final_loss={loss:.4f};top1_err={err:.3f}")
    # validation of the paper's ordering (when the three columns exist);
    # it reports on three named results and dispatches on none of them
    errs = {a: e for a, _, e in rows}
    if {"dc_s3gd", "stale", "ssgd"} <= set(errs):  # lint: allow(algo-branch)
        ok = errs["dc_s3gd"] <= errs["stale"] + 0.05
        emit("table1_claim_dc_recovers_ssgd", 0.0,
             f"dc={errs['dc_s3gd']:.3f};stale={errs['stale']:.3f};"
             f"ssgd={errs['ssgd']:.3f};holds={ok}")
    return rows


def _cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", dest="algos", action="append", default=None)
    ap.add_argument("--reducer", default="mean_allreduce")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    return main(ap.parse_args(argv))


if __name__ == "__main__":
    _cli()

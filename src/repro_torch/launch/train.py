"""End-to-end training entry point (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --layers 4 --steps 6 --workers 2 --batch-per-worker 4 --seq 256 \\
      --algo dc_s3gd --buckets 4 --use-kernels

Runs on the card (``--device cuda``, the default) unless asked for the
CPU.  Weights are random, drawn from ``--seed``; the data is the
synthetic LM stream of `repro_torch.data.pipeline`.  ``--layers`` cuts the
depth and keeps every width.

``--ckpt PATH`` saves the final state with the metadata of the algorithm
that trained it; ``--resume PATH`` restores it and continues at its step,
the checkpoint's {algo, reducer and its options, local_optimizer,
n_workers, staleness, buckets, overlap} winning over the flags (a file
written without metadata falls back to them).  An explicit ``--workers``
that differs from the checkpoint's count is an **elastic resume**: the
state is restored at the checkpoint's W and resharded through
`repro_torch.cluster`'s collapse-to-consensus resize.
``--fault-schedule`` / ``--eject-skew`` make the run itself elastic
(scripted churn, straggler ejection); the result then carries the
transition log.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint_exists, checkpoint_meta
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.launch.engine import CKPT_ALGO_KEYS, Engine
from repro_torch.models.transformer import Model


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--algo", choices=registry.names(), default="dc_s3gd",
                    help="'stale' = DC-S3GD with lambda0=0 (no compensation);"
                         " 'ssgd' = the synchronous baseline; 'dc_asgd' = "
                         "the parameter-server simulator")
    ap.add_argument("--reducer", choices=registry.names(registry.REDUCER),
                    default="mean_allreduce",
                    help="topk / topk_exact / randk / powersgd = error-"
                         "feedback compressed, need --buckets > 0; gossip /"
                         " hierarchical mix the weights")
    ap.add_argument("--gossip-neighbors", type=int, default=1,
                    help="ring neighbors per side for --reducer gossip / "
                         "hierarchical")
    ap.add_argument("--compress-density", type=float, default=0.01,
                    help="kept fraction per bucket for --reducer "
                         "topk/topk_exact/randk")
    ap.add_argument("--compress-rank", type=int, default=4,
                    help="low-rank factor width for --reducer powersgd")
    ap.add_argument("--comm-dtype", default="float32",
                    choices=["float32", "bfloat16", "float16", "int8",
                             "fp8"],
                    help="wire dtype for the reducer payload (int8/fp8 "
                         "carry one f32 scale per worker row)")
    ap.add_argument("--local-optimizer", default=None,
                    choices=registry.names(registry.LOCAL_OPTIMIZER),
                    help="override cfg.local_optimizer (momentum)")
    ap.add_argument("--staleness", default="fixed",
                    choices=registry.names(registry.STALENESS_POLICY),
                    help="stale-window policy (dynamic_ssp = skew threshold)")
    ap.add_argument("--ssp-threshold", type=int, default=4,
                    help="max per-worker step skew for --staleness "
                         "dynamic_ssp")
    ap.add_argument("--measure-skew", action="store_true",
                    help="drive the staleness policy from measured step "
                         "times (synchronises every step; see Engine.fit)")
    ap.add_argument("--skew-warmup", type=int, default=1,
                    help="leading steps excluded from the measured-skew "
                         "virtual clock; re-arms after every resize")
    ap.add_argument("--fault-schedule", type=Path, default=None,
                    help="JSON fault schedule (repro_torch.cluster.faults): "
                         "scripted join/leave/eject/slowdown events make "
                         "the run elastic")
    ap.add_argument("--eject-skew", type=float, default=None,
                    help="eject a worker whose measured virtual-clock lag "
                         "exceeds this many steps persistently (needs "
                         "--measure-skew); unset disables ejection")
    ap.add_argument("--eject-patience", type=int, default=3,
                    help="consecutive over-threshold observations before "
                         "an ejection fires")
    ap.add_argument("--min-workers", type=int, default=2,
                    help="the ejection policy never shrinks below this")
    ap.add_argument("--transition-log", type=Path, default=None,
                    help="write the membership transition log (JSON) here")
    ap.add_argument("--dense-after-join", type=int, default=0,
                    help="run this many steps on the dense wire after an "
                         "elastic join before re-enabling a compressed "
                         "(error-feedback) reducer: delivers the joiner's "
                         "inherited residual in one step")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=None,
                    help="worker count W (default 4; on --resume the "
                         "checkpoint's count: a different count reshards "
                         "the state through the elastic resize, e.g. a "
                         "W=8 checkpoint resumed at 6)")
    ap.add_argument("--batch-per-worker", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--lambda0", type=float, default=0.2)
    ap.add_argument("--warmup-frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", type=Path, default=None,
                    help="save the final state (with its algorithm's "
                         "metadata) here")
    ap.add_argument("--resume", type=Path, default=None,
                    help="continue from this checkpoint at its step")
    ap.add_argument("--metrics-out", type=Path, default=None)
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the update tail (and a topk/topk_exact "
                         "reducer's compression) through the fused kernels")
    ap.add_argument("--buckets", type=int, default=0,
                    help="pack comm state into this many contiguous flat "
                         "buckets; 0 = per-leaf reduce/update")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered bucket pipeline (repro_torch."
                         "parallel.pipeline): issue each step's reduce at "
                         "its end, consume it at the next step's top; "
                         "needs --buckets > 0")
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


def _adopt_resume_meta(args) -> None:
    """The checkpoint's metadata wins over the re-passed algorithm flags."""
    meta = checkpoint_meta(args.resume)
    adopted = {k: meta[k] for k in CKPT_ALGO_KEYS if meta.get(k) is not None}
    if not adopted:
        return
    args.algo = adopted.get("algo", args.algo)
    args.reducer = adopted.get("reducer", args.reducer)
    # the recorded hyper-parameters rebuild the exact reducer
    args.reducer_opts = adopted.get("reducer_opts", None)
    args.local_optimizer = adopted.get("local_optimizer",
                                       args.local_optimizer)
    args.staleness = adopted.get("staleness", args.staleness)
    args.ssp_threshold = int(adopted.get("ssp_threshold",
                                         args.ssp_threshold))
    args.workers = int(adopted.get("n_workers", args.workers))
    args.buckets = int(adopted.get("buckets", args.buckets) or 0)
    args.overlap = bool(adopted.get("overlap", args.overlap) or False)
    print(f"[train] resume metadata: {adopted}")


def build(args, *, device=None):
    """The run ``args`` describe, ready to step: (model, algorithm, initial
    `TrainState`, ``batch_fn(step, n_workers=args.workers)``), on
    ``device`` (default ``args.device``)."""
    device = resolve_device(args.device if device is None else device)
    if args.workers is None:
        args.workers = 4
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg, loss_chunk=256)
    dc_cfg = DCS3GDConfig(
        learning_rate=args.lr, momentum=args.momentum, lambda0=args.lambda0,
        warmup_steps=max(int(args.warmup_frac * args.steps), 1),
        total_steps=args.steps, comm_dtype=args.comm_dtype,
        local_optimizer=args.local_optimizer or "momentum",
        ssp_threshold=args.ssp_threshold,
        gossip_neighbors=args.gossip_neighbors,
        compress_density=args.compress_density,
        compress_rank=args.compress_rank)

    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    n_params = sum(x.numel() for x in T.leaves(params))
    reducer = registry.make_reducer(args.reducer, dc_cfg,
                                    **(getattr(args, "reducer_opts", None)
                                       or {}))
    alg = registry.make(args.algo, dc_cfg, n_workers=args.workers,
                        reducer=reducer, staleness=args.staleness,
                        use_kernels=args.use_kernels, buckets=args.buckets,
                        overlap=args.overlap)
    state = alg.init(params)
    del params
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=args.seed)
    reducer = getattr(getattr(alg, "reducer", None), "name", "-")
    print(f"[train] {cfg.name} x{cfg.n_layers} layers "
          f"({n_params / 1e6:.1f}M params) algo={alg.name} "
          f"reducer={reducer}/{args.comm_dtype} "
          f"optimizer={alg.local_optimizer.name} "
          f"staleness={getattr(getattr(alg, 'staleness', None), 'name', '-')}"
          f" W={args.workers} "
          f"b={args.batch_per_worker} seq={args.seq} buckets={args.buckets} "
          f"overlap={args.overlap} kernels={args.use_kernels} "
          f"device={device}")

    def batch_fn(it, n_workers=None):
        return worker_batches(data, it, args.workers if n_workers is None
                              else n_workers, args.batch_per_worker,
                              device=device)

    return model, alg, state, batch_fn


def run(args, *, device=None) -> dict:
    """Train per ``args`` (a `build_argparser` namespace) on ``device``
    (default ``args.device``).  Returns the run summary with its metric
    history (and ``transitions``, the membership log, for an elastic
    run); ``result["state"]`` is the final `TrainState`."""
    # an explicit --workers on resume asks for an elastic resume: restore
    # at the checkpoint's count, then reshard
    requested = args.workers
    resuming = args.resume is not None and checkpoint_exists(args.resume)
    if resuming:
        _adopt_resume_meta(args)
    resize_to = requested if (resuming and requested is not None
                              and requested != args.workers) else None
    model, alg, state, batch_fn = build(args, device=device)
    engine = Engine(model, alg)
    start = 0
    if resuming:
        state = engine.restore(args.resume, state)
        start = state.step
        print(f"[train] resumed from {args.resume} at step {start}")
        if resize_to is not None:
            # the live resize's code path: the resharded consensus is
            # bitwise the checkpoint's
            from repro_torch.cluster import rebuild_algorithm
            state = alg.resize_state(state, resize_to)
            engine.alg = alg = rebuild_algorithm(alg, resize_to)
            print(f"[train] elastic resume: resharded W={args.workers} -> "
                  f"W={resize_to}")
            args.workers = resize_to
    membership = None
    if args.fault_schedule is not None or args.eject_skew is not None:
        from repro_torch.cluster import FaultSchedule, Membership
        faults = FaultSchedule.from_json(args.fault_schedule) \
            if args.fault_schedule is not None else None
        membership = Membership(alg, faults=faults,
                                eject_threshold=args.eject_skew,
                                eject_patience=args.eject_patience,
                                min_workers=args.min_workers,
                                dense_after_join=args.dense_after_join)
    state, history, wall = engine.fit(
        state, batch_fn, steps=args.steps, start=start,
        log_every=args.log_every, measure_skew=args.measure_skew,
        skew_warmup=args.skew_warmup, membership=membership)
    ckpt = None
    if args.ckpt:
        # engine.alg follows membership transitions: the metadata records
        # the worker count the state has
        t0 = time.perf_counter()
        path = engine.save(args.ckpt, state, step=args.steps)
        ckpt = {"path": str(path), "bytes": path.stat().st_size,
                "save_s": time.perf_counter() - t0}
        print(f"[train] checkpoint -> {path} ({ckpt['bytes']} B in "
              f"{ckpt['save_s']:.2f} s)")
    workers = membership.n_workers if membership is not None \
        else args.workers
    result = {
        "arch": model.cfg.name, "n_layers": model.cfg.n_layers,
        "algo": args.algo, "steps": args.steps, "start": start,
        "workers": workers,
        "device": str(T.leaves(state.params)[0].device),
        "final_loss": history[-1]["loss"] if history else None,
        "wall_s": wall,
        "tokens_per_s": ((args.steps - start) * args.workers
                         * args.batch_per_worker * args.seq / wall)
        if history else 0.0,
        "history": history,
    }
    if ckpt is not None:
        result["ckpt"] = ckpt
    if membership is not None:
        result["transitions"] = membership.log
        if args.transition_log is not None:
            args.transition_log.parent.mkdir(parents=True, exist_ok=True)
            args.transition_log.write_text(
                json.dumps(membership.log, indent=2))
            print(f"[train] transition log -> {args.transition_log}")
    if args.metrics_out:
        args.metrics_out.parent.mkdir(parents=True, exist_ok=True)
        args.metrics_out.write_text(json.dumps(result, indent=2))
    result["state"] = state
    return result


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

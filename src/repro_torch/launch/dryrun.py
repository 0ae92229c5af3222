"""Multi-pod dry-run: every (arch x input shape) built, sharded and traced
on the production meshes with nothing placed on any device (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each step for 256 / 512 placeholder
XLA devices.  Eager PyTorch has no compiler to ask, so the port answers
the same questions another way:

* **the mesh** is a real ``DeviceMesh`` over a ``fake`` process group of
  256 / 512 ranks (PyTorch's testing backend: collectives are no-ops),
  started in this process only, so `launch.mesh.make_production_mesh`
  builds the production layouts;
* **inputs** are fake tensors (`launch.specs`); **specs** come from the
  `Engine`: the algorithm's own ``state_specs`` / ``batch_specs`` for
  training, the partition rules minus the worker axis for serving;
* **the type check** (the reference's compile): every sharded dim must
  divide by its axes (`parallel.sharding.local_shape`); a failure writes
  a FAIL record and exits 1;
* **one rank's step**: on every mesh, the production ones (16, 16) and
  (2, 16, 16) with 'model' 16 and the small ('data', 'model') debug
  meshes named ``DxM`` (``--mesh 1x2``), the traced step is rank 0's,
  run through a bound `Engine` on its local shards of fake tensors: a
  training step on its worker rows, or a serving one (the prefill or a
  decode step on the rank's serve params, batch rows and cache shard).
  The Model is built as the reference's dry-run builds it: ``remat``
  on for train and prefill (``seq_parallel`` from
  ``DRYRUN_SEQ_PARALLEL`` for train), off for decode; the plain route
  (``kernels=False``);
* **memory**: ``argument_bytes`` / ``output_bytes`` are the per-device
  bytes of the local shards of the step's inputs / outputs (replicated
  leaves whole); ``peak_bytes`` is the most the traced step holds at
  once on the device, by ``torch.distributed._tools.mem_tracker.
  MemTracker`` over the fake tensors (its inputs counted from the
  start), and ``temp_bytes`` that peak less ``argument_bytes``
  (``memory.note``);
* **roofline**: `analysis.optrace` of the step run under the fake mode on
  the plain route (no kernel), one device's: the FLOPs and bytes of the
  rank's step; the worker-axis wire is the reducer's payload of the
  rank's rows, at NVLink's and at the node network's rate; the
  collectives the step issues over 'model' (the ``tp`` scope: the
  row-parallel sums, the vocabulary-parallel loss's terms, a serving
  step's vocabulary gather and gathered cache positions; under ``remat``
  the ones the backward's recompute issues again) are priced at
  NVLink's rate (``tp_bytes``, ``collective_tp_s``) beside the wire
  (``roofline.note``).  A compressed wire or a quantized ``comm_dtype``
  reduces the whole buckets (`repro_torch.parallel.tensor.WholeWire`):
  the wire is the whole plan's, as in one process, and the gather of the
  rank's payload is one of the ``tp`` collectives, printed apart.
  ``lower_s`` is the seconds spent building the abstract inputs and
  their specs, ``compile_s`` the traced step's.  A combo the bound path
  cannot build writes a FAIL record naming the reason.

This is the one entry point that places nothing on any device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import optrace
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig, INPUT_SHAPES
from repro_torch.launch import specs as S
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import (axis_sizes, make_debug_mesh,
                                     make_production_mesh,
                                     n_workers)
from repro_torch.models.transformer import Model
from repro_torch.parallel import sharding as shd

DEFAULT_OUT = Path("experiments/dryrun_torch")

MEMORY_NOTE = ("argument_bytes / output_bytes: per-device bytes of the "
               "local shards under the Engine's specs (replicated leaves "
               "whole; the step counter as the int32 the reference "
               "carries); peak_bytes: the most one rank's traced step "
               "holds at once (MemTracker over its fake tensors, the "
               "inputs counted from the start); temp_bytes: peak_bytes "
               "less argument_bytes, the most the step holds beyond its "
               "inputs (not XLA's temp, which leaves out aliased "
               "outputs).  The reference donates the train state and the "
               "decode cache; the port's functional train step holds the "
               "old state and the new one together at its end, and the "
               "peak shows it")
ROOFLINE_NOTE = ("optrace of one rank's step under FakeTensorMode on the "
                 "plain route (no kernel), unsplit: the FLOPs and bytes "
                 "of one device; the worker-axis wire is the reducer's "
                 "payload of the rank's rows: collective_s at NVLink's "
                 "rate, collective_net_s at the node network's (DGX H100, "
                 "50 GB/s a GPU), which the worker axis crosses on both "
                 "production meshes; tp_bytes / collective_tp_s price the "
                 "step's tensor-parallel collectives over 'model' "
                 "(those the remat recompute issues again included) at "
                 "NVLink's rate")


def start_fake_world(world_size: int) -> None:
    """This process's default process group: the ``fake`` backend at
    ``world_size`` ranks (restarted when a run needs another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _replicated(tree):
    """Whole-leaf specs: a step's logits and metric scalars."""
    return shd.map_with_path(
        lambda p, x: tuple([None] * x.dim())
        if isinstance(x, torch.Tensor) else (), tree)


def debug_shape(mesh_kind: str):
    """(data, model) of a ``DxM`` debug mesh name, else None."""
    m = re.fullmatch(r"(\d+)x(\d+)", mesh_kind)
    return None if m is None else (int(m.group(1)), int(m.group(2)))


# the bucket count of a compressed (error-feedback) reducer's wire
COMPRESSED_BUCKETS = 4


def build_train(cfg, shape, mesh, dc_cfg, algo: str):
    """(step, inputs, their specs, the rank's inputs); ``step()`` runs
    the rank's traced step, on its shards, and returns (trace, outputs,
    their specs), one device's (replicated specs).  So do `build_prefill`
    and `build_decode`."""
    model = Model(cfg, remat=True, kernels=False,
                  seq_parallel=bool(os.environ.get("DRYRUN_SEQ_PARALLEL")))
    W = n_workers(mesh)
    reducer = registry.make_reducer(
        os.environ.get("DRYRUN_REDUCER", "mean_allreduce"), dc_cfg)
    # an error-feedback reducer compresses per bucket: the launcher's
    # documented --buckets 4
    buckets = {} if getattr(reducer, "stateless", True) \
        else {"buckets": COMPRESSED_BUCKETS}
    alg = registry.make(algo, dc_cfg, n_workers=W, reducer=reducer,
                        staleness=os.environ.get("DRYRUN_STALENESS",
                                                 "fixed"), **buckets)
    # the whole mesh's inputs and specs, then the engine bound to rank 0
    # (binding narrows the algorithm to the rank's rows)
    state = S.abstract_train_state(model, W, dc_cfg, alg)
    batch = S.train_batch_specs(cfg, shape, W)
    st_sp, b_sp = Engine(model, alg, mesh=mesh,
                         specs_only=True).train_shardings(state, batch)
    engine = Engine(model, alg, mesh=mesh)
    with S.fake_mode():
        run_state = engine.init_state(S.abstract_params(model))
        run_batch = engine.local_batch(batch)
    rows = W // engine.workers.size

    def step():
        tr, new_state, metrics = engine.trace_train_step(run_state,
                                                         run_batch)
        wire = tr.meta.get("wire")
        if wire:   # the payload of the traced rows
            wire["bytes"] *= rows
        tensors = {k: v for k, v in metrics.items()
                   if isinstance(v, torch.Tensor)}
        outs = (new_state, tensors)
        return tr, outs, (_replicated(new_state), _replicated(tensors))

    return step, (state, batch), (st_sp, b_sp), (run_state, run_batch)


def build_prefill(cfg, shape, mesh):
    model = Model(cfg, remat=True, kernels=False)
    engine = Engine(model, mesh=mesh)
    params = S.abstract_params(model)
    batch = S.prefill_batch_specs(cfg, shape)
    p_sp, b_sp, _ = engine.serve_shardings(params, batch=batch,
                                           global_batch=shape.global_batch)
    with S.fake_mode():
        run_params = engine.serve_params(params)
        run_batch = engine.serve_batch(batch)

    def step():
        with optrace.trace() as tr:
            logits, cache = engine.model.prefill(run_params, run_batch,
                                                 cache_len=shape.seq_len)
        return tr, (logits, cache), (_replicated(logits),
                                     _replicated(cache))

    return step, (params, batch), (p_sp, b_sp), (run_params, run_batch)


def build_decode(cfg, shape, mesh):
    model = Model(cfg, remat=False, kernels=False)
    engine = Engine(model, mesh=mesh)
    params = S.abstract_params(model)
    cache = S.abstract_cache(model, shape)
    batch = S.decode_batch_specs(cfg, shape)
    p_sp, b_sp, c_sp = engine.serve_shardings(
        params, batch=batch, cache=cache, global_batch=shape.global_batch)
    with S.fake_mode():
        run = (engine.serve_params(params), engine.shard(cache, c_sp),
               engine.serve_batch(batch))

    def step():
        with optrace.trace() as tr:
            logits, new_cache = engine.model.decode_step(*run)
        return tr, (logits, new_cache), (_replicated(logits),
                                         _replicated(new_cache))

    return step, (params, cache, batch), (p_sp, c_sp, b_sp), run


def traced_peak(step, inputs) -> tuple:
    """(``step()``'s result, the most its tensors hold at once): a
    ``MemTracker`` around the call, ``inputs`` (a tree) counted from the
    start.  The same on fake tensors as on real ones (the dry-run's
    ``peak_bytes``); the device whose peak is largest."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch import tree as T
    tracker = MemTracker()
    tracker.track_external(*[x for x in T.leaves(inputs)
                             if isinstance(x, torch.Tensor)])
    with tracker:
        out = step()
    peaks = tracker.get_tracker_snapshot("peak")
    return out, max((m["Total"] for m in peaks.values()), default=0)


def _record_path(out_dir: Path, arch, shape_name, mesh_kind, algo) -> Path:
    return out_dir / f"{arch}__{shape_name}__{mesh_kind}__{algo}.json"


def _write(out_dir, rec, algo) -> None:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        _record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                     algo).write_text(json.dumps(rec, indent=2,
                                                 default=float))


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            algo: str = "dc_s3gd", out_dir: Path | None = None,
            verbose: bool = True, cut: bool = False) -> dict:
    """One combo's record.  ``cut``: the arch's `reduced` smoke config
    (the tests' size) in place of its published one."""
    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch)
    if cut:
        cfg0 = reduced(cfg0)
    ok, why = S.supports_shape(cfg0, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": why}
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {why}")
        _write(out_dir, rec, algo)
        return rec

    debug = debug_shape(mesh_kind)
    cfg = S.variant_for_shape(S.dryrun_model_config(
        cfg0, **({"model_axis": debug[1]} if debug else {})), shape)
    if debug:
        start_fake_world(debug[0] * debug[1])
        mesh = make_debug_mesh(*debug, device_type="cpu")
    else:
        multi = mesh_kind == "multipod"
        start_fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    sizes = axis_sizes(mesh)
    n_chips = mesh.size()
    dc_cfg = DCS3GDConfig(total_steps=10_000, warmup_steps=1_500,
                          microbatches=int(
                              os.environ.get("DRYRUN_MICROBATCHES", "1")),
                          comm_dtype=os.environ.get("DRYRUN_COMM_DTYPE",
                                                    "float32"),
                          state_dtype=os.environ.get("DRYRUN_STATE_DTYPE",
                                                     "float32"))

    t0 = time.time()
    if shape.kind == "train":
        step, args, in_sp, local = build_train(cfg, shape, mesh, dc_cfg,
                                               algo)
    elif shape.kind == "prefill":
        step, args, in_sp, local = build_prefill(cfg, shape, mesh)
    else:
        step, args, in_sp, local = build_decode(cfg, shape, mesh)
    # the type check: every sharded dim divides by its axes
    arg_bytes = shd.shard_bytes(tuple(args), tuple(in_sp), sizes)
    t_lower = time.time() - t0
    with S.fake_mode():
        (tr, outs, out_sp), peak = traced_peak(step, local)
    out_bytes = shd.shard_bytes(tuple(outs), tuple(out_sp), sizes)
    t_compile = time.time() - t0 - t_lower
    roof = rl.analyze(tr, cfg, shape, n_chips)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "algo": algo,
        "status": "ok",
        "variant": cfg.name,
        "n_chips": n_chips,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak,
                   "note": MEMORY_NOTE},
        "roofline": {**roof.to_dict(), "note": ROOFLINE_NOTE},
    }
    if verbose:
        m = rec["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ({algo}) OK "
              f"trace={t_compile:.0f}s")
        print(f"  mem/device: args={_gb(m['argument_bytes'])} "
              f"out={_gb(m['output_bytes'])} temp={_gb(m['temp_bytes'])} "
              f"peak={_gb(m['peak_bytes'])}")
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms NVLink / "
              f"{roof.collective_net_s*1e3:.2f}ms network, "
              f"tp={roof.collective_tp_s*1e3:.2f}ms "
              f"-> {roof.bottleneck}-bound; useful-flops "
              f"{roof.useful_flops_ratio:.2f}")
        wire = tr.meta.get("wire")
        if wire:
            print(f"  wire: {wire['bytes']} B a step over "
                  f"{len(wire['sizes'])} buckets / leaves of "
                  f"{sum(wire['sizes'])} elements a worker; gathered "
                  f"over 'model' first: {tr.coll_bytes('whole_wire')} B")
    _write(out_dir, rec, algo)
    return rec


def _gb(x):
    return "n/a" if x is None else f"{x/2**30:.2f}GiB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", default="pod",
                    help="pod, multipod, or DxM: a ('data', 'model') debug "
                    "mesh (e.g. 1x2; a train step over 'model' > 1 is one "
                    "rank's tensor-parallel step)")
    ap.add_argument("--algo", choices=registry.names(), default="dc_s3gd")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) on the given mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's 2-layer smoke config")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.mesh not in ("pod", "multipod") and not debug_shape(args.mesh):
        ap.error(f"--mesh {args.mesh!r}: pod, multipod or DxM")

    if args.all:
        combos = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos = [(args.arch, args.shape)]

    failures = []
    for a, s in combos:
        try:
            run_one(a, s, args.mesh, algo=args.algo, out_dir=args.out,
                    cut=args.reduced)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures.append((a, s, repr(e)))
            print(f"[dryrun] FAIL {a} x {s} x {args.mesh}: {e}")
            traceback.print_exc()
            _write(args.out, {"arch": a, "shape": s, "mesh": args.mesh,
                              "algo": args.algo, "status": "fail",
                              "reason": repr(e)}, args.algo)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        sys.exit(1)
    print(f"[dryrun] all {len(combos)} combos OK on mesh={args.mesh}")


if __name__ == "__main__":
    main()

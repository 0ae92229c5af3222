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
* **memory**: ``argument_bytes`` / ``output_bytes`` are the per-device
  bytes of the local shards of the step's inputs / outputs (replicated
  leaves whole); ``temp_bytes`` / ``peak_bytes`` are null: eager PyTorch
  has no compiler memory analysis (the record's ``memory.note`` says so);
* **roofline**: `analysis.optrace` of the step run under the fake mode on
  the plain route (no kernel), split evenly over the mesh's devices;
  the collective term counts only the worker-axis wire (the reducer's
  payload of all W workers), at NVLink's and at the node network's rate
  (``roofline.note``).  ``lower_s`` is the seconds spent building the
  abstract inputs and their specs, ``compile_s`` the traced step's;
* **tensor parallelism**: on a small ('data', 'model') mesh named
  ``DxM`` (``--mesh 1x2``) with M > 1 a step is instead one rank's
  tensor-parallel step, run through a bound `Engine` on its local shards
  of fake tensors: a training step, or a serving one (the prefill or a
  decode step on the rank's serve params, batch rows and cache shard):
  the collectives it issues over 'model' (the ``tp`` scope: a serving
  step's row-parallel sums, vocabulary gather and gathered cache
  positions) are recorded, and the roofline prices their payload at
  NVLink's rate (``tp_bytes``, ``collective_tp_s``) beside the
  worker-axis wire; nothing is split, the trace is one device's.  A
  compressed wire or a quantized ``comm_dtype`` reduces the whole
  buckets there (`repro_torch.parallel.tensor.WholeWire`): the wire is
  the whole plan's, as in one process, and the gather of the rank's
  payload is one of the ``tp`` collectives, printed apart.  The
  production meshes keep the whole-mesh trace.

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
                                     make_production_mesh, model_size,
                                     n_workers)
from repro_torch.models.transformer import Model
from repro_torch.parallel import sharding as shd

DEFAULT_OUT = Path("experiments/dryrun_torch")

MEMORY_NOTE = ("argument_bytes / output_bytes: per-device bytes of the "
               "local shards under the Engine's specs (replicated leaves "
               "whole; the step counter as the int32 the reference "
               "carries); temp_bytes / peak_bytes: null, eager PyTorch has "
               "no compiler memory analysis")
ROOFLINE_NOTE = ("optrace of the step under FakeTensorMode on the plain "
                 "route (no kernel), FLOPs and bytes split evenly over "
                 "n_chips; among collectives only the worker-axis wire "
                 "(the reducer's payload of all W workers, per chip) is "
                 "counted: collective_s at NVLink's rate, collective_net_s "
                 "at the node network's (DGX H100, 50 GB/s a GPU), which "
                 "the worker axis crosses on both production meshes; on a "
                 "DxM debug mesh with M > 1 the train, prefill or decode "
                 "step is one rank's tensor-parallel step, unsplit, and "
                 "tp_bytes / collective_tp_s price its collectives over "
                 "'model' at NVLink's rate")


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


def build_train(cfg, shape, mesh, dc_cfg, algo: str, tp: bool = False):
    """(step, inputs, their specs); ``step()`` runs the traced step and
    returns (trace, outputs, their specs).  So do `build_prefill` and
    `build_decode`.  With ``tp`` (a debug mesh whose 'model' axis is above
    1) the traced step is this rank's tensor-parallel one, on its shards,
    and its outputs are one device's (their specs replicated)."""
    model = Model(cfg, kernels=False)
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
    engine = Engine(model, alg, mesh=mesh, specs_only=not tp)
    state = S.abstract_train_state(model, W, dc_cfg, alg)
    batch = S.train_batch_specs(cfg, shape, W)
    st_sp, b_sp = engine.train_shardings(state, batch)
    # the rank's rows and shards (a bound engine) or every row (the
    # whole mesh's step, split evenly afterwards)
    run_state, run_batch, rows = state, batch, W
    if tp:
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
        return tr, outs, (_replicated(new_state) if tp else st_sp,
                          _replicated(tensors))

    return step, (state, batch), (st_sp, b_sp)


def build_prefill(cfg, shape, mesh, tp: bool = False):
    model = Model(cfg, kernels=False)
    engine = Engine(model, mesh=mesh, specs_only=not tp)
    params = S.abstract_params(model)
    batch = S.prefill_batch_specs(cfg, shape)
    p_sp, b_sp, _ = engine.serve_shardings(params, batch=batch,
                                           global_batch=shape.global_batch)
    run_params, run_batch = params, batch
    if tp:
        with S.fake_mode():
            run_params = engine.serve_params(params)
            run_batch = engine.serve_batch(batch)

    def step():
        with optrace.trace() as tr:
            logits, cache = engine.model.prefill(run_params, run_batch,
                                                 cache_len=shape.seq_len)
        _, _, c_sp = engine.serve_shardings(
            params, cache=cache, global_batch=shape.global_batch)
        return tr, (logits, cache), (_replicated(logits),
                                     _replicated(cache) if tp else c_sp)

    return step, (params, batch), (p_sp, b_sp)


def build_decode(cfg, shape, mesh, tp: bool = False):
    model = Model(cfg, kernels=False)
    engine = Engine(model, mesh=mesh, specs_only=not tp)
    params = S.abstract_params(model)
    cache = S.abstract_cache(model, shape)
    batch = S.decode_batch_specs(cfg, shape)
    p_sp, b_sp, c_sp = engine.serve_shardings(
        params, batch=batch, cache=cache, global_batch=shape.global_batch)
    run = (params, cache, batch)
    if tp:
        with S.fake_mode():
            run = (engine.serve_params(params), engine.shard(cache, c_sp),
                   engine.serve_batch(batch))

    def step():
        with optrace.trace() as tr:
            logits, new_cache = engine.model.decode_step(*run)
        return tr, (logits, new_cache), (_replicated(logits),
                                         _replicated(new_cache) if tp
                                         else c_sp)

    return step, (params, cache, batch), (p_sp, c_sp, b_sp)


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
    # a tensor-parallel step is traced on one rank: nothing to split
    tp = bool(debug) and model_size(mesh) > 1
    split = 1 if tp else n_chips
    dc_cfg = DCS3GDConfig(total_steps=10_000, warmup_steps=1_500,
                          microbatches=int(
                              os.environ.get("DRYRUN_MICROBATCHES", "1")),
                          comm_dtype=os.environ.get("DRYRUN_COMM_DTYPE",
                                                    "float32"),
                          state_dtype=os.environ.get("DRYRUN_STATE_DTYPE",
                                                     "float32"))

    t0 = time.time()
    if shape.kind == "train":
        step, args, in_sp = build_train(cfg, shape, mesh, dc_cfg, algo, tp)
    elif shape.kind == "prefill":
        step, args, in_sp = build_prefill(cfg, shape, mesh, tp)
    else:
        step, args, in_sp = build_decode(cfg, shape, mesh, tp)
    # the type check: every sharded dim divides by its axes
    arg_bytes = shd.shard_bytes(tuple(args), tuple(in_sp), sizes)
    t_lower = time.time() - t0
    with S.fake_mode():
        tr, outs, out_sp = step()
    out_bytes = shd.shard_bytes(tuple(outs), tuple(out_sp), sizes)
    t_compile = time.time() - t0 - t_lower
    roof = rl.analyze(tr, cfg, shape, n_chips, split=split)

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "algo": algo,
        "status": "ok",
        "variant": cfg.name,
        "n_chips": n_chips,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": None, "peak_bytes": None,
                   "note": MEMORY_NOTE},
        "roofline": {**roof.to_dict(), "note": ROOFLINE_NOTE},
    }
    if verbose:
        m = rec["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} ({algo}) OK "
              f"trace={t_compile:.0f}s")
        print(f"  mem/device: args={_gb(m['argument_bytes'])} "
              f"out={_gb(m['output_bytes'])} (temp / peak: not available)")
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms NVLink / "
              f"{roof.collective_net_s*1e3:.2f}ms network, "
              f"tp={roof.collective_tp_s*1e3:.2f}ms "
              f"-> {roof.bottleneck}-bound; useful-flops "
              f"{roof.useful_flops_ratio:.2f}")
        wire = tr.meta.get("wire")
        if tp and wire:
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

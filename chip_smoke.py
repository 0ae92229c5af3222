#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (build seconds, ptxas register and
   shared-memory lines);
2. each kernel against its plain PyTorch version on the card, at the
   main path's bucket sizes and W = 2, f32 and bf16 w (norms rtol 1e-5,
   bitwise across two runs and on a misaligned copy; update atol 1e-5 f32 w / 2e-2 bf16 w),
   each timed with CUDA events (median per launch) beside its byte bound;
3. the main path: ``repro_torch.launch.train.run`` on qwen3-0.6b at its
   published widths, depth cut 28 -> 4, DC-S3GD, W = 2, 4 x 256 tokens
   per worker, 4 buckets, fused kernels, 6 steps — finite losses, λ and
   |D| > 0 once D can be non-zero, kernel launch counts as the path
   implies;
4. fused against unfused tail, 3 steps from the same weights;
5. step time, kernel times, peak memory — each beside the card's name
   and power limit;
6. two steady steps of the main path under torch.profiler: device time
   by kernel group and the device's idle share.

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports nothing
of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
W = 2
N_BUCKETS = 4
MAIN_ARGS = ["--arch", "qwen3-0.6b", "--layers", "4", "--algo", "dc_s3gd",
             "--workers", str(W), "--batch-per-worker", "4", "--seq", "256",
             "--buckets", str(N_BUCKETS), "--seed", "0", "--log-every", "1"]
EXPECTED_BUCKETS = (155_713_536, 62_947_328, 155_713_536, 32_768)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(smi: str) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    b = build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s: nvcc "
          f"{b.seconds:.2f} s -> {b.path.name} ({smi})")
    for line in b.ptxas:
        print(f"[build]   {line}")


def phase_kernels(sizes, smi: str) -> dict:
    """Kernels vs plain versions at the bucket sizes; returns the per-kernel
    sums over one step's launches."""
    from repro_torch.kernels import dc_update as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
           for k in ("dc_norms", "dc_fused_update")}
    args = dict(mu=0.9, eta=0.05, wd=2.3e-4)
    for n in sizes:
        g, d, m, w = (torch.randn((W, n), generator=gen, device=dev)
                      for _ in range(4))
        lam = torch.tensor([0.3, 0.7], device=dev)
        # norms: bitwise run to run, rtol 1e-5 against the plain version
        a, b = K.dc_norms(g, d), K.dc_norms(g, d)
        ref = K.dc_norms_plain(g, d)
        torch.cuda.synchronize()
        rel = 0.0
        # the same values at a 4-byte (not 16-byte) aligned address
        buf = torch.empty(2 * W * n + 1, device=dev)
        gm = buf[1:W * n + 1].view(W, n)
        dm = buf[W * n + 1:].view(W, n)
        gm.copy_(g)
        dm.copy_(d)
        c = K.dc_norms(gm, dm)
        del buf, gm, dm
        for x, y, z, r in zip(a, b, c, (ref[:, 0], ref[:, 1])):
            check(torch.equal(x, y), f"dc_norms not bitwise run to run, n={n}")
            check(torch.equal(x, z),
                  f"dc_norms not bitwise on a misaligned view, n={n}")
            check(bool(((x - r).abs() <= 1e-5 * r.abs()).all()),
                  f"dc_norms vs plain beyond rtol 1e-5, n={n}: {x} {r}")
            acc["dc_norms"]["err"] = max(acc["dc_norms"]["err"],
                                         float((x - r).abs().max()))
            rel = max(rel, float(((x - r).abs() / r.abs()).max()))
        k_ms = median_ms(lambda: K.dc_norms(g, d))
        p_ms = median_ms(lambda: K.dc_norms_plain(g, d))
        bound = 8 * W * n / HBM_BYTES_PER_S * 1e3
        acc["dc_norms"]["ms"] += k_ms
        acc["dc_norms"]["plain_ms"] += p_ms
        acc["dc_norms"]["bound_ms"] += bound
        print(f"[kernels] dc_norms n={n} W={W}: {k_ms:.4f} ms/launch "
              f"(plain {p_ms:.4f} ms, byte bound {bound:.4f} ms, max rel "
              f"err {rel:.3g}) [{smi}]")
        for wt, atol, bpe in ((torch.float32, 1e-5, 28),
                              (torch.bfloat16, 2e-2, 24)):
            ww = w.to(wt)
            out = K.dc_fused_update(g, d, m, ww, lam=lam, **args)
            ref = K.dc_fused_update_plain(g, d, m, ww, lam=lam, **args)
            torch.cuda.synchronize()
            check(out[0].dtype == wt and out[1].dtype == torch.float32,
                  "dc_fused_update output dtypes")
            err = max(float((x.float() - r.float()).abs().max())
                      for x, r in zip(out, ref))
            check(err <= atol, f"dc_fused_update {wt} n={n}: max abs err "
                  f"{err} > {atol}")
            del out, ref
            k_ms = median_ms(lambda: K.dc_fused_update(g, d, m, ww, lam=lam,
                                                       **args))
            p_ms = median_ms(lambda: K.dc_fused_update_plain(
                g, d, m, ww, lam=lam, **args))
            bound = bpe * W * n / HBM_BYTES_PER_S * 1e3
            print(f"[kernels] dc_fused_update n={n} W={W} w={wt}: "
                  f"{k_ms:.4f} ms/launch (plain {p_ms:.4f} ms, byte bound "
                  f"{bound:.4f} ms, max abs err {err:.3g}) [{smi}]")
            if wt == torch.float32:   # the main path's w dtype
                u = acc["dc_fused_update"]
                u["ms"] += k_ms
                u["plain_ms"] += p_ms
                u["bound_ms"] += bound
                u["err"] = max(u["err"], err)
        del g, d, m, w
        torch.cuda.empty_cache()
    return acc


def phase_main(smi: str):
    from repro_torch.kernels import dc_update as K
    from repro_torch.launch import train
    args = train.build_argparser().parse_args(MAIN_ARGS + [
        "--steps", "6", "--use-kernels"])
    torch.cuda.reset_peak_memory_stats()
    K.dc_norms.launches = 0
    K.dc_fused_update.launches = 0
    result = train.run(args)
    torch.cuda.synchronize()
    launches = {"dc_norms": K.dc_norms.launches,
                "dc_fused_update": K.dc_fused_update.launches}
    peak = torch.cuda.max_memory_allocated()
    hist = result["history"]
    check([h["step"] for h in hist] == list(range(6)), "history steps")
    for h in hist:
        check(math.isfinite(h["loss"]), f"loss not finite: {h}")
    # the warm-up step 0 runs at lr 0, so Δw⁰ = 0 and D¹ = 0: λ and |D|
    # are exactly 0 on steps 0-1 (Algorithm 1's prologue) and > 0 after
    for h in hist[:2]:
        check(h["lambda"] == 0.0 and h["distance_norm"] == 0.0,
              f"prologue step with D != 0: {h}")
    for h in hist[2:]:
        for k in ("lambda", "distance_norm", "delta_norm"):
            check(math.isfinite(h[k]) and h[k] > 0, f"{k} at {h}")
    for name, n in launches.items():
        check(n == 6 * N_BUCKETS, f"{name} launched {n} times, expected "
              f"{6 * N_BUCKETS} (6 steps x {N_BUCKETS} buckets)")
    for h in hist:
        print(f"[main] step {h['step']} loss={h['loss']:.6f} "
              f"lambda={h['lambda']:.6g} |D|={h['distance_norm']:.6g} "
              f"|dw|={h['delta_norm']:.6g} lr={h['lr']:.6g}")
    walls = [h["wall_s"] for h in hist]
    step_s = statistics.median(b - a for a, b in zip(walls[1:], walls[2:]))
    print(f"[main] launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB [{smi}]")
    return launches, step_s, peak


def phase_fused_vs_unfused(smi: str) -> float:
    """3 steps from the same weights, fused kernels vs the unfused torch
    tail; each leaf of the final weights within 1e-4 of the largest
    update that leaf took (the CPU parity tests' criterion)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    finals = {}
    for fused in (True, False):
        args = train.build_argparser().parse_args(
            MAIN_ARGS + ["--steps", "3"] + (["--use-kernels"] if fused
                                            else []))
        state = train.run(args)["state"]
        finals[fused] = T.leaves(state.params)
        del state
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    w0 = T.leaves(Model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0)))
    worst = 0.0
    for a, b, z in zip(finals[True], finals[False], w0):
        upd = (b - z).abs().max()
        diff = (a - b).abs().max()
        worst = max(worst, float(diff / upd) if upd > 0 else float(diff))
        check(bool(diff <= 1e-4 * upd), f"fused vs unfused: {diff} > "
              f"1e-4 x {upd}")
    print(f"[fused] 3 steps, fused vs unfused tail: worst leaf max|diff| "
          f"= {worst:.3g} x that leaf's largest update [{smi}]")
    return worst


def phase_profile(smi: str) -> dict:
    """Two steady steps of the main path (steps 2-3, after the lr-0 warm-up
    step and the first real one) under torch.profiler: device time by
    kernel, grouped, and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    args = train.build_argparser().parse_args(MAIN_ARGS + [
        "--steps", "6", "--use-kernels"])
    model, alg, state, batch_fn = train.build(args)
    for it in range(2):
        state, _ = alg.step(state, batch_fn(it), loss_fn=model.loss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(2, 4):
            state, _ = alg.step(state, batch_fn(it), loss_fn=model.loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    groups = {"dc_update kernels": ("norms_", "fused_update"),
              "matmul (cuBLAS)": ("gemm", "xmma", "cutlass", "Kernel2"),
              # torch.cat's kernel is CatArrayBatchedCopy
              "copies/cat": ("Memcpy", "copy", "Copy")}
    by_group = {g: 0.0 for g in groups}
    by_group["other"] = 0.0
    for e in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), "other")
        by_group[g] += dev_us(e) / 1e3
    if busy_ms == 0:
        print(f"[profile] no device time in the trace: not measured [{smi}]")
        return {}
    print(f"[profile] 2 steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% [{smi}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {g}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of "
              f"device time)")
    for e in kernels[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": by_group}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.buckets import plan_buckets

    # f32 products stay f32, as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}"
          f"; tf32 off")

    phase_build(smi)

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    plan = plan_buckets(params, N_BUCKETS)
    n_params = sum(x.numel() for x in T.leaves(params))
    del params
    check(plan.bucket_sizes == EXPECTED_BUCKETS,
          f"bucket sizes {plan.bucket_sizes}")
    check(plan.bucket_decay == (True, True, True, False), "bucket decay")
    check(n_params == 374_351_872, f"{n_params} params")
    print(f"[plan] {n_params} params, buckets {plan.bucket_sizes} "
          f"decay {plan.bucket_decay}")

    kern = phase_kernels(plan.bucket_sizes, smi)
    launches, step_s, peak = phase_main(smi)
    worst = phase_fused_vs_unfused(smi)
    torch.cuda.empty_cache()
    prof = phase_profile(smi)

    tokens = W * 4 * 256
    print(f"[times] step {step_s * 1e3:.3f} ms median of steps 2-5 "
          f"({tokens / step_s:.1f} tokens/s, W={W}, 4x256 tokens/worker, 4 "
          f"layers, metrics fetched every step) [{smi}]")
    for name, k in kern.items():
        print(f"[times] {name}: {k['ms']:.4f} ms per step ({N_BUCKETS} "
              f"launches), plain {k['plain_ms']:.4f} ms, byte bound "
              f"{k['bound_ms']:.4f} ms [{smi}]")
    print(f"[times] peak memory {peak / 2**30:.3f} GiB "
          f"({peak} B) [{smi}]")

    replaces = {"dc_norms": "src/repro/kernels/dc_update.py:58",
                "dc_fused_update": "src/repro/kernels/dc_update.py:126"}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dc_update.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, k in kern.items()]
    record = {"card": smi, "step_ms": step_s * 1e3, "peak_bytes": peak,
              "fused_vs_unfused_worst": worst, "profile": prof,
              "kernels": kernels}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=2))

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` per source, all started
   together (each build's seconds, ptxas register and shared-memory
   lines);
2. each kernel against its plain PyTorch version on the card, at the
   main path's bucket sizes and W = 2: the norms (rtol 1e-5, bitwise
   across two runs and on a misaligned copy), the update (atol 1e-5 f32
   w / 2e-2 bf16 w) and select_ef_mean (bitwise, f32 and bf16 wire,
   union off and on, and on a misaligned copy), each timed with CUDA
   events (median per launch of 10 samples, each a pass over enough
   copies of its operands that no launch finds them in the 50 MB L2, at
   least two launches, queued behind a device-side sleep) beside its byte
   bound; the torch threshold search (magnitude_threshold) timed at the
   same sizes;
3. the main path: ``repro_torch.launch.train.run`` on qwen3-0.6b at its
   published widths, depth cut 28 -> 4, DC-S3GD, W = 2, 4 x 256 tokens
   per worker, 4 buckets, fused kernels, 6 steps — finite losses, λ and
   |D| > 0 once D can be non-zero, kernel launch counts as the path
   implies; then the compressed main path, the same run with
   ``--reducer topk --compress-density 0.01`` (select_ef_mean once per
   bucket and step, a non-zero residual); then two steps each of the
   other reducers and wires (topk_exact, randk, powersgd, the int8 and
   fp8 mean, ssgd over topk) with finite losses;
4. fused against unfused tail, 3 steps from the same weights;
5. step times, kernel times, peak memory — each beside the card's name
   and power limit;
6. two steady steps of each main path under torch.profiler (device time
   by kernel group, the device's idle share), then one more step under
   PyTorch's sync debug mode (host synchronisations counted);
7. the paper's CNN main path: ResNet-18's stage layout and widths
   (stages (2, 2, 2, 2), width 64, 10 classes; 11,164,360 parameters in
   29 leaves, 6 buckets at --buckets 4, the last holding the eight SkipInit
   scalars) on 32 x 32 synthetic prototype images, f32, seed 0, through
   the example twin (``repro_torch.examples.cnn_paper_repro.train``, the
   §IV-A recipe), W = 8, 64 images per worker, fused tail, TF32 off for
   cuBLAS and cuDNN: A1 and A2 against their plain versions at the CNN's
   bucket sizes and W = 8; 6 steps each of dc_s3gd, stale and ssgd (finite
   losses, λ and |D| 0 on steps 0-1, λ > 0 after for dc_s3gd only, A1 and
   A2 once per bucket and step, B3-B6 never; step time, images/s, peak
   memory; the host time of one step's batch); fused against unfused tail
   over 3 steps under cudnn.deterministic; two steady steps profiled and
   one under sync debug mode (0 host syncs); two untimed steps each of
   nesterov, lars, adam, per-tensor λ, dc_asgd, dynamic_ssp under measured
   skew, gossip and hierarchical;
8. serving.  paged_attention against its plain version at the serving
   shape (16 rows, 8 kv heads, G 2, hd 128, pages of 16, ragged lengths
   1..577) for bf16, f32, int8 and fp8 pools (atol 1e-6 float, 2e-5
   quantized), timed over one launch on each of 28 per-layer pools (as
   the serve step reads them: no launch finds its pages in L2; device
   time, the launches queued before the first starts) beside its
   byte bound, the plain version and gather + SDPA, through a 640-wide and
   a live-width block table (bitwise equal and within 10 %: the split-K
   ranges follow each row's length, never the table's width), bitwise
   run to run, with its split count and CTAs per launch; then ``repro_torch.launch.serve`` serves 48 requests
   (prompts 128..512, gen 32..64 from seed 0) with qwen3-0.6b at its
   published widths and full depth (28 layers, f32 params, bf16 compute
   and KV) over 16 slots and 641 pages of 16 with --paged-kernel and
   decode bursts of 4: every request completes at its length,
   paged_attention launches 28 times per decode step, the pool drains;
   the first 16 requests again with int8 KV and without --paged-kernel
   (on the card the kernel is the default route: it launches 28 times
   per decode step there too); kernel path against gather path
   teacher-forced over one group of 16 (bound stated in
   phase_kernel_vs_gather); host synchronisations
   inside one steady decode burst (must be 0) and two bursts profiled;
9. prefill kernels.  flash_attention's SASS (every instantiation holds
   tensor-core HMMA / HGMMA instructions, counted with cuobjdump), then
   the kernel against its plain version at the qwen3-0.6b prefill's
   shapes (B 1, 8 kv heads, G 2, hd 128, causal, S 128/256/384/512, f32
   (atol 2e-5) and bf16 (3e-2)), a windowed and a ragged Sq != Sk case,
   bitwise run to run, each timed (CUDA events, median of 10 after 2
   warm-ups, 28 launches queued behind a device-side sleep per sample)
   beside its bound (f32 at the 3xTF32 ceiling, its CUDA-core bound
   printed too), the plain version and scaled_dot_product_attention in
   the same dtype;
   the qwen3 serve run of phase 8 launches it 28 times per prefill; the
   qwen3 prefill's logits, kernel route against plain route
   (bound stated in phase_prefill_routes).  ssm_scan against its plain
   version at falcon-mamba-7b's prefill shapes (B 1, E 8,192, N 16, S
   128/256/384/512, f32; atol 1e-4 on y and h_last, h_last bitwise where
   one chunk holds S, else its max |dh_last| printed) and a ragged S, E
   case, bitwise run to run, with its chunk length, chunk count and CTAs
   per launch, timed the same way (8 launches per sample) beside its byte
   bound and the plain version;
10. serving falcon-mamba-7b at its published widths and full depth (64
   layers, f32 params, bf16 compute, random weights from seed 0) through
   ``repro_torch.launch.serve`` over the same 48 requests (token ids under
   its 65,024 vocab), ``--slots 16 --decode-burst 4``, greedy: every
   request completes at its length, the page pool is never touched,
   ssm_scan launches 64 times per prefill, no host synchronisation inside
   a steady decode burst; then its prefill logits, scan kernel route
   against plain route, on 2 prompts (bound stated in
   phase_prefill_routes).  qwen3's weights are freed before it;
11. state across steps.  On ResNet-18's layout (W = 8, dc_s3gd, 4
   buckets, fused tail, TF32 off, cudnn.deterministic): 6 steps with
   --overlap against 6 inline, in turns, bitwise in params, m, delta_prev
   and losses (A1/A2 once per bucket and step; step times, peak memory
   and the bytes held in comm["pipeline"]); a checkpoint at step 3
   restored into a fresh state, steps 3-5 bitwise the uninterrupted run
   (file bytes, save and restore seconds); the elastic resume 8 -> 6 from
   it (eval_params bitwise, 2 finite steps); a live elastic run over topk
   1 % with a one-step dense window after the join, W 8 -> 6 -> 4 -> 5
   over 8 steps (eval_params bitwise across each transition, residual
   mass conserved within W·2^-24·Σ|r|, residual 0 after the dense step,
   A1/A2 once per bucket and step at each W, B3 once per bucket outside
   the window, the transition log equal to the CPU's for the same
   schedule).  On qwen3-0.6b (depth 4, W = 2): 3 steps over topk 1 %
   with --overlap against inline under deterministic algorithms,
   bitwise; the main path with --ckpt (bytes, save seconds; the file
   under a temporary directory, deleted after), served through
   ``repro_torch.launch.serve --layers 4 --train-ckpt ... --paged-kernel``
   for 4 of phase 8's requests: greedy tokens equal to serving
   eval_params of the in-memory state.  The phase's seconds are printed.

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports nothing
of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
L2_BYTES = 50 * 2**20         # H100 SXM L2
W = 2
N_BUCKETS = 4
MAIN_ARGS = ["--arch", "qwen3-0.6b", "--layers", "4", "--algo", "dc_s3gd",
             "--workers", str(W), "--batch-per-worker", "4", "--seq", "256",
             "--buckets", str(N_BUCKETS), "--seed", "0", "--log-every", "1"]
EXPECTED_BUCKETS = (155_713_536, 62_947_328, 155_713_536, 32_768)
COMPRESSED = ["--reducer", "topk", "--compress-density", "0.01"]
# the other reducers and wires, two steps each
OTHERS = {"topk_exact": ["--reducer", "topk_exact"],
          "randk": ["--reducer", "randk"],
          "powersgd": ["--reducer", "powersgd"],
          "int8 mean": ["--comm-dtype", "int8"],
          "fp8 mean": ["--comm-dtype", "fp8"],
          "ssgd topk": ["--algo", "ssgd", "--reducer", "topk"]}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median over ``reps`` of one call's device time (CUDA events around
    ``batch`` back-to-back calls, divided by ``batch``).  A batch is queued
    behind a device-side sleep of ~25 ms, so the events time the device
    work alone: a kernel of tens of µs is otherwise timed with the host's
    time to launch it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if batch > 1:
            torch.cuda._sleep(50_000_000)     # clock cycles
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _rotation(tensors, nbytes: int):
    """Copies of ``tensors`` to cycle over, enough that one pass moves three
    times the 50 MB L2: no launch then finds its operands there (a single
    copy where one launch alone moves more)."""
    k = max(1, -(-3 * L2_BYTES // nbytes))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(k - 1)]


def cold_ms(fn, copies) -> float:
    """``median_ms`` of ``fn(*operands)`` cycling over ``copies`` (from
    `_rotation`), one pass of at least two launches queued behind the
    device-side sleep per sample: the events time device work from HBM,
    as the step's own launches find it."""
    cyc = itertools.cycle(copies)
    return median_ms(lambda: fn(*next(cyc)), batch=max(2, len(copies)))


def phase_build(smi: str) -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.load_all()
    print(f"[build] {len(built)} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s ({smi})")
    for name, b in built.items():
        print(f"[build] {name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.ptxas:
            print(f"[build]   {line}")


def phase_kernels(sizes, smi: str, W: int = W, select: bool = True,
                  tag: str = "kernels") -> dict:
    """Kernels vs plain versions at the bucket sizes and W workers; returns
    the per-kernel sums over one step's launches (select_ef_mean's only
    with ``select``)."""
    from repro_torch.kernels import dc_update as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
           for k in ("dc_norms", "dc_fused_update")}
    args = dict(mu=0.9, eta=0.05, wd=2.3e-4)
    for n in sizes:
        g, d, m, w = (torch.randn((W, n), generator=gen, device=dev)
                      for _ in range(4))
        lam = torch.linspace(0.3, 0.7, W, device=dev)
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
        ops = _rotation((g, d), 8 * W * n)
        k_ms = cold_ms(K.dc_norms, ops)
        p_ms = cold_ms(K.dc_norms_plain, ops)
        del ops
        bound = 8 * W * n / HBM_BYTES_PER_S * 1e3
        acc["dc_norms"]["ms"] += k_ms
        acc["dc_norms"]["plain_ms"] += p_ms
        acc["dc_norms"]["bound_ms"] += bound
        acc["dc_norms"].setdefault("per_launch", []).append(
            {"n": n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound})
        print(f"[{tag}] dc_norms n={n} W={W}: {k_ms:.4f} ms/launch "
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
            ops = _rotation((g, d, m, ww), bpe * W * n)
            k_ms = cold_ms(lambda *o: K.dc_fused_update(*o, lam=lam, **args),
                           ops)
            p_ms = cold_ms(lambda *o: K.dc_fused_update_plain(
                *o, lam=lam, **args), ops)
            del ops
            bound = bpe * W * n / HBM_BYTES_PER_S * 1e3
            print(f"[{tag}] dc_fused_update n={n} W={W} w={wt}: "
                  f"{k_ms:.4f} ms/launch (plain {p_ms:.4f} ms, byte bound "
                  f"{bound:.4f} ms, max abs err {err:.3g}) [{smi}]")
            if wt == torch.float32:   # the main path's w dtype
                u = acc["dc_fused_update"]
                u["ms"] += k_ms
                u["plain_ms"] += p_ms
                u["bound_ms"] += bound
                u["err"] = max(u["err"], err)
                u.setdefault("per_launch", []).append(
                    {"n": n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound})
        del g, d, m, w
        torch.cuda.empty_cache()
    if select:
        acc["select_ef_mean"] = phase_select(sizes, gen, smi)
    return acc


def phase_select(sizes, gen, smi: str) -> dict:
    """select_ef_mean against its plain version, bitwise, for both wires
    and union settings (and a misaligned copy); the torch threshold search
    timed beside it.  Returns the sums over one step's launches of the
    main path's form (f32 wire, own supports)."""
    from repro_torch.core.compress import _k_of, magnitude_threshold
    from repro_torch.kernels import compress as KC
    dev = torch.device("cuda")
    acc = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    thresh_ms = 0.0
    for n in sizes:
        a = torch.randn((W, n), generator=gen, device=dev) \
            * torch.rand((W, n), generator=gen, device=dev) ** 4
        k = _k_of(n, 0.01)
        t = magnitude_threshold(a.abs(), k)
        t_ms = median_ms(lambda: magnitude_threshold(a.abs(), k))
        thresh_ms += t_ms
        print(f"[threshold] magnitude_threshold n={n} W={W} k={k}: "
              f"{t_ms:.4f} ms (torch; not a TPU kernel) [{smi}]")
        bound = (8 * W + 4) * n / HBM_BYTES_PER_S * 1e3
        ops = _rotation((a, t), (8 * W + 4) * n)
        for dt in (torch.float32, torch.bfloat16):
            for union in (False, True):
                got = KC.select_ef_mean(a, t, comm_dtype=dt, union=union)
                want = KC.select_ef_mean_plain(a, t, comm_dtype=dt,
                                               union=union)
                torch.cuda.synchronize()
                err = max(float((x - y).abs().max())
                          for x, y in zip(got, want))
                for x, y in zip(got, want):
                    check(torch.equal(x, y), f"select_ef_mean not bitwise "
                          f"the plain version: n={n} {dt} union={union}")
                del got, want
                k_ms = cold_ms(lambda x, th: KC.select_ef_mean(
                    x, th, comm_dtype=dt, union=union), ops)
                p_ms = cold_ms(lambda x, th: KC.select_ef_mean_plain(
                    x, th, comm_dtype=dt, union=union), ops)
                print(f"[kernels] select_ef_mean n={n} W={W} wire={dt} "
                      f"union={union}: {k_ms:.4f} ms/launch (plain "
                      f"{p_ms:.4f} ms, byte bound {bound:.4f} ms, max abs "
                      f"err {err:.3g}) [{smi}]")
                if dt == torch.float32 and not union:   # the main path's
                    acc["ms"] += k_ms
                    acc["plain_ms"] += p_ms
                    acc["bound_ms"] += bound
                    acc["err"] = max(acc["err"], err)
        # the same values at a 4-byte (not 16-byte) aligned address
        buf = torch.empty(W * n + 1, device=dev)
        am = buf[1:].view(W, n)
        am.copy_(a)
        for x, y in zip(KC.select_ef_mean(am, t, comm_dtype=torch.float32,
                                          union=False),
                        KC.select_ef_mean(a, t, comm_dtype=torch.float32,
                                          union=False)):
            check(torch.equal(x, y),
                  f"select_ef_mean not bitwise on a misaligned view, n={n}")
        del a, t, buf, am, ops
        torch.cuda.empty_cache()
    print(f"[threshold] magnitude_threshold per step ({len(sizes)} buckets): "
          f"{thresh_ms:.4f} ms [{smi}]")
    acc["threshold_ms"] = thresh_ms
    return acc


def _counters():
    from repro_torch.kernels import compress as KC
    from repro_torch.kernels import dc_update as K
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"dc_norms": K.dc_norms, "dc_fused_update": K.dc_fused_update,
            "select_ef_mean": KC.select_ef_mean,
            "paged_attention": paged_attention,
            "flash_attention": flash_attention, "ssm_scan": ssm_scan}


def phase_main(smi: str, extra=(), tag: str = "main"):
    """Six steps of a main path: ``MAIN_ARGS`` + ``extra``.  Every kernel
    count is set to 0 just before the run and read just after."""
    from repro_torch.launch import train
    args = train.build_argparser().parse_args(MAIN_ARGS + [
        "--steps", "6", "--use-kernels", *extra])
    # what earlier phases still hold counts in the peak: show it
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in _counters().values():
        fn.launches = 0
    result = train.run(args)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _counters().items()}
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
    compressed = "--reducer" in extra
    on_path = {"dc_norms", "dc_fused_update"} \
        | ({"select_ef_mean"} if compressed else set())
    for name, n in launches.items():
        want = 6 * N_BUCKETS if name in on_path else 0
        check(n == want, f"[{tag}] {name} launched {n} times, expected "
              f"{want} (6 steps x {N_BUCKETS} buckets on its path)")
    if compressed:
        # what topk dropped rides the error-feedback residual
        res = result["state"].comm["reducer"]["residual"]
        check(all(bool(r.any()) for r in res[:3]),
              f"[{tag}] error-feedback residual is zero after 6 steps")
    for h in hist:
        print(f"[{tag}] step {h['step']} loss={h['loss']:.6f} "
              f"lambda={h['lambda']:.6g} |D|={h['distance_norm']:.6g} "
              f"|dw|={h['delta_norm']:.6g} lr={h['lr']:.6g}")
    walls = [h["wall_s"] for h in hist]
    step_s = statistics.median(b - a for a, b in zip(walls[1:], walls[2:]))
    print(f"[{tag}] launches {launches}; step {step_s * 1e3:.3f} ms "
          f"(median of steps 2-5); peak memory {peak / 2**30:.3f} GiB, of "
          f"which {before / 2**20:.1f} MiB were allocated before the run "
          f"[{smi}]")
    del result
    torch.cuda.empty_cache()
    return launches, step_s, peak


def phase_others(smi: str) -> dict:
    """Two steps of each other ported reducer and wire at the main path's
    widths, with finite losses; returns the seconds each run took."""
    from repro_torch.launch import train
    secs = {}
    for name, extra in OTHERS.items():
        args = train.build_argparser().parse_args(MAIN_ARGS + [
            "--steps", "2", "--use-kernels", *extra])
        t0 = time.perf_counter()
        result = train.run(args)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        losses = [h["loss"] for h in result["history"]]
        check(len(losses) == 2 and all(map(math.isfinite, losses)),
              f"[others] {name}: losses {losses}")
        print(f"[others] {name}: losses {losses} in {secs[name]:.2f} s "
              f"[{smi}]")
        del result
        torch.cuda.empty_cache()
    return secs


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


def _device_groups(prof, groups: dict, other: str):
    """(kernels by device time, busy ms, ms by group) of a profile: each
    kernel goes to the first group one of whose keys its name holds."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    by_group = {g: 0.0 for g in groups}
    by_group[other] = 0.0
    for e in kernels:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), other)
        by_group[g] += dev_us(e) / 1e3
    return kernels, sum(dev_us(e) for e in kernels) / 1e3, by_group, dev_us


def phase_profile(smi: str, extra=(), tag: str = "profile") -> dict:
    """Two steady steps of a main path (steps 2-3, after the lr-0 warm-up
    step and the first real one) under torch.profiler: device time by
    kernel, grouped, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    args = train.build_argparser().parse_args(MAIN_ARGS + [
        "--steps", "6", "--use-kernels", *extra])
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
    # one more steady step with PyTorch's sync debug mode on: every host
    # synchronisation inside the step raises a warning, which is counted
    # (the batch's host-to-device copy is made before it)
    batch = batch_fn(4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = alg.step(state, batch, loss_fn=model.loss)
    torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[{tag}] host synchronisations inside step 4: {syncs}")
    del state
    groups = {"dc_update kernels": ("norms_", "fused_update"),
              "select_ef_mean kernel": ("select_ef_mean",),
              # the threshold search's torch.topk (multi/single-block)
              "threshold topk": ("mbtopk", "sbtopk"),
              "matmul (cuBLAS)": ("gemm", "xmma", "cutlass", "Kernel2"),
              # torch.cat's kernel is CatArrayBatchedCopy
              "copies/cat": ("Memcpy", "copy", "Copy")}
    kernels, busy_ms, by_group, dev_us = _device_groups(prof, groups,
                                                        "other")
    if busy_ms == 0:
        print(f"[{tag}] no device time in the trace: not measured [{smi}]")
        return {}
    print(f"[{tag}] 2 steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% [{smi}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {g}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% of "
              f"device time)")
    for e in kernels[:12]:
        print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": by_group,
            "host_syncs_per_step": syncs}


# ---------------------------------------------------------------------------
# the paper's CNN: ResNet-18's layout through the example twin (A1, A2)
# ---------------------------------------------------------------------------

RESNET18 = {"stages": (2, 2, 2, 2), "width": 64, "n_classes": 10}
CNN_W, CNN_PER_WORKER, CNN_IMAGE = 8, 64, 32
CNN_PARAMS = 11_164_360
CNN_BUCKETS = (2_785_280, 1_179_648, 2_490_368, 2_359_296, 2_392_064,
               32_768)
CNN_STEPS = 6
# two untimed steps each of the rest of training on the CNN
CNN_VARIANTS = {
    "nesterov": {"local_optimizer": "nesterov", "buckets": N_BUCKETS},
    "lars": {"local_optimizer": "lars", "buckets": N_BUCKETS},
    "adam": {"local_optimizer": "adam", "buckets": N_BUCKETS},
    "per_tensor": {"per_tensor": True, "buckets": N_BUCKETS},
    "dc_asgd": {"algo": "dc_asgd"},
    "dynamic_ssp": {"staleness": "dynamic_ssp", "measure_skew": True,
                    "use_kernels": True, "buckets": N_BUCKETS},
    "gossip": {"reducer": "gossip", "use_kernels": True,
               "buckets": N_BUCKETS},
    "hierarchical": {"reducer": "hierarchical", "use_kernels": True,
                     "buckets": N_BUCKETS},
}


def _cnn(algo: str, steps: int, **kw) -> dict:
    """``steps`` steps of ``algo`` on ResNet-18's layout through the
    example twin's entry point (§IV-A recipe, W = 8, 64 images of 32 x 32
    per worker, seed 0), every step's metrics fetched."""
    from repro_torch.examples import cnn_paper_repro as twin
    if kw.pop("per_tensor", False):
        from repro_torch.core.compensate import DelayCompensation
        kw["compensator"] = DelayCompensation(lambda0=0.2, mode="per_tensor")
    return twin.train(algo, CNN_W, steps, device="cuda", net=RESNET18,
                      image_size=CNN_IMAGE, per_worker=CNN_PER_WORKER,
                      log_every=1, **kw)


def phase_cnn_main(smi: str) -> dict:
    """Six steps each of dc_s3gd, stale and ssgd (fused tail, 4 buckets)
    on ResNet-18's layout.  Every kernel count is set to 0 just before a
    run and read just after it."""
    from repro_torch.data.pipeline import SyntheticImageDataset, \
        worker_batches
    ds = SyntheticImageDataset(RESNET18["n_classes"], image_size=CNN_IMAGE,
                               seed=0, noise=0.4)
    host = []
    for t in range(3):
        t0 = time.perf_counter()
        b = worker_batches(ds, t, CNN_W, CNN_PER_WORKER, device="cpu")
        host.append(time.perf_counter() - t0)
    batch_ms = statistics.median(host) * 1e3
    print(f"[cnn] one step's batch on the host ({CNN_W} x {CNN_PER_WORKER} "
          f"images {tuple(b['images'].shape[2:])}, numpy, median of 3): "
          f"{batch_ms:.3f} ms; drawn on the prefetch thread while the "
          f"previous step runs")
    print(f"[cnn] cudnn.deterministic={torch.backends.cudnn.deterministic} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    out = {"batch_ms": batch_ms}
    for algo in ("dc_s3gd", "stale", "ssgd"):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for fn in _counters().values():
            fn.launches = 0
        result = _cnn(algo, CNN_STEPS, use_kernels=True, buckets=N_BUCKETS)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in _counters().items()}
        peak = torch.cuda.max_memory_allocated()
        check(not torch.backends.cudnn.allow_tf32
              and not torch.backends.cuda.matmul.allow_tf32,
              "[cnn] the entry point left TF32 on")
        hist = result["history"]
        check([h["step"] for h in hist] == list(range(CNN_STEPS)),
              f"[cnn] {algo} history steps")
        for h in hist:
            check(math.isfinite(h["loss"]), f"[cnn] {algo} loss: {h}")
        fused = algo != "ssgd"
        if fused:
            # the warm-up step 0 runs at lr 0: D = 0 on steps 0-1
            for h in hist[:2]:
                check(h["lambda"] == 0.0 and h["distance_norm"] == 0.0,
                      f"[cnn] {algo} prologue step with D != 0: {h}")
            for h in hist[2:]:
                check(h["distance_norm"] > 0 and math.isfinite(h["lambda"]),
                      f"[cnn] {algo}: {h}")
                check((h["lambda"] > 0) == (algo == "dc_s3gd"),
                      f"[cnn] {algo} lambda: {h}")
        for name, n in launches.items():
            want = CNN_STEPS * len(CNN_BUCKETS) if fused and name in (
                "dc_norms", "dc_fused_update") else 0
            check(n == want, f"[cnn] {algo}: {name} launched {n} times, "
                  f"expected {want} ({CNN_STEPS} steps x "
                  f"{len(CNN_BUCKETS)} buckets on its path)")
        walls = [h["wall_s"] for h in hist]
        step_s = statistics.median(b - a for a, b in zip(walls[1:],
                                                          walls[2:]))
        images = CNN_W * CNN_PER_WORKER
        for h in hist:
            print(f"[cnn] {algo} step {h['step']} loss={h['loss']:.6f} "
                  f"lambda={h.get('lambda', 0.0):.6g} "
                  f"|D|={h.get('distance_norm', 0.0):.6g} lr={h['lr']:.6g}")
        print(f"[cnn] {algo}: launches {launches}; step "
              f"{step_s * 1e3:.3f} ms (median of steps 2-5, metrics fetched "
              f"every step), {images / step_s:.1f} images/s; peak memory "
              f"{peak / 2**30:.3f} GiB, of which {before / 2**20:.1f} MiB "
              f"were allocated before the run; top-1 error "
              f"{result['top1_err']:.3f} [{smi}]")
        out[algo] = {"step_ms": step_s * 1e3,
                     "images_per_s": images / step_s, "peak_bytes": peak,
                     "allocated_before": before, "launches": launches,
                     "losses": [h["loss"] for h in hist],
                     "top1_err": result["top1_err"]}
        del result
        torch.cuda.empty_cache()
    return out


def phase_cnn_fused_vs_unfused(smi: str) -> float:
    """3 dc_s3gd steps from the same weights, fused kernels vs the unfused
    torch tail, under cudnn.deterministic (the convolutions then give the
    same gradients for the same inputs): every element of the final
    weights within 1e-4 x its leaf's largest update + 1e-5 x its own
    magnitude (the CPU parity tests' criterion; the rtol term covers the
    leaves whose update is a few ulps of the weight, as SkipInit's
    zero scale makes the second conv's)."""
    from repro_torch import tree as T
    from repro_torch.models.cnn import init_resnet
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        finals = {fused: T.leaves(_cnn("dc_s3gd", 3, use_kernels=fused,
                                       buckets=N_BUCKETS)["state"].params)
                  for fused in (True, False)}
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved
    w0 = T.leaves(init_resnet(torch.Generator(device="cuda").manual_seed(0),
                              **RESNET18))
    worst = 0.0
    for a, b, z in zip(finals[True], finals[False], w0):
        allowed = 1e-4 * (b - z).abs().max() + 1e-5 * b.abs()
        ratio = float(((a - b).abs() / allowed.clamp_min(1e-30)).max())
        worst = max(worst, ratio)
        check(ratio <= 1.0, f"[cnn-fused] fused vs unfused beyond 1e-4 x "
              f"update + 1e-5 x |w|: {ratio:.3g} of it")
    print(f"[cnn-fused] 3 steps, fused vs unfused tail (cudnn "
          f"deterministic): worst element at {worst:.3g} of its allowance "
          f"(1e-4 x leaf update + 1e-5 x |w|) [{smi}]")
    del finals
    torch.cuda.empty_cache()
    return worst


def phase_cnn_profile(smi: str) -> dict:
    """Two steady dc_s3gd steps (steps 2-3) on ResNet-18's layout under
    torch.profiler — device time by kernel group and the idle share —
    then one step under PyTorch's sync debug mode (0 host syncs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.examples import cnn_paper_repro as twin
    model, alg, state, batch_fn, _ = twin.build(
        "dc_s3gd", twin.recipe(CNN_W, CNN_STEPS), CNN_W, CNN_STEPS,
        device="cuda", net=RESNET18, image_size=CNN_IMAGE,
        per_worker=CNN_PER_WORKER, use_kernels=True, buckets=N_BUCKETS)
    for it in range(2):
        state, _ = alg.step(state, batch_fn(it), loss_fn=model.loss)
    batches = [batch_fn(2), batch_fn(3), batch_fn(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:2]:
            state, _ = alg.step(state, b, loss_fn=model.loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = alg.step(state, batches[2], loss_fn=model.loss)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[cnn-profile] host synchronisations inside step 4: {syncs}")
    check(syncs == 0, f"[cnn] {syncs} host synchronisations inside a step")
    del state, batches
    torch.cuda.empty_cache()
    groups = {"dc_update kernels": ("norms_", "fused_update"),
              # cuDNN's convolution kernels (forward, dgrad, wgrad) and its
              # layout transforms
              "conv (cuDNN)": ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                               "implicit", "nhwc", "Nhwc", "nchw", "Nchw",
                               "winograd"),
              "matmul (cuBLAS)": ("gemm", "gemv", "xmma", "cutlass",
                                  "Kernel2"),
              "copies/cat": ("Memcpy", "copy", "Copy", "Cat")}
    other = "other (elementwise, reductions, pad, softmax)"
    kernels, busy_ms, by_group, dev_us = _device_groups(prof, groups, other)
    if busy_ms == 0:
        print(f"[cnn-profile] no device time in the trace: not measured "
              f"[{smi}]")
        return {"host_syncs_per_step": syncs}
    launches = sum(e.count for e in kernels)
    print(f"[cnn-profile] 2 steps: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {launches} kernel "
          f"launches [{smi}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[cnn-profile]   {g}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}% "
              f"of device time)")
    for e in kernels[:15]:
        print(f"[cnn-profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:100]}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_cnn.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": by_group,
            "kernel_launches": launches, "host_syncs_per_step": syncs}


def phase_cnn_variants(smi: str) -> dict:
    """Two untimed steps on ResNet-18's layout of each other local
    optimizer, per-tensor λ, DC-ASGD, dynamic SSP under measured skew and
    the two weight-mixing reducers: finite losses."""
    out = {}
    for name, kw in CNN_VARIANTS.items():
        kw = dict(kw)
        algo = kw.pop("algo", "dc_s3gd")
        t0 = time.perf_counter()
        result = _cnn(algo, 2, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hist = result["history"]
        losses = [h["loss"] for h in hist]
        check(len(losses) == 2 and all(map(math.isfinite, losses)),
              f"[cnn-variants] {name}: losses {losses}")
        extra = ""
        if name == "dynamic_ssp":
            admit = [h["ssp_admit"] for h in hist]
            skew = [h["measured_skew"] for h in hist]
            check(admit == [1.0, 1.0], f"[cnn-variants] ssp_admit {admit}")
            extra = f" ssp_admit {admit} measured_skew {skew}"
        print(f"[cnn-variants] {name} ({algo}): losses {losses}{extra} in "
              f"{secs:.2f} s [{smi}]")
        out[name] = {"losses": losses, "s": secs}
        del result
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serving: qwen3-0.6b at full depth over the paged KV cache (kernel B4)
# ---------------------------------------------------------------------------

PAGE = 16
SERVE_ARGS = ["--arch", "qwen3-0.6b", "--slots", "16", "--pages", "641",
              "--page-size", str(PAGE), "--decode-burst", "4",
              "--seed", "0"]
SERVE_REQUESTS = 48
PROMPT_LENS = (128, 256, 384, 512)
# the serving shape of the kernel: 16 slots, qwen3's 8 kv heads of 128, two
# query heads per kv head; ragged lengths 1 ... 577 (the longest request's
# prompt + gen + 1), a length-1 row and partial last pages among them
PA_SHAPE = (16, 8, 2, 128)
PA_LENGTHS = [1 + (i * 576) // 15 for i in range(16)]
PA_WIDTH = 640            # the serve run's block-table width: 640 pages
PA_LIVE = -(-max(PA_LENGTHS) // PAGE)    # 37 pages hold the longest row
# a timed sample launches once on each of the serve step's 28 per-layer
# pools: 28 x the live k/v (0.53 GB at bf16) is ten times the H100's 50 MB
# L2, so every launch reads its pages from HBM, as in the serve step
PA_LAYERS = 28
PA_POOLS = ("bfloat16", "float32", "int8", "fp8")


def _paged_case(gen, pool: str, width: int):
    """q, pools of 641 pages, block tables, lengths and (quantized pools)
    scales at the serving shape.  Each row's live pages are distinct; the
    rest of its ``width``-wide table points at the scratch page 0, as the
    scheduler leaves it."""
    from repro_torch.models.cache import _quantize_tokens
    dev = torch.device("cuda")
    B, KV, G, hd = PA_SHAPE
    n_pages = 641
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev)
    k = torch.randn((n_pages, PAGE, KV, hd), generator=gen, device=dev)
    v = torch.randn((n_pages, PAGE, KV, hd), generator=gen, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = torch.zeros((B, width), dtype=torch.int32, device=dev)
    at = 0
    for b, n in enumerate(PA_LENGTHS):
        live = -(-n // PAGE)
        bt[b, :live] = perm[at:at + live].int()
        at += live
    lengths = torch.tensor(PA_LENGTHS, dtype=torch.int32, device=dev)
    if pool in ("int8", "fp8"):
        k, ks = _quantize_tokens(k, pool, 2)
        v, vs = _quantize_tokens(v, pool, 2)
        return q, k, v, bt, lengths, (ks, vs)
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[pool]
    return q, k.to(dt), v.to(dt), bt, lengths, ()


def _layers(t: torch.Tensor) -> torch.Tensor:
    """``PA_LAYERS`` copies of one layer's pool, stacked as the serve
    step's ``(L, num_pages, ...)`` pool."""
    return t.unsqueeze(0).repeat((PA_LAYERS,) + (1,) * t.dim())


def _rotating(fn):
    """A no-argument call that runs ``fn(layer)`` on the next layer each
    time, cycling over ``PA_LAYERS``."""
    layers = itertools.cycle(range(PA_LAYERS))
    return lambda: fn(next(layers))


def _paged_bytes(q, k, scales) -> int:
    """Bytes the function must move: each live k and v row (and its scale)
    once, the live block-table entries and the lengths, q in, f32 out."""
    B, KV, G, hd = q.shape
    tokens = sum(PA_LENGTHS)
    pages = sum(-(-n // PAGE) for n in PA_LENGTHS)
    return (2 * tokens * KV * hd * k.element_size()
            + (2 * tokens * 4 if scales else 0)
            + 4 * pages + 4 * B + 2 * 4 * q.numel())


def phase_paged_kernel(smi: str) -> dict:
    """paged_attention against its plain version at the serving shape for
    bf16, f32, int8 and fp8 pools (atol 1e-6 float pools, 2e-5 quantized:
    the reference's own tolerances), timed (CUDA events, median of 10
    samples after 2 warm-ups; a sample is one launch on each of 28 per-
    layer pools, as the serve step reads them, so no launch finds its pages
    in L2, queued before the first starts) beside its byte bound, the plain version, and gather +
    scaled_dot_product_attention on the linearized view; the same lengths
    through a 640-wide and a live-width block table take the same time
    (the kernel stops at each row's last live page).  Returns the numbers
    per pool dtype."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention, splits_for
    from repro_torch.kernels.ref import paged_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, KV, G, hd = PA_SHAPE
    splits = splits_for(B, KV, torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(f"[paged] split-K: {splits} splits per (kv head, row), "
          f"{KV * B * splits} pass-1 CTAs and {KV * B} merge CTAs per "
          f"launch [{smi}]")
    rec = {"split_k": {"splits": splits, "ctas": KV * B * splits}}
    for pool in PA_POOLS:
        q, k, v, bt, ln, scales = _paged_case(gen, pool, PA_WIDTH)
        kw = dict(zip(("k_scale", "v_scale"), scales))
        narrow = bt[:, :PA_LIVE].contiguous()
        got = paged_attention(q, k, v, bt, ln, **kw)
        got_again = paged_attention(q, k, v, bt, ln, **kw)
        got_narrow = paged_attention(q, k, v, narrow, ln, **kw)
        want = paged_attention_plain(q, k, v, bt, ln, *scales)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = 2e-5 if scales else 1e-6
        check(err <= atol, f"paged_attention {pool} pools: max abs err "
              f"{err} > {atol}")
        check(torch.equal(got, got_narrow), f"paged_attention {pool}: "
              "640-wide and live-width block tables differ")
        check(torch.equal(got, got_again), f"paged_attention {pool}: "
              "two launches differ")
        del got, got_again, got_narrow, want
        kL, vL = _layers(k), _layers(v)
        sL = tuple(_layers(s) for s in scales)

        def launch(layer, table):
            return paged_attention(q, kL[layer], vL[layer], table, ln,
                                   **{n: s[layer] for n, s in zip(
                                       ("k_scale", "v_scale"), sL)})

        wide_ms = median_ms(_rotating(lambda i: launch(i, bt)),
                            batch=PA_LAYERS)
        narrow_ms = median_ms(_rotating(lambda i: launch(i, narrow)),
                              batch=PA_LAYERS)
        plain_ms = median_ms(_rotating(lambda i: paged_attention_plain(
            q, kL[i], vL[i], bt, ln, *(s[i] for s in sL))), batch=PA_LAYERS)
        nbytes = _paged_bytes(q, k, scales)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        flops = 4 * G * hd * KV * sum(PA_LENGTHS)
        print(f"[paged] {pool} pools, B={B} KV={KV} G={G} hd={hd} page "
              f"{PAGE}, lengths 1..{max(PA_LENGTHS)} ({sum(PA_LENGTHS)} "
              f"live tokens): {wide_ms:.4f} ms/launch at width {PA_WIDTH}, "
              f"{narrow_ms:.4f} ms at width {PA_LIVE}; plain {plain_ms:.4f} "
              f"ms; byte bound {bound:.4f} ms ({nbytes} B; {flops} flops); "
              f"max abs err {err:.3g} [{smi}]")
        check(abs(wide_ms - narrow_ms) <= 0.1 * narrow_ms,
              f"paged_attention {pool}: {wide_ms} ms at width {PA_WIDTH} "
              f"vs {narrow_ms} ms at width {PA_LIVE}: not within 10 %")
        rec[pool] = {"ms": wide_ms, "narrow_ms": narrow_ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bytes": nbytes, "err": err}
        if pool == "bfloat16":
            # no single PyTorch call reads pages through a block table:
            # gather the live pages, then one SDPA call (bf16 q)
            def gather_sdpa(layer=0):
                btl = narrow.long()
                S = PA_LIVE * PAGE
                kl = kL[layer][btl].reshape(B, S, KV, hd).transpose(1, 2)
                vl = vL[layer][btl].reshape(B, S, KV, hd).transpose(1, 2)
                mask = (torch.arange(S, device=q.device)[None, :]
                        < ln[:, None].long())[:, None, None, :]
                return F.scaled_dot_product_attention(
                    q.reshape(B, KV * G, 1, hd).to(kl.dtype), kl, vl,
                    attn_mask=mask, enable_gqa=True)
            ref = paged_attention_plain(q, k, v, narrow, ln)
            sdpa_err = float((gather_sdpa().float().reshape(ref.shape)
                              - ref).abs().max())
            rec[pool]["gather_sdpa_ms"] = median_ms(_rotating(gather_sdpa),
                                                    batch=PA_LAYERS)
            print(f"[paged] gather of the {PA_LIVE} live pages + "
                  f"scaled_dot_product_attention (bf16): "
                  f"{rec[pool]['gather_sdpa_ms']:.4f} ms (two calls, not "
                  f"one: library_ms stays null; max abs diff {sdpa_err:.3g})"
                  f" [{smi}]")
        del q, k, v, bt, ln, scales, narrow, kL, vL, sL
        torch.cuda.empty_cache()
    return rec


def _write_requests() -> Path:
    """48 requests, prompt_len cycling 128/256/384/512, gen drawn 32..64
    from seed 0, as JSONL beside the run's other records."""
    import numpy as np
    gens = np.random.default_rng(0).integers(32, 65, SERVE_REQUESTS)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "serve_requests.jsonl"
    path.write_text("".join(
        json.dumps({"id": i, "prompt_len": PROMPT_LENS[i % 4],
                    "gen": int(g)}) + "\n" for i, g in enumerate(gens)))
    return path


def phase_serve(smi: str, path: Path, extra=(), n_requests=None,
                tag: str = "serve", built=None):
    """Serve the request file through ``repro_torch.launch.serve`` at full
    depth (28 layers, published widths, f32 params, bf16 compute and KV
    unless ``extra`` says otherwise).  Every kernel count is set to 0 just
    before the run and read just after.  Returns (record, (model, params),
    requests)."""
    from repro_torch.launch import serve
    args = serve.build_argparser().parse_args(
        SERVE_ARGS + ["--requests", str(path), *extra])
    model, params, _ = built or serve.build(args)
    check(model.cfg.n_layers == 28, "full depth")
    reqs = serve.load_requests(args.requests, model.cfg.vocab_size,
                               args.gen, seed=args.seed)[:n_requests]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    sch = serve.run_scheduler(model, params, reqs, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    peak = torch.cuda.max_memory_allocated()
    done = {r.rid: r for r in sch.finished}
    check(sorted(done) == sorted(r.rid for r in reqs),
          f"[{tag}] {len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        check(len(done[r.rid].out) == r.max_new,
              f"[{tag}] request {r.rid}: {len(done[r.rid].out)} tokens, "
              f"expected {r.max_new}")
    steps = sch.stats["decode_steps"]
    prefills = sch.stats["prefills"]
    check(launches["paged_attention"] == 28 * steps,
          f"[{tag}] paged_attention launched {launches['paged_attention']} "
          f"times, expected 28 layers x {steps} decode steps")
    check(launches["flash_attention"] == 28 * prefills,
          f"[{tag}] flash_attention launched {launches['flash_attention']} "
          f"times, expected 28 layers x {prefills} prefills")
    check(all(n == 0 for k, n in launches.items()
              if k not in ("paged_attention", "flash_attention")),
          f"[{tag}] other kernels launched while serving: {launches}")
    check(sch.pool.used_pages == 0, f"[{tag}] {sch.pool.used_pages} pages "
          "still allocated after the run")
    check(sch.stats["preemptions"] == 0, f"[{tag}] preempted: the pool "
          "holds every request at full length")
    quant = sch.layout.kv_quantized
    pool = sch.cache[0]["b0"]["k"]
    check(pool.dtype == (torch.int8 if quant else torch.bfloat16)
          and ("k_scale" in sch.cache[0]["b0"]) == quant,
          f"[{tag}] pool dtype {pool.dtype}")
    s = sch.latency_summary()
    decode_s = sum(sch.stats["step_walls"])
    decode_tokens = s["tokens"] - len(reqs)
    rec = {
        "requests": len(reqs), "tokens": s["tokens"], "wall_s": wall,
        "tokens_per_s": s["tokens"] / wall,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_steps": steps, "step_ms": decode_s / steps * 1e3,
        "bursts": len(sch.stats["step_walls"]),
        "prefills": s["prefills"], "launches": launches,
        "peak_bytes": peak, "before_bytes": before,
        "kv_dtype": s["kv_dtype"], "kv_bytes_per_token":
            s["kv_bytes_per_token"],
        **{k: s[k] for k in ("p50_token_latency_s", "p95_token_latency_s",
                             "p50_ttft_s", "p95_ttft_s",
                             "mean_pool_utilization")},
    }
    print(f"[{tag}] {len(reqs)} requests, {s['tokens']} tokens in "
          f"{wall:.3f} s ({rec['tokens_per_s']:.1f} tok/s); decode "
          f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f} s "
          f"({rec['decode_tokens_per_s']:.1f} tok/s, {rec['step_ms']:.3f} "
          f"ms/step); {s['prefills']} prefills; paged_attention launches "
          f"{launches['paged_attention']} = 28 x {steps}, flash_attention "
          f"{launches['flash_attention']} = 28 x {prefills} [{smi}]")
    print(f"[{tag}] inter-token p50 {s['p50_token_latency_s'] * 1e3:.3f} "
          f"ms p95 {s['p95_token_latency_s'] * 1e3:.3f} ms; TTFT p50 "
          f"{s['p50_ttft_s'] * 1e3:.1f} ms p95 {s['p95_ttft_s'] * 1e3:.1f} "
          f"ms; KV {s['kv_dtype']} {s['kv_bytes_per_token']} B/token; "
          f"peak memory {peak / 2**30:.3f} GiB ({peak} B), of which "
          f"{before / 2**20:.1f} MiB were allocated before the run [{smi}]")
    del sch
    torch.cuda.empty_cache()
    return rec, (model, params), reqs


def phase_kernel_vs_gather(smi: str, model, params, reqs,
                           steps: int = 24) -> dict:
    """Kernel path against gather path on one group of 16 prompts (the
    first 16 requests cut to 128 tokens), teacher-forced: both layouts
    take the gather path's greedy token every step.  At bf16 the gather
    path rounds the softmax probabilities to bf16 before the PV product
    (as the reference's attend_one does) and the kernel keeps them in
    f32, so each attention output differs by up to bf16's unit roundoff
    2^-9 relative; the bound held is 2^-7 of the largest logit (that
    roundoff with a factor 4 for its growth through 28 layers).  The f32
    pools, where the two paths differ only in summation order, are a
    reference reading held to the same bound.  Also counts the steps on which free greedy runs of the
    two paths agree."""
    from repro_torch.models.cache import PagedLayout
    dev = torch.device("cuda")
    P, B = PROMPT_LENS[0], 16
    V = model.cfg.vocab_size
    prompts = torch.tensor([r.prompt[:P] for r in reqs[:B]], device=dev)
    mp = -(-(P + steps + 1) // PAGE)
    pages = torch.arange(1, B * mp + 1, device=dev).reshape(B, mp)
    pos0 = torch.full((B,), P, device=dev)

    def prefilled(use_kernel, kv_dtype):
        lay = PagedLayout(model, n_slots=B, num_pages=B * mp + 1,
                          page_size=PAGE, max_pages=mp,
                          use_kernel=use_kernel, kv_dtype=kv_dtype)
        cache = lay.init_cache(device=dev)
        logits, cache = lay.prefill_into(params, cache, {"tokens": prompts},
                                         pages[:, :lay.pages_for(P)])
        return lay, cache, logits

    rec = {}
    for kv_dtype in (None, "float32"):
        (lk, ck, _), (lg, cg, first) = (prefilled(True, kv_dtype),
                                        prefilled(False, kv_dtype))
        tok, pos, worst, top = first.argmax(-1), pos0, 0.0, 0.0
        for _ in range(steps):
            a, ck = lk.decode_step(params, ck, tok[:, None], pos, pages)
            b, cg = lg.decode_step(params, cg, tok[:, None], pos, pages)
            worst = max(worst, float((a - b)[:, :V].abs().max()))
            top = max(top, float(b[:, :V].abs().max()))
            tok, pos = b.argmax(-1), pos + 1
        # free greedy: each path on its own tokens
        (lk, ck, first_k), (lg, cg, first_g) = (prefilled(True, kv_dtype),
                                                prefilled(False, kv_dtype))
        tk, tg, pos = first_k.argmax(-1), first_g.argmax(-1), pos0
        agree = int(torch.equal(tk, tg))
        for _ in range(steps):
            a, ck = lk.decode_step(params, ck, tk[:, None], pos, pages)
            b, cg = lg.decode_step(params, cg, tg[:, None], pos, pages)
            tk, tg, pos = a.argmax(-1), b.argmax(-1), pos + 1
            agree += int(torch.equal(tk, tg))
        name = kv_dtype or "bfloat16"
        bound = 2 ** -7 * top
        print(f"[kernel-vs-gather] {name} pools, 16 rows x {steps} "
              f"teacher-forced steps at 28 layers: max |dlogit| "
              f"{worst:.4g} (bound {bound:.4g} = 2^-7 x max |logit| "
              f"{top:.4g}); free greedy tokens agree on {agree} of "
              f"{steps + 1} steps, all 16 rows [{smi}]")
        check(worst <= bound, f"kernel vs gather path, {name} pools: max "
              f"|dlogit| {worst} > {bound}")
        rec[name] = {"max_dlogit": worst, "max_logit": top, "bound": bound,
                     "greedy_agree_steps": agree, "steps": steps + 1}
        del ck, cg
        torch.cuda.empty_cache()
    return rec


def phase_serve_profile(smi: str, model, params, reqs, argv=SERVE_ARGS,
                        tag: str = "serve-profile",
                        out_name: str = "profile_serve.txt") -> dict:
    """A steady decode burst of 16 slots: host synchronisations inside one
    burst under PyTorch's sync debug mode (its inputs copied to the device
    before the window), then two bursts under torch.profiler, device time
    by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serve import Request, Scheduler
    args = serve.build_argparser().parse_args(argv)
    sch = Scheduler(model, params, slots=args.slots, pages=args.pages,
                    page_size=args.page_size, use_kernel=args.paged_kernel,
                    decode_burst=args.decode_burst, seed=args.seed)
    for r in reqs[:16]:
        sch.submit(Request(rid=r.rid, prompt=r.prompt, max_new=64))
    for _ in range(3):          # admit all 16, then two steady bursts
        sch.step()
    burst = args.decode_burst
    sch._grow(burst)
    inputs = (sch._tensor(sch.next_tok), sch._tensor(sch.pos),
              sch._tensor(sch.block_tables))
    sch.decode(*inputs, burst)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sch.decode(*inputs, burst)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[{tag}] host synchronisations inside one decode burst "
          f"({burst} steps, 16 slots): {syncs}")
    check(syncs == 0, f"{syncs} host synchronisations inside a decode burst")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            sch.decode(*inputs, burst)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del sch
    torch.cuda.empty_cache()
    groups = {"paged_attention kernel (both passes)": ("paged_partial",
                                                       "paged_merge"),
              "matmul (cuBLAS)": ("gemm", "gemv", "xmma", "cutlass",
                                  "Kernel2"),
              "index / scatter / gather": ("index", "scatter", "gather"),
              "copies/cat": ("Memcpy", "copy", "Copy", "Cat")}
    kernels, busy_ms, by_group, dev_us = _device_groups(
        prof, groups, "other (elementwise, norms, softmax, argmax)")
    launches = sum(e.count for e in kernels)
    if busy_ms == 0:
        print(f"[{tag}] no device time in the trace: not measured [{smi}]")
        return {"host_syncs_per_burst": syncs}
    print(f"[{tag}] 2 bursts ({2 * burst} decode steps): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {launches} kernel "
          f"launches ({launches / (2 * burst):.0f} per step) [{smi}]")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {g}: {ms:.3f} ms ({100 * ms / busy_ms:.1f}%"
              f" of device time)")
    for e in kernels[:12]:
        print(f"[{tag}]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / out_name).write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": by_group,
            "kernel_launches": launches, "host_syncs_per_burst": syncs}


# ---------------------------------------------------------------------------
# prefill kernels: flash_attention (B5) and ssm_scan (B6)
# ---------------------------------------------------------------------------

# qwen3-0.6b's attention: 8 kv heads, 2 query heads per kv head, hd 128
FLASH_SHAPE = (8, 2, 128)
# a timed sample is 28 back-to-back launches, as one qwen3 prefill makes
PREFILL_LAYERS = 28
PEAK_FLOPS = {torch.float32: 67e12,     # H100 SXM data sheet: f32, CUDA cores
              torch.bfloat16: 989e12}   # and bf16 dense on the tensor cores
# the ceilings of flash_attention's products: f32 as 3xTF32 (three TF32
# products per f32 one at 495 TFLOP/s), bf16 on the tensor cores
FLASH_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
# falcon-mamba-7b's scan: E = expand x d_model, N = state_dim
SSM_E, SSM_N = 8192, 16


def _live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves live: the work these inputs
    need (the kernel skips tiles that are wholly masked)."""
    i = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        live &= j <= i
    if window > 0:
        live &= (i - j) < window
    return int(live.sum())


def flash_mma_counts() -> dict:
    """Tensor-core instructions (HMMA / HGMMA) in the SASS of each
    flash_attention kernel instantiation, read with ``cuobjdump -sass`` from
    the built library: {kernel name: (HMMA, HGMMA)}."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.load_all(("flash_attention",))[
                               "flash_attention"].path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None and "HGMMA" in line:
            counts[name][1] += 1
        elif name is not None and "HMMA" in line:
            counts[name][0] += 1
    return {n: tuple(c) for n, c in counts.items()
            if "flash_attention_kernel" in n}


def phase_flash_kernel(smi: str) -> dict:
    """flash_attention against its plain version at the qwen3-0.6b
    prefill's shapes (B 1, causal, S 128/256/384/512, in f32, the path's
    dtype: the f32 weights promote the bf16 activations, and in bf16), a
    windowed case and a ragged non-causal Sq != Sk case (atol 2e-5 f32,
    3e-2 bf16: the reference's tolerances; bitwise equal across two
    launches), each timed beside its bound, the plain version and
    scaled_dot_product_attention (enable_gqa) in the same dtype on the same
    inputs.  The bound is the larger of bytes over 3.35 TB/s and the live
    pairs' 4 hd flops each over the ceiling of the kernel's products
    (f32 as 3xTF32, 165 TFLOP/s; bf16 989); f32's CUDA-core bound (67
    TFLOP/s) is printed beside it.  First, every instantiation's SASS must
    hold tensor-core instructions.  Returns the numbers per case and the
    SASS counts."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    mma = flash_mma_counts()
    check(len(mma) == 8, f"flash_attention: {len(mma)} kernels in the SASS")
    for name, (hmma, hgmma) in mma.items():
        print(f"[flash] SASS {name}: {hmma} HMMA, {hgmma} HGMMA")
        check(hmma + hgmma > 0, f"flash_attention: no tensor-core "
              f"instruction in {name}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    KV, G, hd = FLASH_SHAPE
    H = KV * G
    cases = [(f"S={S} {n}", S, S, True, 0, dt)
             for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
             for S in PROMPT_LENS] + [
        ("S=512 f32 window 128", 512, 512, True, 128, torch.float32),
        ("Sq=200 Sk=333 f32 non-causal", 200, 333, False, 0,
         torch.float32)]
    rec = {"sass_hmma_hgmma": mma}
    for name, sq, sk, causal, window, dt in cases:
        q = torch.randn((1, sq, KV, G, hd), generator=gen,
                        device="cuda").to(dt)
        k = torch.randn((1, sk, KV, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, sk, KV, hd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        atol = 2e-5 if dt == torch.float32 else 3e-2
        check(got.dtype == dt and err <= atol, f"flash_attention {name}: "
              f"max abs err {err} > {atol}")
        check(torch.equal(got, again), f"flash_attention {name}: two "
              "launches differ")
        ms = median_ms(lambda: flash_attention(q, k, v, **kw),
                       batch=PREFILL_LAYERS)
        plain_ms = median_ms(lambda: flash_attention_plain(q, k, v, **kw),
                             batch=PREFILL_LAYERS)
        # the library yardstick: one SDPA call on (B, heads, S, hd) views
        qs, ks, vs = (q.reshape(1, sq, H, hd).transpose(1, 2),
                      k.transpose(1, 2), v.transpose(1, 2))
        mask = None
        if window > 0:
            i = torch.arange(sq, device="cuda")[:, None]
            j = torch.arange(sk, device="cuda")[None, :]
            mask = (j <= i) & ((i - j) < window)

        def sdpa():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
        sdpa_err = float((sdpa().transpose(1, 2).reshape(want.shape).float()
                          - want.float()).abs().max())
        library_ms = median_ms(sdpa, batch=PREFILL_LAYERS)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * hd * H * _live_pairs(sq, sk, causal, window)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / FLASH_FLOPS[dt] * 1e3
        bound = max(byte_ms, op_ms)
        by = "operations" if op_ms >= byte_ms else "bytes"
        core = "" if dt != torch.float32 else \
            f"; CUDA-core f32 bound {flops / PEAK_FLOPS[dt] * 1e3:.4f} ms"
        print(f"[flash] {name}: B=1 KV={KV} G={G} hd={hd}: {ms:.4f} "
              f"ms/launch; plain {plain_ms:.4f} ms; sdpa {library_ms:.4f} "
              f"ms (max abs diff {sdpa_err:.3g}); bound {bound:.4f} ms by "
              f"{by} ({nbytes} B, {flops} flops at "
              f"{FLASH_FLOPS[dt] / 1e12:.0f} TFLOP/s){core}; max abs err "
              f"{err:.3g}, bitwise run to run [{smi}]")
        rec[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                     "flops": flops, "err": err, "sdpa_err": sdpa_err}
        if dt == torch.float32:
            rec[name]["cuda_core_bound_ms"] = flops / PEAK_FLOPS[dt] * 1e3
        del q, k, v, got, again, want, qs, ks, vs, mask
        torch.cuda.empty_cache()
    return rec


def _ssm_case(gen, B: int, S: int, E: int):
    """Scan inputs as the falcon-mamba prefill makes them: a_log of the
    S4D-real init (A = -1..-N), dt a softplus near the init's 0.01-0.1,
    dtx = dt * x, b and c of unit scale."""
    dev = torch.device("cuda")
    a_log = torch.log(torch.arange(1, SSM_N + 1, dtype=torch.float32,
                                   device=dev)).expand(E, SSM_N).contiguous()
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, E), generator=gen, device=dev) - 3.5)
    dtx = dt * torch.randn((B, S, E), generator=gen, device=dev)
    b = torch.randn((B, S, SSM_N), generator=gen, device=dev)
    c = torch.randn((B, S, SSM_N), generator=gen, device=dev)
    return a_log, dt, dtx, b, c


def phase_ssm_kernel(smi: str) -> dict:
    """ssm_scan against its plain version at falcon-mamba-7b's prefill
    shapes (B 1, E 8,192, N 16, S 128/256/384/512, f32) and a ragged case
    (B 2, S 77, E 1,000): y and h_last within 1e-4 (the reference's
    tolerance), timed (8 launches per sample) beside its bound (bytes: dt,
    dtx, b, c, a_log read once, y and h_last written once; 7 flops per
    (t, e, n)) and the plain version.  Returns the numbers per case."""
    from repro_torch.kernels.ref import ssm_scan_plain
    from repro_torch.kernels.ssm_scan import (chunk_length, ctas_per_chunk,
                                              ssm_scan)
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(f"S={S}", 1, S, SSM_E) for S in PROMPT_LENS] + [
        ("ragged B=2 S=77 E=1000", 2, 77, 1000)]
    rec = {}
    for name, B, S, E in cases:
        args = _ssm_case(gen, B, S, E)
        y, h = ssm_scan(*args)
        y2, h2 = ssm_scan(*args)
        yr, hr = ssm_scan_plain(*args)
        torch.cuda.synchronize()
        err = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
        check(err <= 1e-4, f"ssm_scan {name}: max abs err {err} > 1e-4")
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"ssm_scan {name}: two launches differ")
        L = chunk_length(B, S, E, SSM_N, sms)
        chunks = -(-S // L)
        ctas = ctas_per_chunk(B, E, SSM_N)
        dh = float((h - hr).abs().max())
        if chunks == 1:
            # one chunk is the sequential chain: bitwise the plain version
            check(torch.equal(h, hr), f"ssm_scan {name}: one chunk, h_last "
                  "not bitwise the plain version's")
            h_note = "h_last bitwise the plain version's (one chunk)"
        else:
            h_note = f"max |dh_last| {dh:.3g} (the carry rounds apart)"
        print(f"[ssm] {name}: chunks of L={L}, C={chunks}: "
              f"{ctas * (chunks - 1)} pass-1 and {ctas * max(chunks - 1, 1)}"
              f" pass-2 CTAs per launch [{smi}]")
        ms = median_ms(lambda: ssm_scan(*args), batch=8)
        plain_ms = median_ms(lambda: ssm_scan_plain(*args))
        nbytes = 4 * (3 * B * S * E + 2 * B * S * SSM_N + E * SSM_N
                      + B * E * SSM_N)
        flops = 7 * B * S * E * SSM_N
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        bound = max(byte_ms, op_ms)
        by = "operations" if op_ms >= byte_ms else "bytes"
        print(f"[ssm] {name} N={SSM_N}: {ms:.4f} ms/launch; plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms by {by} ({nbytes} "
              f"B, {flops} flops); max abs err {err:.3g}; {h_note} "
              f"[{smi}]")
        rec[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "bytes": nbytes, "flops": flops,
                     "err": err, "dh_last": dh, "chunk": L, "chunks": chunks}
        del args, y, h, y2, h2, yr, hr
        torch.cuda.empty_cache()
    return rec


def phase_prefill_routes(smi: str, model, params, prompts, tag: str,
                         bound_log2: int) -> dict:
    """Last-position logits of each prompt's prefill (one request at a
    time, as the scheduler admits them), kernel route against plain route
    (``Model(cfg, kernels=False)``) on the same weights.  The prefill sees
    the whole prompt, so both routes are teacher-forced by construction.
    The bound held is 2^-bound_log2 of the largest logit (the bounds are
    stated with their reasons in PERF.md).  The kernel route must launch
    and the plain route must not."""
    from repro_torch.models.transformer import Model
    plain = Model(model.cfg, kernels=False)
    counted = _counters()
    V = model.cfg.vocab_size
    worst = top = 0.0
    for p in prompts:
        toks = torch.tensor([p], device="cuda")
        before = {n: fn.launches for n, fn in counted.items()}
        a, _ = model.prefill(params, {"tokens": toks}, cache_len=len(p))
        mid = {n: fn.launches for n, fn in counted.items()}
        b, _ = plain.prefill(params, {"tokens": toks}, cache_len=len(p))
        after = {n: fn.launches for n, fn in counted.items()}
        check(any(mid[n] > before[n] for n in counted)
              and after == mid, f"[{tag}] routes: {before} {mid} {after}")
        worst = max(worst, float((a - b)[:, :V].abs().max()))
        top = max(top, float(b[:, :V].abs().max()))
        del a, b
    bound = 2.0 ** -bound_log2 * top
    print(f"[{tag}] {len(prompts)} prompts ({[len(p) for p in prompts]} "
          f"tokens), kernel route vs plain route: max |dlogit| {worst:.4g} "
          f"(bound {bound:.4g} = 2^-{bound_log2} x max |logit| {top:.4g}) "
          f"[{smi}]")
    check(worst <= bound, f"[{tag}] max |dlogit| {worst} > {bound}")
    torch.cuda.empty_cache()
    return {"max_dlogit": worst, "max_logit": top, "bound": bound,
            "prompts": [len(p) for p in prompts]}


# ---------------------------------------------------------------------------
# serving falcon-mamba-7b at full depth (kernel B6 in every prefill)
# ---------------------------------------------------------------------------

FM_ARGS = ["--arch", "falcon-mamba-7b", "--slots", "16", "--decode-burst",
           "4", "--seed", "0"]
FM_PARAMS = 7_272_665_088     # 64 x 105,312,256 + 2 x 65,024 x 4,096


def phase_serve_ssm(smi: str, path: Path) -> dict:
    """Serve the request file with falcon-mamba-7b at its published widths
    and full depth through ``repro_torch.launch.serve`` (f32 params from
    seed 0, bf16 compute, 16 slots, bursts of 4, greedy).  Every kernel
    count is set to 0 just before the run and read just after: ssm_scan 64
    times per prefill, nothing else.  Then the host synchronisations of a
    steady burst, two bursts profiled, and the prefill's scan kernel route
    against its plain route on 2 prompts."""
    from repro_torch import tree as T
    from repro_torch.launch import serve
    args = serve.build_argparser().parse_args(
        FM_ARGS + ["--requests", str(path)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, params, _ = serve.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_params = sum(x.numel() for x in T.leaves(params))
    check(cfg.n_layers == 64 and cfg.d_model == 4096
          and cfg.ssm.state_dim == SSM_N and n_params == FM_PARAMS,
          f"falcon-mamba-7b at full depth and width: {cfg}, {n_params}")
    reqs = serve.load_requests(args.requests, cfg.vocab_size, args.gen,
                               seed=args.seed)
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.prompt),
          "prompt ids under the vocabulary")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in _counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    sch = serve.run_scheduler(model, params, reqs, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in _counters().items()}
    peak = torch.cuda.max_memory_allocated()
    done = {r.rid: r for r in sch.finished}
    check(sorted(done) == sorted(r.rid for r in reqs),
          f"[serve-ssm] {len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        check(len(done[r.rid].out) == r.max_new,
              f"[serve-ssm] request {r.rid}: {len(done[r.rid].out)} "
              f"tokens, expected {r.max_new}")
    prefills, steps = sch.stats["prefills"], sch.stats["decode_steps"]
    check(launches["ssm_scan"] == 64 * prefills,
          f"[serve-ssm] ssm_scan launched {launches['ssm_scan']} times, "
          f"expected 64 layers x {prefills} prefills")
    check(all(n == 0 for k, n in launches.items() if k != "ssm_scan"),
          f"[serve-ssm] other kernels launched: {launches}")
    check(not sch.layout.uses_pages and sch.pool.used_pages == 0
          and sch.pool.total_allocs == 0, "[serve-ssm] the page pool was "
          "touched")
    state = sch.cache[0]["b0"]
    check(state["conv"].dtype == torch.bfloat16
          and state["ssm"].dtype == torch.float32
          and tuple(state["ssm"].shape) == (64, 16, SSM_E, SSM_N),
          f"[serve-ssm] slot state {state['conv'].dtype} "
          f"{state['ssm'].dtype} {tuple(state['ssm'].shape)}")
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    s = sch.latency_summary()
    decode_s = sum(sch.stats["step_walls"])
    decode_tokens = s["tokens"] - len(reqs)
    rec = {
        "requests": len(reqs), "tokens": s["tokens"], "wall_s": wall,
        "init_s": init_s, "params": n_params,
        "tokens_per_s": s["tokens"] / wall,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_steps": steps, "step_ms": decode_s / steps * 1e3,
        "bursts": len(sch.stats["step_walls"]), "prefills": prefills,
        "launches": launches, "peak_bytes": peak, "before_bytes": before,
        "slot_state_bytes": state_bytes,
        **{k: s[k] for k in ("p50_token_latency_s", "p95_token_latency_s",
                             "p50_ttft_s", "p95_ttft_s")},
    }
    print(f"[serve-ssm] falcon-mamba-7b x64 ({n_params} params, f32, init "
          f"{init_s:.1f} s): {len(reqs)} requests, {s['tokens']} tokens in "
          f"{wall:.3f} s ({rec['tokens_per_s']:.1f} tok/s); decode "
          f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f} s "
          f"({rec['decode_tokens_per_s']:.1f} tok/s, {rec['step_ms']:.3f} "
          f"ms/step); {prefills} prefills; ssm_scan launches "
          f"{launches['ssm_scan']} = 64 x {prefills}; pool untouched "
          f"[{smi}]")
    print(f"[serve-ssm] inter-token p50 {s['p50_token_latency_s'] * 1e3:.3f}"
          f" ms p95 {s['p95_token_latency_s'] * 1e3:.3f} ms; TTFT p50 "
          f"{s['p50_ttft_s'] * 1e3:.1f} ms p95 {s['p95_ttft_s'] * 1e3:.1f} "
          f"ms; slot state {state_bytes} B for 16 slots; peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} B), of which {before / 2**20:.1f}"
          f" MiB were allocated before the run [{smi}]")
    del sch, state
    torch.cuda.empty_cache()
    rec["profile"] = phase_serve_profile(smi, model, params, reqs, FM_ARGS,
                                         "serve-ssm-profile",
                                         "profile_serve_ssm.txt")
    rec["routes"] = phase_prefill_routes(
        smi, model, params, [reqs[0].prompt, reqs[3].prompt],
        "prefill-routes falcon-mamba", 7)
    del model, params
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# state across steps: the overlap pipeline, checkpoints, elastic membership
# ---------------------------------------------------------------------------

CNN_STATE_STEPS = 6
# two leaves at step 2 (the seeded victim w0, and w5), two at step 4 (the
# seeded w2, and w6), one join at step 6: W runs 8 -> 6 -> 4 -> 5
ELASTIC_SCHEDULE = {"seed": 0, "events": [
    {"step": 2, "kind": "leave"}, {"step": 2, "kind": "leave",
                                   "worker": "w5"},
    {"step": 4, "kind": "leave"}, {"step": 4, "kind": "leave",
                                   "worker": "w6"},
    {"step": 6, "kind": "join", "count": 1}]}
ELASTIC_STEPS = 8
ELASTIC_W = [8, 8, 6, 6, 4, 4, 5, 5]
DENSE_STEPS = (6,)    # the joiner's dense window: B3 does not launch


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _bitwise(a, b) -> bool:
    """Two trees (tensors, host ints, numpy counters) equal bit for bit."""
    import numpy as np
    from repro_torch import tree as T
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor)
        else bool(np.array_equal(x, y)) for x, y in zip(la, lb))


def _step_ms(hist) -> float:
    """Median host-clock step of steps 2.. (metrics fetched every step)."""
    walls = [h["wall_s"] for h in hist]
    return statistics.median(b - a for a, b in zip(walls[1:], walls[2:])) \
        * 1e3


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN picks deterministic algorithms: equal inputs, equal grads."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def _scratch_dir(need: int):
    """A temporary directory for a checkpoint of ``need`` bytes, under the
    system's temporary directory or the checkout's ``build/``, whichever
    has more room; removed with everything in it afterwards."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    root = max((Path(tempfile.gettempdir()), ROOT / "build"),
               key=lambda p: shutil.disk_usage(p).free)
    free = shutil.disk_usage(root).free
    check(free > 1.2 * need, f"{free} B free under {root}; the checkpoint "
          f"needs {need}")
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        yield Path(tmp)


def _cnn_twin(steps: int = CNN_STATE_STEPS, start: int = 0,
              device: str = "cuda", **kw):
    """dc_s3gd through the example twin's build (§IV-A recipe for
    ``steps``, fused tail, 4 buckets, W = 8) on ResNet-18's layout, or on
    the example's reduced ResNet when ``device`` is the CPU."""
    from repro_torch.examples import cnn_paper_repro as twin
    net = dict(net=RESNET18, image_size=CNN_IMAGE,
               per_worker=CNN_PER_WORKER) if device == "cuda" else {}
    return twin.build("dc_s3gd", twin.recipe(CNN_W, steps), CNN_W, steps,
                      device=device, start=start, use_kernels=True,
                      buckets=N_BUCKETS, **net, **kw)


def phase_cnn_state(smi: str) -> dict:
    """ResNet-18's layout, W = 8, dc_s3gd, 4 buckets, fused tail, TF32 off,
    under cudnn.deterministic.  Overlap against inline, 6 steps each, in
    turns (inline, overlap, overlap, inline): bitwise in params, m,
    delta_prev and losses, A1/A2 once per bucket and step; a checkpoint
    at step 3 restored into a fresh state and run to step 6, bitwise the
    uninterrupted run; the elastic resume 8 -> 6 from that checkpoint
    (eval_params bitwise, 2 finite steps).  Every kernel count is set to 0
    just before a run and read just after it."""
    from repro_torch.cluster import rebuild_algorithm
    from repro_torch.launch.engine import Engine
    rec = {"inline": [], "overlap": []}
    first = {}
    with _cudnn_deterministic():
        for overlap in (False, True, True, False):
            tag = "overlap" if overlap else "inline"
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            model, alg, state, batch_fn, _ = _cnn_twin(overlap=overlap)
            state, hist, _ = Engine(model, alg).fit(
                state, batch_fn, steps=CNN_STATE_STEPS, log_every=1)
            torch.cuda.synchronize()
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            losses = [h["loss"] for h in hist]
            check(all(map(math.isfinite, losses)), f"[state] {tag}: {losses}")
            for name, n in launches.items():
                want = CNN_STATE_STEPS * len(CNN_BUCKETS) \
                    if name in ("dc_norms", "dc_fused_update") else 0
                check(n == want, f"[state] {tag}: {name} launched {n} "
                      f"times, expected {want}")
            landed = state.comm.get("pipeline", {}).get("reduced", [])
            run = {"step_ms": _step_ms(hist), "peak_bytes": peak,
                   "allocated_before": before, "losses": losses,
                   "launches": launches,
                   "pipeline_bytes": sum(x.numel() * x.element_size()
                                         for x in landed)}
            rec[tag].append(run)
            print(f"[state] CNN {tag}: step {run['step_ms']:.3f} ms (median "
                  f"of steps 2-5), peak {peak / 2**30:.3f} GiB ({peak} B; "
                  f"{before / 2**20:.1f} MiB before), comm['pipeline'] "
                  f"{run['pipeline_bytes']} B; launches {launches} [{smi}]")
            first.setdefault(overlap, (state, losses))
            del state, alg, model, batch_fn
        (inline, l_in), (piped, l_pipe) = first[False], first[True]
        for what in ("params", "opt"):
            check(_bitwise(getattr(inline, what), getattr(piped, what)),
                  f"[state] CNN overlap != inline in {what}")
        check(_bitwise(inline.comm["delta_prev"], piped.comm["delta_prev"])
              and l_in == l_pipe, "[state] CNN overlap != inline")
        print(f"[state] CNN overlap == inline, bitwise (params, m, "
              f"delta_prev, losses) over {CNN_STATE_STEPS} steps [{smi}]")
        del piped, first

        model, alg, state, batch_fn, _ = _cnn_twin()
        engine = Engine(model, alg)
        half, _, _ = engine.fit(state, batch_fn, steps=3, log_every=1)
        del state
        with _scratch_dir(2 * 2**30) as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = engine.save(tmp / "cnn_w8.npz", half, step=3)
            save_s = time.perf_counter() - t0
            nbytes = path.stat().st_size
            model, alg, fresh, batch_fn, _ = _cnn_twin(start=3)
            engine = Engine(model, alg)
            t0 = time.perf_counter()
            restored = engine.restore(path, fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            del fresh
            check(_bitwise(restored, half), "[state] CNN restore != saved")
            resumed, hist, _ = engine.fit(restored, batch_fn,
                                          steps=CNN_STATE_STEPS, start=3,
                                          log_every=1)
            check([h["step"] for h in hist] == [3, 4, 5]
                  and _bitwise(resumed, inline),
                  "[state] CNN resumed at step 3 != uninterrupted")
            print(f"[state] CNN checkpoint at step 3: {nbytes} B, save "
                  f"{save_s:.3f} s, restore {restore_s:.3f} s; steps 3-5 "
                  f"resumed == uninterrupted, bitwise [{smi}]")
            del resumed, restored, inline, half

            # elastic resume: the checkpoint's W = 8 resharded to 6
            model, alg8, fresh, batch_fn, _ = _cnn_twin(start=3)
            restored = Engine(model, alg8).restore(path, fresh)
            del fresh
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resized = alg8.resize_state(restored, 6)
            alg6 = rebuild_algorithm(alg8, 6)
            torch.cuda.synchronize()
            resize_s = time.perf_counter() - t0
            check(_bitwise(alg8.eval_params(restored),
                           alg6.eval_params(resized)),
                  "[state] CNN eval_params changed across the 8 -> 6 resize")
            del restored
            state6, hist6, _ = Engine(model, alg6).fit(
                resized, lambda it: batch_fn(it, 6), steps=5, start=3,
                log_every=1)
            losses6 = [h["loss"] for h in hist6]
            check(len(losses6) == 2 and all(map(math.isfinite, losses6)),
                  f"[state] CNN after the elastic resume: {losses6}")
            print(f"[state] CNN elastic resume 8 -> 6: resize "
                  f"{resize_s:.3f} s, eval_params bitwise, losses {losses6} "
                  f"[{smi}]")
            del state6, resized
    rec.update(ckpt_bytes=nbytes, save_s=save_s, restore_s=restore_s,
               resize_s=resize_s, resumed_losses=losses6)
    torch.cuda.empty_cache()
    return rec


def phase_cnn_elastic(smi: str) -> dict:
    """A live elastic run on ResNet-18's layout over topk 1 % with a
    one-step dense window after the join, W = 8 -> 6 -> 4 -> 5 over 8
    steps (``ELASTIC_SCHEDULE``): eval_params bitwise across each
    transition, the residual's mass per bucket conserved within
    W·2^-24·Σ|r|, every residual exactly 0 after the dense step, A1/A2
    once per bucket and step at each W and B3 once per bucket outside the
    window, and the transition log equal to the one the port computes on
    the CPU (the example's reduced ResNet) for the same schedule and seed.
    The counts are set to 0 just before the run and read before each step
    and after the last."""
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch.engine import Engine

    def mass(state):
        return [(float(r.double().sum()),
                 r.shape[0] * 2.0 ** -24 * float(r.double().abs().sum()))
                for r in state.comm["reducer"]["residual"]]

    class Watched(Membership):
        """Checks each transition and records the counts before each
        step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.snaps, self.worst = [], 0.0

        def poll(self, step):
            torch.cuda.synchronize()
            self.snaps.append(_read_counts())
            return super().poll(step)

        def apply(self, events, state, *, step):
            if any(ev.kind == "dense_end" for ev in events):
                check(not any(bool(r.any()) for r in
                              state.comm["reducer"]["residual"]),
                      f"[elastic] residual not 0 after the dense step "
                      f"{step - 1}")
            alg, pre = self.alg, self.alg.eval_params(state)
            pre_mass = mass(state)
            state, changed = super().apply(events, state, step=step)
            if self.alg.n_workers != alg.n_workers:
                check(_bitwise(pre, self.alg.eval_params(state)),
                      f"[elastic] eval_params changed at step {step}")
                for (a, bound), (b, _) in zip(pre_mass, mass(state)):
                    check(abs(a - b) <= bound, f"[elastic] residual mass "
                          f"{a} -> {b} at step {step} (bound {bound})")
                    self.worst = max(self.worst, abs(a - b) / bound
                                     if bound else 0.0)
            return state, changed

    model, alg, state, batch_fn, _ = _cnn_twin(ELASTIC_STEPS,
                                               reducer="topk")
    ms = Watched(alg, faults=FaultSchedule.from_json(ELASTIC_SCHEDULE),
                 dense_after_join=1)
    _zero_counts()
    t0 = time.perf_counter()
    state, hist, _ = Engine(model, alg).fit(state, batch_fn,
                                            steps=ELASTIC_STEPS, log_every=1,
                                            membership=ms)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snaps = ms.snaps + [_read_counts()]
    per_step = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps,
                                                            snaps[1:])]
    workers = [h["n_workers"] for h in hist]
    check(workers == ELASTIC_W, f"[elastic] W per step {workers}")
    check(all(math.isfinite(h["loss"]) for h in hist), "[elastic] losses")
    nb = len(CNN_BUCKETS)
    for it, c in enumerate(per_step):
        want = {"dc_norms": nb, "dc_fused_update": nb,
                "select_ef_mean": 0 if it in DENSE_STEPS else nb}
        for name, n in c.items():
            check(n == want.get(name, 0), f"[elastic] step {it} (W="
                  f"{workers[it]}): {name} launched {n} times, expected "
                  f"{want.get(name, 0)}")
    check(any(bool(r.any()) for r in state.comm["reducer"]["residual"]),
          "[elastic] no residual after the window: compression did not "
          "resume")
    for it, c in enumerate(per_step):
        print(f"[elastic] step {it} W={workers[it]}: dc_norms "
              f"{c['dc_norms']}, dc_fused_update {c['dc_fused_update']}, "
              f"select_ef_mean {c['select_ef_mean']}, loss "
              f"{hist[it]['loss']:.6f}")
    log = ms.log
    del state, alg, model, batch_fn
    torch.cuda.empty_cache()

    # the same schedule and seed on the CPU, on the example's reduced net
    model, alg, state, batch_fn, _ = _cnn_twin(ELASTIC_STEPS, device="cpu",
                                               reducer="topk")
    cpu = Membership(alg, faults=FaultSchedule.from_json(ELASTIC_SCHEDULE),
                     dense_after_join=1)
    Engine(model, alg).fit(state, batch_fn, steps=ELASTIC_STEPS,
                           log_every=ELASTIC_STEPS, membership=cpu)
    check(log == cpu.log, f"[elastic] transition log {log} != the CPU's "
          f"{cpu.log}")
    print(f"[elastic] transitions (== the CPU run's, dict for dict): "
          f"{json.dumps(log)}")
    print(f"[elastic] 8 steps, W {workers}, in {secs:.3f} s; eval_params "
          f"bitwise across every transition; worst residual mass change "
          f"{ms.worst:.3g} of its one-rounding bound; residual 0 after the "
          f"dense step [{smi}]")
    return {"W": workers, "per_step_launches": per_step, "log": log,
            "s": secs, "mass_worst": ms.worst,
            "losses": [h["loss"] for h in hist]}


def phase_qwen3_state(smi: str, requests: Path) -> dict:
    """qwen3-0.6b, depth 4, W = 2 (the main path's configuration).  3
    steps over topk 1 % inline and with --overlap, under PyTorch's
    deterministic algorithms (the embedding's backward accumulates with
    atomics otherwise): bitwise in params, m, delta_prev and losses, A1
    and A2 once per bucket and step, B3 once per bucket and reduce (one
    reduce more under overlap: the priming issue in init).  Then the main
    path (3 steps) with --ckpt, served through ``repro_torch.launch.serve
    --layers 4 --train-ckpt ... --paged-kernel`` for 4 of the serve
    requests: greedy tokens equal to serving eval_params of the in-memory
    state, B4 and B5 launched 4 layers x decode steps and x prefills.
    The checkpoint is written under a temporary directory and deleted."""
    from repro_torch.launch import serve, train
    from repro_torch.launch.engine import algorithm_for_checkpoint
    rec = {}
    kept = None
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for overlap in (False, True):
            tag = "overlap" if overlap else "inline"
            args = train.build_argparser().parse_args(
                MAIN_ARGS + ["--steps", "3", "--use-kernels", *COMPRESSED]
                + (["--overlap"] if overlap else []))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = train.run(args)
            torch.cuda.synchronize()
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            losses = [h["loss"] for h in result["history"]]
            check(all(map(math.isfinite, losses)), f"[state] qwen3 {tag}")
            # the tail once per bucket and step; topk's reduce too, and
            # under overlap once more: init primes the pipeline, and the
            # issue at the end of step 2 is the reduce step 3 would consume
            wants = {"dc_norms": 3 * N_BUCKETS,
                     "dc_fused_update": 3 * N_BUCKETS,
                     "select_ef_mean": (3 + overlap) * N_BUCKETS}
            for name, n in launches.items():
                check(n == wants.get(name, 0), f"[state] qwen3 {tag}: "
                      f"{name} launched {n} times, expected "
                      f"{wants.get(name, 0)}")
            nondet = sorted({str(w.message)[:120] for w in caught
                             if "determinis" in str(w.message)})
            st = result.pop("state")
            walls = [h["wall_s"] for h in result["history"]]
            rec[tag] = {"step2_ms": (walls[2] - walls[1]) * 1e3,
                        "peak_bytes": peak, "allocated_before": before,
                        "losses": losses, "launches": launches,
                        "nondeterministic": nondet}
            print(f"[state] qwen3 {tag} (topk 1 %): step 2 "
                  f"{rec[tag]['step2_ms']:.3f} ms, peak {peak / 2**30:.3f} "
                  f"GiB ({before / 2**30:.3f} GiB allocated before), "
                  f"losses {losses}, launches {launches}; "
                  f"nondeterministic-op warnings {nondet} [{smi}]")
            if not overlap:
                # held through the overlap run: its peak counts them
                kept = (st.params, st.opt, st.comm["delta_prev"], losses)
            else:
                for a, b, what in zip(kept, (st.params, st.opt,
                                             st.comm["delta_prev"], losses),
                                      ("params", "m", "delta_prev",
                                       "losses")):
                    check(_bitwise(a, b) if what != "losses" else a == b,
                          f"[state] qwen3 overlap != inline in {what}")
            del st, result
        print(f"[state] qwen3 overlap == inline over topk 1 %, bitwise "
              f"(params, m, delta_prev, losses; deterministic algorithms) "
              f"[{smi}]")
    finally:
        torch.use_deterministic_algorithms(False)
    del kept
    torch.cuda.empty_cache()

    with _scratch_dir(10 * 2**30) as tmp:
        ckpt = tmp / "qwen3_w2.npz"
        args = train.build_argparser().parse_args(
            MAIN_ARGS + ["--steps", "3", "--use-kernels", "--ckpt",
                         str(ckpt)])
        result = train.run(args)
        alg, _ = algorithm_for_checkpoint(ckpt)
        mem_params = alg.eval_params(result.pop("state"))
        rec["ckpt"] = result["ckpt"]
        del result
        torch.cuda.empty_cache()
        sargs = serve.build_argparser().parse_args(
            SERVE_ARGS + ["--layers", "4", "--train-ckpt", str(ckpt),
                          "--requests", str(requests), "--paged-kernel"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, params, _ = serve.build(sargs)
        torch.cuda.synchronize()
        rec["ckpt"]["serve_load_s"] = time.perf_counter() - t0
    check(_bitwise(params, mem_params),
          "[state] served weights != eval_params of the in-memory state")
    outs = {}
    for name, p in (("checkpoint", params), ("in-memory", mem_params)):
        # fresh requests each run: the scheduler fills their outputs
        reqs = serve.load_requests(sargs.requests, model.cfg.vocab_size,
                                   sargs.gen, seed=sargs.seed)[:4]
        _zero_counts()
        sch = serve.run_scheduler(model, p, reqs, sargs)
        torch.cuda.synchronize()
        launches = _read_counts()
        steps, prefills = sch.stats["decode_steps"], sch.stats["prefills"]
        check(launches["paged_attention"] == 4 * steps
              and launches["flash_attention"] == 4 * prefills,
              f"[serve-ckpt] {name}: {launches}, {steps} decode steps, "
              f"{prefills} prefills")
        outs[name] = {r.rid: r.out for r in sch.finished}
        check(sorted(outs[name]) == [r.rid for r in reqs]
              and all(len(outs[name][r.rid]) == r.max_new for r in reqs),
              f"[serve-ckpt] {name}: requests unfinished")
        print(f"[serve-ckpt] {name} weights: paged_attention "
              f"{launches['paged_attention']} = 4 x {steps} decode steps, "
              f"flash_attention {launches['flash_attention']} = 4 x "
              f"{prefills} prefills [{smi}]")
        del sch
    check(outs["checkpoint"] == outs["in-memory"],
          "[serve-ckpt] tokens served from the checkpoint differ")
    c = rec["ckpt"]
    print(f"[state] qwen3 x4 W=2 checkpoint: {c['bytes']} B, save "
          f"{c['save_s']:.3f} s, serve --train-ckpt load (template, read, "
          f"eval_params) {c['serve_load_s']:.3f} s; 4 requests' greedy "
          f"tokens equal to serving eval_params in memory [{smi}]")
    del model, params, mem_params
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import init_resnet
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
    threshold_ms = kern["select_ef_mean"].pop("threshold_ms")
    launches, step_s, peak = phase_main(smi)
    c_launches, c_step_s, c_peak = phase_main(smi, COMPRESSED, "compressed")
    launches["select_ef_mean"] = c_launches["select_ef_mean"]
    others = phase_others(smi)
    worst = phase_fused_vs_unfused(smi)
    torch.cuda.empty_cache()
    prof = phase_profile(smi)
    torch.cuda.empty_cache()
    c_prof = phase_profile(smi, COMPRESSED, "profile_compressed")
    torch.cuda.empty_cache()

    t_cnn = time.perf_counter()
    cnn_params = init_resnet(torch.Generator(device="cuda").manual_seed(0),
                             **RESNET18)
    cnn_plan = plan_buckets(cnn_params, N_BUCKETS)
    n_cnn = sum(x.numel() for x in T.leaves(cnn_params))
    check(n_cnn == CNN_PARAMS and len(T.leaves(cnn_params)) == 29,
          f"ResNet-18 layout: {n_cnn} params")
    del cnn_params
    check(cnn_plan.bucket_sizes == CNN_BUCKETS,
          f"CNN bucket sizes {cnn_plan.bucket_sizes}")
    check(cnn_plan.bucket_decay == (True,) * 5 + (False,), "CNN decay")
    print(f"[plan] ResNet-18 layout: {n_cnn} params in 29 leaves, buckets "
          f"{cnn_plan.bucket_sizes} decay {cnn_plan.bucket_decay}")
    cnn_kern = phase_kernels(cnn_plan.bucket_sizes, smi, W=CNN_W,
                             select=False, tag="kernels-cnn")
    cnn = phase_cnn_main(smi)
    cnn["fused_vs_unfused_worst"] = phase_cnn_fused_vs_unfused(smi)
    cnn["profile"] = phase_cnn_profile(smi)
    cnn["variants"] = phase_cnn_variants(smi)
    cnn["kernels"] = cnn_kern
    cnn["s"] = time.perf_counter() - t_cnn
    print(f"[cnn] the CNN phases took {cnn['s']:.1f} s [{smi}]")
    torch.cuda.empty_cache()

    paged = phase_paged_kernel(smi)
    flash = phase_flash_kernel(smi)
    scan = phase_ssm_kernel(smi)
    requests = _write_requests()
    served, (model, params), reqs = phase_serve(smi, requests,
                                                ["--paged-kernel"])
    launches["paged_attention"] = served["launches"]["paged_attention"]
    launches["flash_attention"] = served["launches"]["flash_attention"]
    served_int8, _, _ = phase_serve(smi, requests, ["--kv-dtype", "int8"],
                                    16, "serve-int8", (model, params, None))
    versus = phase_kernel_vs_gather(smi, model, params, reqs)
    # f32 attention outputs differ in summation order only (~1e-7
    # relative); 2^-10 of the largest logit leaves room for 28 layers
    q_routes = phase_prefill_routes(smi, model, params,
                                    [r.prompt for r in reqs[:4]],
                                    "prefill-routes qwen3", 10)
    s_prof = phase_serve_profile(smi, model, params, reqs)
    del model, params
    torch.cuda.empty_cache()
    fm = phase_serve_ssm(smi, requests)
    launches["ssm_scan"] = fm["launches"]["ssm_scan"]
    torch.cuda.empty_cache()

    state = {}
    for name, phase in (("cnn", lambda: phase_cnn_state(smi)),
                        ("elastic", lambda: phase_cnn_elastic(smi)),
                        ("qwen3", lambda: phase_qwen3_state(smi, requests))):
        t0 = time.perf_counter()
        state[name] = phase()
        state[name]["phase_s"] = time.perf_counter() - t0
        print(f"[state] phase {name} took {state[name]['phase_s']:.1f} s "
              f"[{smi}]")
    state["s"] = sum(state[k]["phase_s"] for k in ("cnn", "elastic",
                                                   "qwen3"))
    print(f"[state] the state-across-steps phases took {state['s']:.1f} s "
          f"[{smi}]")
    bf16 = paged["bfloat16"]
    kern["paged_attention"] = {"ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
                               "bound_ms": bf16["bound_ms"],
                               "err": max(paged[p]["err"] for p in PA_POOLS)}
    # per launch, averaged over the path's four prompt lengths (each is a
    # quarter of the prefills); the error is the worst of every case
    for name, cases, path in (
            ("flash_attention", flash,
             [f"S={S} f32" for S in PROMPT_LENS]),
            ("ssm_scan", scan, [f"S={S}" for S in PROMPT_LENS])):
        k = {f: statistics.mean(cases[c][f] for c in path)
             for f in ("ms", "plain_ms", "bound_ms")}
        k["err"] = max(r["err"] for r in cases.values() if "err" in r)
        k["bound_by"] = cases[path[-1]]["bound_by"]
        k["library_ms"] = statistics.mean(cases[c]["library_ms"]
                                          for c in path) \
            if name == "flash_attention" else None
        kern[name] = k

    tokens = W * 4 * 256
    print(f"[times] step {step_s * 1e3:.3f} ms median of steps 2-5 "
          f"({tokens / step_s:.1f} tokens/s, W={W}, 4x256 tokens/worker, 4 "
          f"layers, metrics fetched every step) [{smi}]")
    for name, k in kern.items():
        if name in ("paged_attention", "flash_attention", "ssm_scan"):
            continue
        print(f"[times] {name}: {k['ms']:.4f} ms per step ({N_BUCKETS} "
              f"launches), plain {k['plain_ms']:.4f} ms, byte bound "
              f"{k['bound_ms']:.4f} ms [{smi}]")
    print(f"[times] peak memory {peak / 2**30:.3f} GiB "
          f"({peak} B) [{smi}]")
    for name in ("dc_norms", "dc_fused_update"):
        k = cnn_kern[name]
        print(f"[times] {name} on the CNN: {k['ms']:.4f} ms per step "
              f"({len(CNN_BUCKETS)} launches, W={CNN_W}), plain "
              f"{k['plain_ms']:.4f} ms, byte bound {k['bound_ms']:.4f} ms "
              f"[{smi}]")
    for algo in ("dc_s3gd", "stale", "ssgd"):
        c = cnn[algo]
        print(f"[times] ResNet-18 layout {algo}: step {c['step_ms']:.3f} ms, "
              f"{c['images_per_s']:.1f} images/s (W={CNN_W}, "
              f"{CNN_PER_WORKER} images/worker), peak "
              f"{c['peak_bytes'] / 2**30:.3f} GiB [{smi}]")
    print(f"[times] compressed (topk 1%) step {c_step_s * 1e3:.3f} ms median "
          f"of steps 2-5 ({tokens / c_step_s:.1f} tokens/s); peak memory "
          f"{c_peak / 2**30:.3f} GiB ({c_peak} B); magnitude_threshold "
          f"{threshold_ms:.4f} ms per step alone [{smi}]")
    print(f"[times] serve qwen3-0.6b x28, 16 slots, bf16 KV, paged kernel: "
          f"{served['decode_tokens_per_s']:.1f} decode tok/s, "
          f"{served['step_ms']:.3f} ms/decode step, inter-token p50/p95 "
          f"{served['p50_token_latency_s'] * 1e3:.3f}/"
          f"{served['p95_token_latency_s'] * 1e3:.3f} ms, TTFT p50/p95 "
          f"{served['p50_ttft_s'] * 1e3:.1f}/{served['p95_ttft_s'] * 1e3:.1f}"
          f" ms, peak {served['peak_bytes'] / 2**30:.3f} GiB; paged_attention"
          f" {bf16['ms']:.4f} ms/launch (bound {bf16['bound_ms']:.4f}, plain "
          f"{bf16['plain_ms']:.4f}) [{smi}]")

    for name, what in (("flash_attention", "qwen3 prefill, B=1"),
                       ("ssm_scan", "falcon-mamba prefill, B=1, E=8192")):
        k = kern[name]
        lib = "" if k["library_ms"] is None \
            else f", sdpa {k['library_ms']:.4f}"
        print(f"[times] {name} ({what}, mean over S 128/256/384/512): "
              f"{k['ms']:.4f} ms/launch, plain {k['plain_ms']:.4f}{lib}, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}; "
              f"{launches[name]} launches on its serve path [{smi}]")
    bf = [flash[f"S={S} bf16"] for S in PROMPT_LENS]
    print(f"[times] flash_attention bf16 (qwen3 prefill shape, mean over S "
          f"128/256/384/512): "
          f"{statistics.mean(r['ms'] for r in bf):.4f} ms/launch, plain "
          f"{statistics.mean(r['plain_ms'] for r in bf):.4f}, sdpa "
          f"{statistics.mean(r['library_ms'] for r in bf):.4f}, bound "
          f"{statistics.mean(r['bound_ms'] for r in bf):.4f} ms [{smi}]")
    print(f"[times] serve falcon-mamba-7b x64, 16 slots: "
          f"{fm['decode_tokens_per_s']:.1f} decode tok/s, "
          f"{fm['step_ms']:.3f} ms/decode step, inter-token p50/p95 "
          f"{fm['p50_token_latency_s'] * 1e3:.3f}/"
          f"{fm['p95_token_latency_s'] * 1e3:.3f} ms, TTFT p50/p95 "
          f"{fm['p50_ttft_s'] * 1e3:.1f}/{fm['p95_ttft_s'] * 1e3:.1f} ms, "
          f"peak {fm['peak_bytes'] / 2**30:.3f} GiB [{smi}]")

    sources = {"dc_norms": "dc_update.cu", "dc_fused_update": "dc_update.cu",
               "select_ef_mean": "compress.cu",
               "paged_attention": "paged_attention.cu",
               "flash_attention": "flash_attention.cu",
               "ssm_scan": "ssm_scan.cu"}
    replaces = {"dc_norms": "src/repro/kernels/dc_update.py:58",
                "dc_fused_update": "src/repro/kernels/dc_update.py:126",
                "select_ef_mean": "src/repro/kernels/compress.py:80",
                "paged_attention": "src/repro/kernels/paged_attention.py:159",
                "flash_attention": "src/repro/kernels/flash_attention.py:115",
                "ssm_scan": "src/repro/kernels/ssm_scan.py:88"}
    check(set(kern) == set(sources), f"kernels {sorted(kern)}")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k.get("bound_by", "bytes"),
        "library_ms": k.get("library_ms"),
    } for name, k in kern.items()]
    for entry in kernels:
        # A1 and A2 on the CNN main path: its launches (dc_s3gd, 6 steps)
        # and the per-step sums over its 6 bucket sizes at W = 8
        if entry["name"] in cnn_kern:
            k = cnn_kern[entry["name"]]
            entry["cnn"] = {
                "launches": cnn["dc_s3gd"]["launches"][entry["name"]],
                "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes"}
    record = {"card": smi, "step_ms": step_s * 1e3, "peak_bytes": peak,
              "compressed_step_ms": c_step_s * 1e3,
              "compressed_peak_bytes": c_peak,
              "threshold_ms": threshold_ms, "others_s": others,
              "fused_vs_unfused_worst": worst, "profile": prof,
              "profile_compressed": c_prof, "paged_attention": paged,
              "serve": served, "serve_int8": served_int8,
              "kernel_vs_gather": versus, "profile_serve": s_prof,
              "flash_attention": flash, "ssm_scan": scan,
              "prefill_routes_qwen3": q_routes, "serve_ssm": fm,
              "cnn": cnn, "state": state,
              "kernels": kernels}
    record["total_s"] = time.perf_counter() - t_start
    print(f"[times] chip_smoke.py: {record['total_s']:.1f} s, the build "
          f"included [{smi}]")
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

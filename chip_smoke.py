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
   (atol 2e-5) and bf16 (3e-2 x min(1, max|out|))), a windowed and a
   ragged Sq != Sk case,
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
12. the rest of serving and of the dense family (the B5 / B4 shapes run
   after phase 9's kernels, the prefix phase after phase 8's profile, the
   dense family last).  flash_attention against its plain version at a
   qwen3 chunk (128 rows at q_start 512 over 656 keys), stablelm-3b's hd
   80 and granite-20b's G 48 (f32 2e-5, bf16 3e-2 x min(1, max|out|)),
   timed beside bound,
   plain version and SDPA, and one call's rows bitwise equal to the same
   rows split over two calls at other q_starts; paged_attention at hd 80
   (G 1, 32 kv heads) and G 48 (one kv head), four pool dtypes, held to
   its plain version in float64 (1e-6 / 2e-5) and timed.  qwen3-0.6b at
   full depth over 32 requests behind one 392-token system prompt
   (request 0 first, then 31 together) through ``repro_torch.launch.
   serve``'s scheduler with ``--prefill-chunk 128 --prefix-cache``: greedy
   tokens bitwise the cold chunked run's, >= 31 hits, >= 1 copy-on-write,
   fewer pages than cold, B5 at q_start > 0 (28 per chunk), B4 28 per
   decode step, last-chunk logits within 2^-5 of the whole-prompt
   prefill's largest logit, TTFT / inter-token latency beside the
   whole-prompt run, a 120-page pool that preempts and finishes every
   request; the chunk route against its plain route (2^-7).
   stablelm-3b at full depth (32 layers, 2,796,098,560 params) serves 16
   requests whole-prompt and chunked (B4 / B5 32 per step / prefill or
   chunk), routes checked, and trains two dc_s3gd steps at depth 4, W =
   2, fused tail, with A1/A2 held against their plain versions at its
   bucket sizes; granite-20b cut to 12 of 52 layers serves 8 requests.
   B4 at stablelm-3b's and granite-20b's shapes is also timed beside
   gather of the live pages + scaled_dot_product_attention (bf16 pools);
13. the recurrent families.  flash_attention against its plain
   version at recurrentgemma-9b's local attention (one kv head, G 16, hd
   256, window 2,048) at S 512 / 2,048 / 4,096, f32 (2e-5) and bf16
   (3e-2 x min(1, max|out|)), bitwise run to run, timed (12 launches
   per sample, one per attention_local block) beside its bound, the plain version and
   scaled_dot_product_attention with the boolean window mask.
   recurrentgemma-9b at its published widths and full depth (38 layers,
   10,444,771,328 params, f32 weights from seed 0, bf16 compute) through
   ``repro_torch.launch.serve`` over 16 requests (prompts 512 / 2,040 /
   2,560 / 4,096, gen 32..64 from seed 0; ``--slots 8 --decode-burst 4``,
   greedy, whole-prompt): every request at its length, B5 12 times per
   prefill and nothing else, the pool untouched, the slot state (rings
   of 2,048, RG-LRU) at its shapes; 0 host syncs in a steady burst, two
   bursts profiled; slot decode == dense decode bitwise over 16 steps
   past the ring's wrap; the prefill's kernel route against its plain
   route (2^-10).  falcon-mamba-7b trained at its published widths, depth
   64 -> 1, W = 2, dc_s3gd, 4 buckets, fused tail, 5 steps through the
   chunked scan (finite losses, A1/A2 once per bucket and step, step time,
   peak), A1/A2 against their plain versions at its bucket sizes, the
   chunked scan against ssm_scan_plain at E 8,192, N 16 (1e-4); reduced
   recurrentgemma trained 2 steps as a route check;
14. the MoE family and MLA.  paged_attention at olmoe-1b-7b's
   attention (16 kv heads, G 1, hd 128) and phi3.5-moe's (8, G 4),
   bf16 and f32 pools, held to its plain version in float64 (1e-6), and
   flash_attention there at S 512 (f32 2e-5, bf16 3e-2 x min(1,
   max|out|)), timed beside
   bound, plain version and SDPA.  olmoe-1b-7b at its published widths
   and full depth (16 layers, 6,919,624,704 params, f32 weights from seed
   0, bf16 compute and KV) over phase 8's 48 requests: B4 16 per decode
   step, B5 16 per prefill, the routed prefill and the dropless decode;
   the dropless FFN against the all-experts oracle at its widths (2^-16
   of the largest output); kernel route == plain route greedy on 4
   requests over f32 pools; 0 host syncs a burst, two bursts profiled.
   phi3.5-moe-42b-a6.6b cut to 8 of 32 layers (10,666,708,992 params)
   serves 8 requests (B4 / B5 at G 4).  olmoe cut to 1 layer trains 5
   routed dc_s3gd steps at W = 2 (80 slots per expert; finite losses and
   aux loss, A1/A2 once per bucket and step, step time, peak), A1/A2
   against their plain versions at its bucket sizes; minicpm3-4b cut to 2
   layers trains 2 steps.  minicpm3-4b at full depth (62 layers,
   4,262,025,728 params) on bf16 latent pages, 35,712 B a token beside
   qwen3's 114,688: 16 requests whole-prompt, 8 over int8 pools, two
   bursts profiled, then phase 12's 32 shared-prompt requests chunked
   (128) with and without the prefix cache, block tables 45 pages wide
   (greedy tokens bitwise, >= 31 hits, copy-on-write, fewer pages); B4
   and B5 never launch on its path (the prefix requests at 8 of its 62
   layers).  Then ROADMAP C5: reduced
   falcon-mamba-7b and
   recurrentgemma-9b prefill prompts of 1 and 2 tokens into the slot
   layout and decode 4 steps within 1e-5 of the whole-sequence forward;
15. the vlm and encdec families (last).  flash_attention at the new
   paths' shapes and batches: qwen2-vl-7b's causal prefill (4 kv heads,
   G 7, hd 128, 4 x 1,152 positions), whisper-large-v3's bidirectional
   encoder (20 kv heads, G 1, hd 64, 8 x 1,500 frames), its decoder's
   causal self-attention (8 x 64) and its cross-attention (8 x 64
   queries over 1,500 frames), f32 (2e-5) and bf16 (3e-2 x min(1,
   max|out|): an encoder's outputs are ~0.03), timed beside
   bound, plain version and SDPA; paged_attention at KV 4 G 7 hd 128 and
   KV 20 G 1 hd 64, bf16 and f32 pools, held to its plain version in
   float64 (1e-6).  qwen2-vl-7b at its published widths and full depth
   (28 layers, 7,628,332,544 params, f32 weights from seed 0, bf16
   compute) served one-shot through ``repro_torch.launch.serve`` (4
   prompts of 1,024 stub patches + 128 tokens, 32 generated, greedy: B5
   28 times), then the same batch through `PagedLayout` over f32 pools
   (B4 28 times a decode step): kernel route == plain route on every
   greedy token, 0 host syncs a step, two steps profiled.
   whisper-large-v3 (32 + 32 layers, 1,601,459,200 params) the same way
   (8 prompts of 64 tokens over 1,500 stub frames, 64 generated: B5 96
   times a prefill, 32 each bidirectional, causal and cross; B4 32 times
   a decode step), then the shares of the encoder pass in the prefill and
   of the 32 cross-attention reads in a decode step.  whisper cut to 8 +
   8 layers trains 3 dc_s3gd steps at W = 2 over batches with frames
   (A1/A2 once per bucket and step; step time, peak), A1/A2 against
   their plain versions at its bucket sizes (A2 bitwise); the reduced
   qwen2-vl trains 2 steps with patches and M-RoPE positions.

16. the analysis layer (last).  The roofline of one training step of the
   cell (qwen3-0.6b x4, W = 2, 4 x 256 tokens a worker, 4 buckets, fused
   tail) from ``Engine.trace_train_step`` on the H100's constants: FLOPs
   and bytes by group, the three terms and the bottleneck beside the
   measured median step and ``train_step_mfu``.  The lint passes
   (`repro_torch.analysis.lint`) at mean_allreduce and topk, inline and
   overlapped, and the int8 point on the same model: 0 findings, 0 host
   syncs under set_sync_debug_mode("error").  A1 / A2 on the cell's
   buckets padded to 2·BLOCK (A1 rtol 1e-5, A2 bitwise) and
   paged_attention at pages of 8, 16 and 32 over the same tokens (bf16
   and int8 pools, float64 plain version at 1e-6 / 2e-5, bitwise across
   the page sizes), timed beside bound and plain version.  The autotuner:
   8 train candidates and 12 serve candidates measured beside their
   predictions, tuned <= default ms/step, tuned >= default tokens/s,
   greedy tokens identical across the serve candidates; the blob in
   ``chiprun_out/autotune.json``.

The CPU twins of these checks are the ``tests/test_torch_*.py`` files
(``PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
tests/test_torch_mla.py``; the C5 cases: ``-k short_prompt`` in
``tests/test_torch_hybrid.py`` and ``tests/test_torch_ssm_serve.py``;
slice 12: ``tests/test_torch_vlm.py tests/test_torch_encdec.py``; slice
13: ``tests/test_torch_analysis.py tests/test_torch_autotune.py
tests/test_torch_lint.py``).

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


def _bound(cost: dict):
    """(bound_ms, bound_by, bytes, flops) of one launch, from the kernel's
    own cost function (the one its wrapper records in an op trace) priced
    by `repro_torch.analysis.roofline.kernel_bound`: the larger of the
    bytes over HBM and the FLOPs at the peak of their type."""
    from repro_torch.analysis.roofline import kernel_bound
    ms, by = kernel_bound(cost)
    return (ms, by, cost["bytes_read"] + cost["bytes_written"],
            cost.get("dot_flops", 0) + cost.get("flops", 0))


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
        bound, by = _bound(K.dc_norms_cost(g, d))[:2]
        acc["dc_norms"]["ms"] += k_ms
        acc["dc_norms"]["plain_ms"] += p_ms
        acc["dc_norms"]["bound_ms"] += bound
        acc["dc_norms"].setdefault("per_launch", []).append(
            {"n": n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound})
        print(f"[{tag}] dc_norms n={n} W={W}: {k_ms:.4f} ms/launch "
              f"(plain {p_ms:.4f} ms, bound {bound:.4f} ms by {by}, max rel "
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
            bound, by = _bound(K.dc_fused_update_cost(g, d, m, ww,
                                                      lam=lam))[:2]
            print(f"[{tag}] dc_fused_update n={n} W={W} w={wt}: "
                  f"{k_ms:.4f} ms/launch (plain {p_ms:.4f} ms, bound "
                  f"{bound:.4f} ms by {by}, max abs err {err:.3g}) [{smi}]")
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
        bound = _bound(KC.select_ef_mean_cost(
            a, t, comm_dtype=torch.float32, union=False))[0]
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
                      f"{p_ms:.4f} ms, bound {bound:.4f} ms, max abs "
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


def _paged_case(gen, pool: str, width: int, shape=PA_SHAPE):
    """q, pools of 641 pages, block tables, lengths and (quantized pools)
    scales at a serving shape (B, KV, G, hd), qwen3's by default.  Each
    row's live pages are distinct; the rest of its ``width``-wide table
    points at the scratch page 0, as the scheduler leaves it."""
    from repro_torch.models.cache import _quantize_tokens
    dev = torch.device("cuda")
    B, KV, G, hd = shape
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


def _layers(t: torch.Tensor, n: int = PA_LAYERS) -> torch.Tensor:
    """``n`` copies of one layer's pool, stacked as the serve step's
    ``(L, num_pages, ...)`` pool."""
    return t.unsqueeze(0).repeat((n,) + (1,) * t.dim())


def _rotating(fn, n: int = PA_LAYERS):
    """A no-argument call that runs ``fn(layer)`` on the next layer each
    time, cycling over ``n`` layers."""
    layers = itertools.cycle(range(n))
    return lambda: fn(next(layers))


def _gather_sdpa_ms(q, kL, vL, narrow, ln, layers: int, ref):
    """The library yardstick of paged_attention: no single PyTorch call
    reads pages through a block table, so gather each row's live pages
    (``narrow``, the live-width table), then one
    scaled_dot_product_attention call (q cast to the pool's dtype), timed
    as the kernel is, one launch on each of ``layers`` per-layer pools
    (``kL``, ``vL``) per sample.  Returns (ms per call pair, max abs diff
    from ``ref``)."""
    import torch.nn.functional as F
    B, KV, G, hd = q.shape
    btl = narrow.long()
    S = btl.shape[1] * PAGE
    mask = (torch.arange(S, device=q.device)[None, :]
            < ln[:, None].long())[:, None, None, :]

    def gather_sdpa(layer=0):
        kl = kL[layer][btl].reshape(B, S, KV, hd).transpose(1, 2)
        vl = vL[layer][btl].reshape(B, S, KV, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.reshape(B, KV * G, 1, hd).to(kl.dtype), kl, vl,
            attn_mask=mask, enable_gqa=True)
    err = float((gather_sdpa().float().reshape(ref.shape) - ref)
                .abs().max())
    return median_ms(_rotating(gather_sdpa, layers), batch=layers), err


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
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_cost,
                                                     splits_for)
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
        bound, by, nbytes, flops = _bound(paged_attention_cost(
            q, k, v, bt, ln, **kw))
        print(f"[paged] {pool} pools, B={B} KV={KV} G={G} hd={hd} page "
              f"{PAGE}, lengths 1..{max(PA_LENGTHS)} ({sum(PA_LENGTHS)} "
              f"live tokens): {wide_ms:.4f} ms/launch at width {PA_WIDTH}, "
              f"{narrow_ms:.4f} ms at width {PA_LIVE}; plain {plain_ms:.4f} "
              f"ms; bound {bound:.4f} ms by {by} ({nbytes} B; {flops} "
              f"flops); "
              f"max abs err {err:.3g} [{smi}]")
        check(abs(wide_ms - narrow_ms) <= 0.1 * narrow_ms,
              f"paged_attention {pool}: {wide_ms} ms at width {PA_WIDTH} "
              f"vs {narrow_ms} ms at width {PA_LIVE}: not within 10 %")
        rec[pool] = {"ms": wide_ms, "narrow_ms": narrow_ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "bytes": nbytes, "err": err}
        if pool == "bfloat16":
            rec[pool]["gather_sdpa_ms"], sdpa_err = _gather_sdpa_ms(
                q, kL, vL, narrow, ln, layers=PA_LAYERS,
                ref=paged_attention_plain(q, k, v, narrow, ln))
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
                tag: str = "serve", built=None, argv=SERVE_ARGS,
                depth: int = 28, attention_kernels: bool = True):
    """Serve the request file through ``repro_torch.launch.serve`` at
    ``depth`` layers (qwen3-0.6b's full 28 unless ``argv`` names another
    arch; published widths, f32 params, bf16 compute and KV unless
    ``extra`` says otherwise).  Every kernel count is set to 0 just before
    the run and read just after: paged_attention once per layer and
    decode step, flash_attention once per layer and prefill (or chunk);
    without ``attention_kernels`` (MLA's latent pages) neither, and no
    other kernel either.  Returns (record, (model, params), requests)."""
    from repro_torch.launch import serve
    args = serve.build_argparser().parse_args(
        list(argv) + ["--requests", str(path), *extra])
    model, params, _ = built or serve.build(args)
    L = model.cfg.n_layers
    check(L == depth, f"[{tag}] {L} layers, expected {depth}")
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
    # a chunked run launches flash_attention once per layer and chunk
    prefills = sch.stats["chunks"] or sch.stats["prefills"]
    if not attention_kernels:
        L = 0
    check(launches["paged_attention"] == L * steps,
          f"[{tag}] paged_attention launched {launches['paged_attention']} "
          f"times, expected {L} layers x {steps} decode steps")
    check(launches["flash_attention"] == L * prefills,
          f"[{tag}] flash_attention launched {launches['flash_attention']} "
          f"times, expected {L} layers x {prefills} prefills")
    check(all(n == 0 for k, n in launches.items()
              if k not in ("paged_attention", "flash_attention")),
          f"[{tag}] other kernels launched while serving: {launches}")
    check(sch.pool.used_pages == 0, f"[{tag}] {sch.pool.used_pages} pages "
          "still allocated after the run")
    check(sch.stats["preemptions"] == 0, f"[{tag}] preempted: the pool "
          "holds every request at full length")
    quant = sch.layout.kv_quantized
    first = "k" if "k" in sch.cache[0]["b0"] else "ckv"   # mla: latents
    pool = sch.cache[0]["b0"][first]
    check(pool.dtype == (torch.int8 if quant else torch.bfloat16)
          and (f"{first}_scale" in sch.cache[0]["b0"]) == quant,
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
          f"ms/step); {s['prefills']} prefills ({s['prefill_chunks']} "
          f"chunks); paged_attention launches "
          f"{launches['paged_attention']} = {L} x {steps}, flash_attention "
          f"{launches['flash_attention']} = {L} x {prefills} [{smi}]")
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


def _profile_decode(smi: str, step, n_steps: int, what: str, tag: str,
                    out_name: str) -> dict:
    """One warm call of ``step()`` (``n_steps`` decode steps, ``what``
    names it), the host synchronisations inside one more under PyTorch's
    sync debug mode (checked to be 0), then two under torch.profiler:
    device busy share, launches per decode step, device time by kernel
    group; the profiler's table goes to ``chiprun_out/out_name``."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[{tag}] host synchronisations inside one {what}: {syncs}")
    check(syncs == 0, f"[{tag}] {syncs} host synchronisations inside one "
          f"{what}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
        return {"host_syncs": syncs}
    print(f"[{tag}] 2 x {what} ({2 * n_steps} decode steps): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, {launches} kernel "
          f"launches ({launches / (2 * n_steps):.0f} per step) [{smi}]")
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
            "kernel_launches": launches, "host_syncs": syncs}


def phase_serve_profile(smi: str, model, params, reqs, argv=SERVE_ARGS,
                        tag: str = "serve-profile",
                        out_name: str = "profile_serve.txt") -> dict:
    """A steady decode burst of ``--slots`` slots (16 for qwen3 and
    falcon-mamba) through `_profile_decode`, its inputs copied to the
    device before the window."""
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
    rec = _profile_decode(
        smi, lambda: sch.decode(*inputs, burst), burst,
        f"decode burst ({burst} steps, {args.slots} slots)", tag, out_name)
    del sch, inputs
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# prefill kernels: flash_attention (B5) and ssm_scan (B6)
# ---------------------------------------------------------------------------

# qwen3-0.6b's attention: 8 kv heads, 2 query heads per kv head, hd 128
FLASH_SHAPE = (8, 2, 128)
# a timed sample is 28 back-to-back launches, as one qwen3 prefill makes
PREFILL_LAYERS = 28
# falcon-mamba-7b's scan: E = expand x d_model, N = state_dim
SSM_E, SSM_N = 8192, 16


def flash_atol(dt, want: torch.Tensor) -> float:
    """flash_attention's limit against its plain version: 2e-5 in f32;
    in bf16 3e-2 of the largest output, at most 3e-2.  A softmax spread
    over many keys averages v down (an encoder over 1,500 frames gives
    outputs of ~0.03), where a bare 3e-2 would pass a wrong kernel."""
    if dt == torch.float32:
        return 2e-5
    return 3e-2 * min(1.0, float(want.float().abs().max()))


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
    windowed case and a ragged non-causal Sq != Sk case (`flash_atol`:
    2e-5 f32, bf16 3e-2 x min(1, max|out|); bitwise equal across two
    launches), each timed beside its bound, the plain version and
    scaled_dot_product_attention (enable_gqa) in the same dtype on the same
    inputs.  The bound is the larger of bytes over 3.35 TB/s and the live
    pairs' 4 hd flops each over the ceiling of the kernel's products
    (f32 as 3xTF32, 165 TFLOP/s; bf16 989); f32's CUDA-core bound (67
    TFLOP/s) is printed beside it.  First, every instantiation's SASS must
    hold tensor-core instructions.  Returns the numbers per case and the
    SASS counts."""
    import torch.nn.functional as F
    from repro_torch.analysis import roofline as R
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost)
    from repro_torch.kernels.ref import flash_attention_plain
    mma = flash_mma_counts()
    check(len(mma) == 10, f"flash_attention: {len(mma)} kernels in the "
          "SASS")
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
        atol = flash_atol(dt, want)
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
        cost = flash_attention_cost(q, k, v, **kw)
        bound, by, nbytes, flops = _bound(cost)
        peak = R.PEAKS[cost["math"]]
        core = "" if dt != torch.float32 else \
            f"; CUDA-core f32 bound {flops / R.PEAK_FLOPS_F32 * 1e3:.4f} ms"
        print(f"[flash] {name}: B=1 KV={KV} G={G} hd={hd}: {ms:.4f} "
              f"ms/launch; plain {plain_ms:.4f} ms; sdpa {library_ms:.4f} "
              f"ms (max abs diff {sdpa_err:.3g}); bound {bound:.4f} ms by "
              f"{by} ({nbytes} B, {flops} flops at "
              f"{peak / 1e12:.0f} TFLOP/s){core}; max abs err "
              f"{err:.3g}, bitwise run to run [{smi}]")
        rec[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                     "flops": flops, "err": err, "sdpa_err": sdpa_err}
        if dt == torch.float32:
            rec[name]["cuda_core_bound_ms"] = flops / R.PEAK_FLOPS_F32 * 1e3
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
                                              ssm_scan, ssm_scan_cost)
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
        bound, by, nbytes, flops = _bound(ssm_scan_cost(*args))
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
# the rest of serving and of the dense family: B5 with a query offset, at
# stablelm-3b's hd 80 and granite-20b's G 48; B4 at those shapes
# ---------------------------------------------------------------------------

# (name, KV, G, hd, layers of the model that runs the shape)
DENSE_SHAPES = (("qwen3", 8, 2, 128, 28), ("stablelm", 32, 1, 80, 32),
                ("granite", 1, 48, 128, 12))
# the chunk case: chunk 5 (positions 512..639) of a 648-token prompt, the
# longest of the prefix traffic below, over the 41 pages it fills
CHUNK = 128
CHUNK_Q0, CHUNK_SK = 512, 41 * PAGE


def _flash_case(smi: str, gen, name: str, KV: int, G: int, hd: int,
                layers: int, sq: int, sk: int, q0: int, dt, tag: str, *,
                batch: int = 1, causal: bool = True,
                plain_reps: int = 10) -> dict:
    """One flash_attention case of ``batch`` x ``sq`` rows at ``q_start``
    q0 over ``sk`` keys, causal or not: against its plain version
    (`flash_atol`), bitwise run to run, timed (``layers`` launches
    per sample) beside its bound, the plain version (median of
    ``plain_reps`` samples) and scaled_dot_product_attention with the
    same mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost)
    from repro_torch.kernels.ref import flash_attention_plain
    H = KV * G
    q = torch.randn((batch, sq, KV, G, hd), generator=gen,
                    device="cuda").to(dt)
    k = torch.randn((batch, sk, KV, hd), generator=gen,
                    device="cuda").to(dt)
    v = torch.randn((batch, sk, KV, hd), generator=gen,
                    device="cuda").to(dt)
    kw = dict(causal=causal, q_start=q0)
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    atol = flash_atol(dt, want)
    check(got.dtype == dt and err <= atol, f"flash_attention {name}: "
          f"max abs err {err} > {atol}")
    check(torch.equal(got, again), f"flash_attention {name}: two "
          "launches differ")
    ms = median_ms(lambda: flash_attention(q, k, v, **kw), batch=layers)
    plain_ms = median_ms(lambda: flash_attention_plain(q, k, v, **kw),
                         reps=plain_reps, batch=layers)
    qs, ks, vs = (q.reshape(batch, sq, H, hd).transpose(1, 2),
                  k.transpose(1, 2), v.transpose(1, 2))
    i = q0 + torch.arange(sq, device="cuda")[:, None]
    mask = torch.arange(sk, device="cuda")[None, :] <= i

    def sdpa():
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask if causal and q0 else None,
            is_causal=causal and q0 == 0, enable_gqa=True)
    sdpa_err = float((sdpa().transpose(1, 2).reshape(want.shape).float()
                      - want.float()).abs().max())
    library_ms = median_ms(sdpa, batch=layers)
    bound, by, nbytes, flops = _bound(flash_attention_cost(
        q, k, v, causal=causal, q_start=q0))
    print(f"[{tag}] {name}: B={batch} KV={KV} G={G} hd={hd} "
          f"{'causal' if causal else 'bidirectional'}: {ms:.4f} "
          f"ms/launch; plain {plain_ms:.4f} ms; sdpa {library_ms:.4f} "
          f"ms (max abs diff {sdpa_err:.3g}); bound {bound:.4f} ms by "
          f"{by} ({nbytes} B, {flops} flops); max abs err {err:.3g} "
          f"(limit {atol:.3g}), bitwise run to run [{smi}]")
    del q, k, v, got, again, want, qs, ks, vs, mask
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "flops": flops, "err": err, "atol": atol, "sdpa_err": sdpa_err}


def phase_flash_shapes(smi: str) -> dict:
    """flash_attention against its plain version where this slice's paths
    reach it: a qwen3 chunk at q_start 512 over the 656 keys of its view,
    stablelm-3b's whole 512-token prompt at hd 80 (32 kv heads, G 1) and
    granite-20b's at G 48 (one kv head), each in f32 and bf16
    (`flash_atol`), bitwise run to run, timed (one launch per
    layer of its model per sample, queued behind the device-side sleep)
    beside its bound, the plain version and scaled_dot_product_attention
    with the same mask.  Then the property the prefix cache rests on: the
    rows of one call at q_start 400 are bitwise those of two calls that
    split it at an unaligned row (100) with q_start 400 and 500 and the
    second's longer key view, at qwen3's shape in f32 and bf16 and at
    granite's G 48 in bf16."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {n: (kv, g, hd, layers) for n, kv, g, hd, layers in DENSE_SHAPES}
    cases = []
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cases += [(f"qwen3 chunk q_start={CHUNK_Q0} Sk={CHUNK_SK} {n}",
                   "qwen3", CHUNK, CHUNK_SK, CHUNK_Q0, dt),
                  (f"stablelm hd 80 S=512 {n}", "stablelm", 512, 512, 0, dt),
                  (f"granite G 48 S=512 {n}", "granite", 512, 512, 0, dt)]
    rec = {name: _flash_case(smi, gen, name, *shapes[model], sq, sk, q0, dt,
                             "flash-shapes")
           for name, model, sq, sk, q0, dt in cases}
    for model, dt in (("qwen3", torch.float32), ("qwen3", torch.bfloat16),
                      ("granite", torch.bfloat16)):
        KV, G, hd, _ = shapes[model]
        q = torch.randn((1, 256, KV, G, hd), generator=gen,
                        device="cuda").to(dt)
        k = torch.randn((1, CHUNK_SK, KV, hd), generator=gen,
                        device="cuda").to(dt)
        v = torch.randn_like(k)
        whole = flash_attention(q, k, v, q_start=400)
        sk_a = (400 + 100 - 1) // PAGE * PAGE + PAGE
        part_a = flash_attention(q[:, :100].contiguous(), k[:, :sk_a].
                                 contiguous(), v[:, :sk_a].contiguous(),
                                 q_start=400)
        part_b = flash_attention(q[:, 100:].contiguous(), k, v, q_start=500)
        torch.cuda.synchronize()
        same = torch.equal(whole[:, :100], part_a) \
            and torch.equal(whole[:, 100:], part_b)
        print(f"[flash-shapes] {model} {str(dt)[6:]}: rows 0-255 at "
              f"q_start 400 in one call == split at row 100 (q_start 400 "
              f"over {sk_a} keys, 500 over {CHUNK_SK}): bitwise {same} "
              f"[{smi}]")
        check(same, f"flash_attention {model} {dt}: a row's bits depend on "
              "where its chunk starts")
        rec[f"split invariance {model} {str(dt)[6:]}"] = same
    return rec


def phase_paged_shapes(smi: str, shapes=DENSE_SHAPES[1:], pools=PA_POOLS,
                       tag: str = "paged-shapes") -> dict:
    """paged_attention against its plain version at stablelm-3b's shape (16
    rows, 32 kv heads, G 1, hd 80: 160-byte bf16 rows) and granite-20b's
    (16 rows, one kv head, G 48, hd 128), the serve phase's ragged lengths
    1..577 and 640-wide tables, for bf16, f32, int8 and fp8 pools (atol
    1e-6 float, 2e-5 quantized), bitwise run to run.  The plain version is
    evaluated in float64 here: at G 48 over bf16 pages its f32 evaluation
    strays 2.22e-6 from the float64 value by its own rounding, the kernel
    5.9e-7, and the two 2.03e-6 from each other (all three printed), so
    the kernel is held to the float64 evaluation.  Timed as
    phase_paged_kernel times qwen3's (one launch on each of the model's
    per-layer pools per sample) beside its byte bound and the plain
    version."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_cost,
                                                     smem_bytes)
    from repro_torch.kernels.ref import paged_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    rec = {}
    for model, KV, G, hd, layers in shapes:
        for pool in pools:
            name = f"{model} KV={KV} G={G} hd={hd} {pool}"
            q, k, v, bt, ln, scales = _paged_case(gen, pool, PA_WIDTH,
                                                  (16, KV, G, hd))
            kw = dict(zip(("k_scale", "v_scale"), scales))
            got = paged_attention(q, k, v, bt, ln, **kw)
            again = paged_attention(q, k, v, bt, ln, **kw)
            want = paged_attention_plain(q.double(), k, v, bt, ln, *scales)
            want32 = paged_attention_plain(q, k, v, bt, ln, *scales)
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max())
            err32 = float((got - want32).abs().max())
            plain32 = float((want32.double() - want).abs().max())
            atol = 2e-5 if scales else 1e-6
            check(err <= atol, f"paged_attention {name}: max abs err {err}"
                  f" > {atol}")
            check(torch.equal(got, again), f"paged_attention {name}: two "
                  "launches differ")
            kL, vL = _layers(k, layers), _layers(v, layers)
            sL = tuple(_layers(t, layers) for t in scales)

            def launch(i):
                return paged_attention(q, kL[i], vL[i], bt, ln, **{
                    n: t[i] for n, t in zip(("k_scale", "v_scale"), sL)})
            ms = median_ms(_rotating(launch, layers), batch=layers)
            plain_ms = median_ms(_rotating(lambda i: paged_attention_plain(
                q, kL[i], vL[i], bt, ln, *(t[i] for t in sL)), layers),
                batch=layers)
            bound, by, nbytes, _ = _bound(paged_attention_cost(
                q, k, v, bt, ln, **kw))
            smem = smem_bytes(G, hd, k.element_size())
            lib = {}
            if pool == "bfloat16":
                lib["gather_sdpa_ms"], lib["gather_sdpa_err"] = \
                    _gather_sdpa_ms(q, kL, vL, bt[:, :PA_LIVE].contiguous(),
                                    ln, layers=layers, ref=want32)
                print(f"[{tag}] {name}: gather of the {PA_LIVE} live "
                      f"pages + scaled_dot_product_attention "
                      f"{lib['gather_sdpa_ms']:.4f} ms (two calls: "
                      f"library_ms stays null; max abs diff "
                      f"{lib['gather_sdpa_err']:.3g}) [{smi}]")
            print(f"[{tag}] {name}: {ms:.4f} ms/launch; plain "
                  f"{plain_ms:.4f} ms; bound {bound:.4f} ms by {by} "
                  f"({nbytes} B); {smem} B of shared memory per CTA; max "
                  f"abs err "
                  f"{err:.3g} (the plain version in f32: {err32:.3g}, its "
                  f"own rounding {plain32:.3g}), bitwise run to run "
                  f"[{smi}]")
            rec[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "bytes": nbytes, "err": err,
                         "err_f32_plain": err32,
                         "f32_plain_rounding": plain32, "smem": smem, **lib}
            del q, k, v, bt, ln, scales, kL, vL, sL, got, again, want, want32
            torch.cuda.empty_cache()
    return rec


# the prefix traffic: 32 requests behind one 392-token system prompt (24.5
# pages of 16, so the 25th page is shared up to its middle and copied on
# the first write), each with its own 32-256-token suffix and 32-64 tokens
# to generate, ids from seed 0
SYSTEM_PROMPT = 392
PREFIX_REQUESTS = 32
PREFIX_ARGS = SERVE_ARGS + ["--paged-kernel", "--prefill-chunk", str(CHUNK)]
SMALL_POOL = 120     # pages: 16 lanes of ~40 pages cannot all fit


def _write_prefix_requests(vocab: int) -> Path:
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, SYSTEM_PROMPT).tolist()
    lines = []
    for i in range(PREFIX_REQUESTS):
        suffix = rng.integers(0, vocab, int(rng.integers(32, 257))).tolist()
        lines.append(json.dumps({"id": i, "prompt": system + suffix,
                                 "gen": int(rng.integers(32, 65))}) + "\n")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "prefix_requests.jsonl"
    path.write_text("".join(lines))
    return path


def _serve_warm_then_rest(smi: str, model, params, path: Path, argv,
                          tag: str, attention_kernels: bool = True,
                          fit_table: bool = False) -> dict:
    """Serve the request file through ``repro_torch.launch.serve``'s
    scheduler: request 0 alone first (a deployment warming its system
    prompt), then the others together.  With ``fit_table`` the block
    tables are as wide as the longest request needs, not the whole pool.
    Every kernel count is set to 0
    just before and read just after (B4 and B5 never launch without
    ``attention_kernels``); each request's last-chunk logits are kept
    (chunked runs)."""
    from repro_torch.launch import serve
    args = serve.build_argparser().parse_args(
        list(argv) + ["--requests", str(path)])
    reqs = serve.load_requests(args.requests, model.cfg.vocab_size,
                               args.gen, seed=args.seed)
    max_len = max(len(r.prompt) + r.max_new + 1 for r in reqs) \
        if fit_table else None
    sch = serve.make_scheduler(model, params, args, max_len=max_len)
    V = model.cfg.vocab_size
    last_logits, offsets = {}, []
    resume = sch.layout.prefill_resume

    def recording(params, cache, tokens, pos0, last, bt):
        logits, cache = resume(params, cache, tokens, pos0, last, bt)
        offsets.append(pos0)
        req = sch.slots[sch._prefilling[0]]
        if pos0 + last + 1 == len(req.resume_tokens):
            last_logits[req.rid] = logits[0, :V].clone()
        return logits, cache
    sch.layout.prefill_resume = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    sch.run(reqs[:1])
    sch.run(reqs[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    s = serve.report(sch, wall, args)
    done = {r.rid: r for r in sch.finished}
    check(sorted(done) == list(range(len(reqs))),
          f"[{tag}] {len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        check(len(done[r.rid].out) == r.max_new, f"[{tag}] request "
              f"{r.rid}: {len(done[r.rid].out)} tokens, expected "
              f"{r.max_new}")
    L = model.cfg.n_layers if attention_kernels else 0
    steps, chunks = sch.stats["decode_steps"], sch.stats["chunks"]
    check(sum(launches.values()) == launches["paged_attention"]
          + launches["flash_attention"], f"[{tag}] other kernels: "
          f"{launches}")
    check(launches["paged_attention"] == L * steps, f"[{tag}] "
          f"paged_attention launched {launches['paged_attention']} times, "
          f"expected {L} x {steps} decode steps")
    check(launches["flash_attention"] == L * (chunks or s["prefills"]),
          f"[{tag}] flash_attention launched "
          f"{launches['flash_attention']} times, expected {L} x "
          f"{chunks or s['prefills']}")
    if sch.prefix is not None:
        check(sch.pool.used_pages == len(sch.prefix.pages())
              and all(sch.pool.refcount(p) == 1 for p in sch.prefix.pages()),
              f"[{tag}] pages held after the drain beyond the cache's own")
    else:
        check(sch.pool.used_pages == 0, f"[{tag}] pages left allocated")
    rec = {"wall_s": wall, "launches": launches,
           "pages_allocated": sch.pool.total_allocs,
           "tokens": {r.rid: list(done[r.rid].out) for r in reqs},
           "offset_chunks": sum(o > 0 for o in offsets),
           "last_logits": last_logits, "peak_bytes":
               torch.cuda.max_memory_allocated(),
           **{k: s.get(k) for k in (
               "p50_ttft_s", "p95_ttft_s", "p50_token_latency_s",
               "p95_token_latency_s", "prefills", "prefill_chunks",
               "cow_copies", "preemptions", "cache_tokens_allocated",
               "prefix_hits", "prefix_hit_tokens", "prefix_evictions")}}
    print(f"[{tag}] TTFT p50/p95 {s['p50_ttft_s'] * 1e3:.1f}/"
          f"{s['p95_ttft_s'] * 1e3:.1f} ms, inter-token p50/p95 "
          f"{s['p50_token_latency_s'] * 1e3:.3f}/"
          f"{s['p95_token_latency_s'] * 1e3:.3f} ms; {chunks} chunks "
          f"({rec['offset_chunks']} at q_start > 0: {L} B5 launches each), "
          f"hits {s.get('prefix_hits', 0)}, hit tokens "
          f"{s.get('prefix_hit_tokens', 0)}, CoW copies {s['cow_copies']},"
          f" pages allocated {sch.pool.total_allocs} "
          f"({s['cache_tokens_allocated']} token slots), preemptions "
          f"{s['preemptions']}; paged_attention {launches['paged_attention']}"
          f" = {L} x {steps}, flash_attention {launches['flash_attention']}"
          f" [{smi}]")
    del sch
    torch.cuda.empty_cache()
    return rec


def phase_chunk_routes(smi: str, model, params, prompts, tag: str) -> dict:
    """The last-chunk logits of each prompt's cold chunked prefill (chunks
    of 128 into a 1-slot paged layout, bf16 pages), kernel route (B5 at
    q_start over the gathered view) against plain route
    (``Model(cfg, kernels=False)``: blocked_attention at kv_chunk 16).  The
    plain route rounds the softmax probabilities to the pages' bf16 before
    the PV product, as the reference does; the kernel route takes the view
    in f32 and keeps them in f32: each attention output differs by up to
    bf16's 2^-9, so the bound is phase_kernel_vs_gather's, 2^-7 of the
    largest logit."""
    from repro_torch.models.cache import PagedLayout
    from repro_torch.models.transformer import Model
    plain = Model(model.cfg, kernels=False)
    V = model.cfg.vocab_size
    worst = top = 0.0
    counted = _counters()
    for p in prompts:
        mp = -(-len(p) // PAGE) + CHUNK // PAGE
        outs = []
        for m in (model, plain):
            lay = PagedLayout(m, n_slots=1, num_pages=mp + 1, page_size=PAGE,
                              max_pages=mp)
            cache = lay.init_cache(device="cuda")
            bt = torch.arange(1, mp + 1, device="cuda")[None]
            before = counted["flash_attention"].launches
            for s0 in range(0, len(p), CHUNK):
                e = min(s0 + CHUNK, len(p))
                toks = torch.tensor([p[s0:e] + [0] * (CHUNK - (e - s0))],
                                    device="cuda")
                logits, cache = lay.prefill_resume(params, cache, toks, s0,
                                                   e - 1 - s0, bt)
            n = counted["flash_attention"].launches - before
            check(n == (model.cfg.n_layers * -(-len(p) // CHUNK)
                        if m is model else 0), f"[{tag}] {n} B5 launches")
            outs.append(logits[:, :V])
            del cache
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
        top = max(top, float(outs[1].abs().max()))
    bound = 2.0 ** -7 * top
    print(f"[{tag}] {len(prompts)} prompts ({[len(p) for p in prompts]} "
          f"tokens) in chunks of {CHUNK}, kernel route vs plain route: max "
          f"|dlogit| {worst:.4g} (bound {bound:.4g} = 2^-7 x max |logit| "
          f"{top:.4g}) [{smi}]")
    check(worst <= bound, f"[{tag}] max |dlogit| {worst} > {bound}")
    torch.cuda.empty_cache()
    return {"max_dlogit": worst, "max_logit": top, "bound": bound}


def phase_serve_prefix(smi: str, model, params) -> dict:
    """qwen3-0.6b at full depth over the prefix traffic, through
    ``repro_torch.launch.serve``'s scheduler with ``--prefill-chunk 128
    --prefix-cache --slots 16 --pages 641 --page-size 16 --decode-burst 4
    --paged-kernel``, greedy, seed 0: request 0 alone, then the other 31
    together.  Checks: every request finishes at its length; the greedy
    tokens are bitwise those of the same schedule without the prefix cache
    (cold chunked); >= 31 hits, >= 1 copy-on-write, fewer token slots
    allocated than the cold run; B5 launches at q_start > 0 and 28 times
    per chunk, B4 28 times per decode step; each request's last-chunk
    logits within 2^-5 of the largest logit of its whole-prompt prefill's
    (the chunk route attends over the pages' bf16 keys and values, the
    whole prompt over its f32 ones: bf16's 2^-9 in every layer's k and v,
    with room for its growth through 28 layers), the count of first
    tokens that agree printed; a 120-page pool (preemptions > 0) finishes
    every request with no refcount error.  The whole-prompt run of the
    same requests and schedule is printed beside them."""
    from repro_torch.launch import serve
    path = _write_prefix_requests(model.cfg.vocab_size)
    rec = {"hot": _serve_warm_then_rest(
        smi, model, params, path, PREFIX_ARGS + ["--prefix-cache"],
        "prefix-hot")}
    rec["cold"] = _serve_warm_then_rest(smi, model, params, path,
                                        PREFIX_ARGS, "prefix-cold")
    rec["whole"] = _serve_warm_then_rest(
        smi, model, params, path, SERVE_ARGS + ["--paged-kernel"],
        "prefix-whole")
    hot, cold, whole = rec["hot"], rec["cold"], rec["whole"]
    check(hot["tokens"] == cold["tokens"], "[prefix] prefix-hit greedy "
          "tokens differ from the cold chunked run's")
    check(hot["prefix_hits"] >= PREFIX_REQUESTS - 1 and hot["cow_copies"] >= 1
          and hot["cache_tokens_allocated"] < cold["cache_tokens_allocated"],
          f"[prefix] hits {hot['prefix_hits']}, CoW {hot['cow_copies']}, "
          f"allocated {hot['cache_tokens_allocated']} vs cold "
          f"{cold['cache_tokens_allocated']}")
    check(hot["offset_chunks"] > 0, "[prefix] no chunk at q_start > 0")
    args = serve.build_argparser().parse_args(SERVE_ARGS + ["--requests",
                                                            str(path)])
    reqs = serve.load_requests(args.requests, model.cfg.vocab_size, args.gen)
    worst = top = 0.0
    agree = 0
    for r in reqs:
        whole_logits, _ = model.prefill(
            params, {"tokens": torch.tensor([r.prompt], device="cuda")},
            cache_len=len(r.prompt))
        w = whole_logits[0, :model.cfg.vocab_size]
        c = hot["last_logits"][r.rid]
        worst = max(worst, float((c - w).abs().max()))
        top = max(top, float(w.abs().max()))
        agree += int(c.argmax() == w.argmax())
    bound = 2.0 ** -5 * top
    print(f"[prefix] prefix hit == cold chunked, greedy tokens bitwise, all "
          f"{len(reqs)} requests; last-chunk logits vs whole-prompt "
          f"prefill: max |dlogit| {worst:.4g} (bound {bound:.4g} = 2^-5 x "
          f"max |logit| {top:.4g}); first tokens agree on {agree} of "
          f"{len(reqs)} [{smi}]")
    check(worst <= bound, f"[prefix] last-chunk logits: max |dlogit| "
          f"{worst} > {bound}")
    for name in ("whole", "cold", "hot"):
        r = rec[name]
        print(f"[prefix] {name}: TTFT p50/p95 {r['p50_ttft_s'] * 1e3:.1f}/"
              f"{r['p95_ttft_s'] * 1e3:.1f} ms, inter-token p50/p95 "
              f"{r['p50_token_latency_s'] * 1e3:.3f}/"
              f"{r['p95_token_latency_s'] * 1e3:.3f} ms, chunks "
              f"{r['prefill_chunks']}, hits {r['prefix_hits'] or 0}, hit "
              f"tokens {r['prefix_hit_tokens'] or 0}, CoW {r['cow_copies']}, "
              f"token slots allocated {r['cache_tokens_allocated']} "
              f"[{smi}]")
    rec["small_pool"] = _serve_warm_then_rest(
        smi, model, params, path, [a if a != "641" else str(SMALL_POOL)
                                   for a in PREFIX_ARGS] + ["--prefix-cache"],
        "prefix-small-pool")
    small = rec["small_pool"]
    same = sum(small["tokens"][i] == hot["tokens"][i]
               for i in range(len(reqs)))
    print(f"[prefix] {SMALL_POOL}-page pool: {small['preemptions']} "
          f"preemptions, {small['prefix_evictions']} evictions, every request"
          f" at its length; {same} of {len(reqs)} requests' tokens equal the "
          f"641-page run's [{smi}]")
    check(small["preemptions"] > 0, "[prefix] the small pool never preempted")
    rec["chunk_routes"] = phase_chunk_routes(
        smi, model, params, [r.prompt for r in reqs[:3]],
        "chunk-routes qwen3")
    rec["logits_vs_whole"] = {"max_dlogit": worst, "max_logit": top,
                              "bound": bound, "first_tokens_agree": agree}
    for r in ("hot", "cold", "whole", "small_pool"):
        rec[r].pop("last_logits")
        rec[r].pop("tokens")
    return rec


DENSE_ARGS = ["--slots", "16", "--pages", "641", "--page-size", str(PAGE),
              "--decode-burst", "4", "--seed", "0", "--paged-kernel"]
STABLELM_ARGS = ["--arch", "stablelm-3b", *DENSE_ARGS]
STABLELM_LAYERS = 32
STABLELM_PARAMS = 2_796_098_560      # the reference's init, 32 layers
STABLELM_TRAIN = ["--arch", "stablelm-3b", "--layers", "4", "--algo",
                  "dc_s3gd", "--workers", str(W), "--batch-per-worker", "4",
                  "--seq", "256", "--buckets", str(N_BUCKETS), "--seed", "0",
                  "--log-every", "1", "--steps", "2", "--use-kernels"]
GRANITE_LAYERS = 12                  # 52 -> 12: 112.7 GB of f32 weights
GRANITE_ARGS = ["--arch", "granite-20b", "--layers", str(GRANITE_LAYERS),
                *DENSE_ARGS]
GRANITE_PARAMS = 6_964_795_392       # 12 x 530,067,456 + 2 x 49,152 x 6,144
                                     # + 6,144 (the reference's layout)


def phase_dense_family(smi: str, path: Path) -> dict:
    """stablelm-3b at full depth (32 layers, 2,796,098,560 params, f32
    weights from seed 0, bf16 compute and KV): 16 of the serve phase's
    requests whole-prompt and then in chunks of 128 through
    ``repro_torch.launch.serve`` (every request at its length, B4 32 times
    per decode step, B5 32 times per prefill or chunk), its prefill logits
    kernel route against plain route (2^-10, as qwen3's) and its chunk
    route's; two dc_s3gd steps at depth 4, W = 2, fused tail, with finite
    losses and A1/A2 once per bucket and step (the layernorm biases ride
    the buckets), then A1/A2 against their plain versions at that path's
    bucket sizes and W (``phase_kernels``).  granite-20b at its published widths, depth cut 52 -> 12
    (6,964,795,392 params): 8 requests whole-prompt (B5 and B4 at G 48 over
    its one kv head), its prefill routes."""
    from repro_torch import tree as T
    from repro_torch.launch import serve, train
    from repro_torch.parallel.buckets import plan_buckets
    rec = {}
    argv = STABLELM_ARGS
    args = serve.build_argparser().parse_args(argv + ["--requests",
                                                      str(path)])
    model, params, _ = serve.build(args)
    n_params = sum(x.numel() for x in T.leaves(params))
    check(n_params == STABLELM_PARAMS, f"stablelm-3b: {n_params} params")
    rec["stablelm"], _, reqs = phase_serve(
        smi, path, (), 16, "serve-stablelm", (model, params, None), argv,
        STABLELM_LAYERS)
    rec["stablelm_chunked"], _, _ = phase_serve(
        smi, path, ("--prefill-chunk", str(CHUNK)), 16,
        "serve-stablelm-chunked", (model, params, None), argv,
        STABLELM_LAYERS)
    rec["stablelm_routes"] = phase_prefill_routes(
        smi, model, params, [reqs[0].prompt, reqs[3].prompt],
        "prefill-routes stablelm", 10)
    rec["stablelm_chunk_routes"] = phase_chunk_routes(
        smi, model, params, [reqs[3].prompt], "chunk-routes stablelm")
    del model, params
    torch.cuda.empty_cache()
    targs = train.build_argparser().parse_args(STABLELM_TRAIN)
    _zero_counts()
    result = train.run(targs)
    torch.cuda.synchronize()
    launches = _read_counts()
    plan = plan_buckets(result["state"].params, N_BUCKETS,
                        strip_leading_axis=True)
    n_buckets = len(plan.bucket_sizes)
    losses = [h["loss"] for h in result["history"]]
    biases = [p for p in _leaf_paths(result["state"].params)
              if p.endswith("bias")]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"[train-stablelm] losses {losses}")
    check(launches["dc_norms"] == 2 * n_buckets
          and launches["dc_fused_update"] == 2 * n_buckets
          and sum(launches.values()) == 4 * n_buckets,
          f"[train-stablelm] launches {launches}, {n_buckets} buckets")
    check(len(biases) == 3, f"[train-stablelm] bias leaves {biases}")
    print(f"[train-stablelm] stablelm-3b x4, W={W}, dc_s3gd, fused tail, "
          f"{n_buckets} buckets: losses {losses}; launches {launches}; "
          f"layernorm bias leaves "
          f"{biases} in the buckets [{smi}]")
    rec["stablelm_train"] = {"losses": losses, "launches": launches,
                             "bucket_sizes": plan.bucket_sizes,
                             "bucket_decay": plan.bucket_decay}
    del result
    torch.cuda.empty_cache()
    # A1/A2 against their plain versions at this path's bucket sizes (the
    # no-decay bucket carries the layernorm scales and biases)
    rec["stablelm_kernels"] = phase_kernels(plan.bucket_sizes, smi, W=W,
                                            select=False,
                                            tag="kernels-stablelm")
    torch.cuda.empty_cache()
    argv = GRANITE_ARGS
    args = serve.build_argparser().parse_args(argv + ["--requests",
                                                      str(path)])
    model, params, _ = serve.build(args)
    n_params = sum(x.numel() for x in T.leaves(params))
    check(n_params == GRANITE_PARAMS, f"granite-20b x12: {n_params} params")
    rec["granite"], _, reqs = phase_serve(
        smi, path, (), 8, "serve-granite", (model, params, None), argv,
        GRANITE_LAYERS)
    rec["granite_routes"] = phase_prefill_routes(
        smi, model, params, [reqs[0].prompt, reqs[3].prompt],
        "prefill-routes granite", 10)
    del model, params
    torch.cuda.empty_cache()
    return rec


def _leaf_paths(tree, prefix: str = "") -> list:
    """'a/b/c' names of a nested dict's leaves, in the tree's order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


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


# ---------------------------------------------------------------------------
# the recurrent families: recurrentgemma-9b served at full depth (B5 on its
# local attention, RG-LRU and the slot ring), falcon-mamba and
# recurrentgemma trained through the chunked scan
# ---------------------------------------------------------------------------

# recurrentgemma-9b's local attention: one kv head, G 16, hd 256, a
# 2,048-token window, in its 12 attention_local blocks
RG_SHAPE = (1, 16, 256)
RG_WINDOW = 2048
RG_LOCAL = 12
RG_LAYERS = 38
RG_PARAMS = 10_444_771_328    # the reference's init (jax.eval_shape)
RG_PROMPTS = (512, 2040, 2560, 4096)
RG_REQUESTS = 16
RG_ARGS = ["--arch", "recurrentgemma-9b", "--slots", "8", "--decode-burst",
           "4", "--seed", "0"]
# falcon-mamba-7b trained at its published widths, depth 64 -> 1: one
# worker-stacked f32 copy is 5.10 GB (depth 2: 5.95 GB), and the fused,
# bucketed tail holds ~14 such copies at its peak (depth 2 ran out of an
# H100 80GB at 73.6 GiB allocated)
FM_TRAIN_LAYERS = 1
FM_TRAIN_PARAMS = 637_992_960  # 105,312,256 + 2 x 65,024 x 4,096 + 4,096
FM_TRAIN_STEPS = 5
FM_TRAIN = ["--arch", "falcon-mamba-7b", "--layers", str(FM_TRAIN_LAYERS),
            "--algo", "dc_s3gd", "--workers", str(W), "--batch-per-worker",
            "2", "--seq", "256", "--buckets", str(N_BUCKETS),
            "--use-kernels", "--steps", str(FM_TRAIN_STEPS), "--seed", "0",
            "--log-every", "1"]
RG_TRAIN = ["--arch", "recurrentgemma-9b", "--reduced", "--algo", "dc_s3gd",
            "--workers", str(W), "--batch-per-worker", "2", "--seq", "128",
            "--buckets", str(N_BUCKETS), "--use-kernels", "--steps", "2",
            "--seed", "0", "--log-every", "1"]


def _write_rg_requests() -> Path:
    """16 requests, prompt_len cycling 512 / 2,040 / 2,560 / 4,096 (the
    2,040-token prompts wrap the 2,048-slot ring in decode, the longer
    ones in the prefill), gen drawn 32..64 from seed 0, as JSONL."""
    import numpy as np
    gens = np.random.default_rng(0).integers(32, 65, RG_REQUESTS)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "rg_requests.jsonl"
    path.write_text("".join(
        json.dumps({"id": i, "prompt_len": RG_PROMPTS[i % 4],
                    "gen": int(g)}) + "\n" for i, g in enumerate(gens)))
    return path


def phase_flash_hybrid(smi: str) -> dict:
    """flash_attention against its plain version at recurrentgemma-9b's
    local attention (B 1, one kv head, G 16, hd 256, window 2,048) at S
    512 (the window masks nothing), 2,048 and 4,096 (the window halves the
    causal pairs), f32 and bf16 (`flash_atol`), bitwise run to run,
    each timed (12 launches per sample, one per attention_local block of a
    prefill, queued behind the device-side sleep) beside its bound (the
    live pairs' 4 hd flops over the ceiling of its products, or its bytes),
    the plain version and scaled_dot_product_attention with the same
    boolean window mask (which computes all S^2 pairs)."""
    import torch.nn.functional as F
    from repro_torch.analysis import roofline as R
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cost)
    from repro_torch.kernels.ref import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(7)
    KV, G, hd = RG_SHAPE
    H = KV * G
    rec = {}
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for S in (512, 2048, 4096):
            name = f"S={S} {n}"
            q = torch.randn((1, S, KV, G, hd), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((1, S, KV, hd), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((1, S, KV, hd), generator=gen,
                            device="cuda").to(dt)
            kw = dict(causal=True, window=RG_WINDOW)
            got = flash_attention(q, k, v, **kw)
            again = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            atol = flash_atol(dt, want)
            check(got.dtype == dt and err <= atol, f"flash_attention "
                  f"recurrentgemma {name}: max abs err {err} > {atol}")
            check(torch.equal(got, again), f"flash_attention recurrentgemma "
                  f"{name}: two launches differ")
            del got, again
            ms = median_ms(lambda: flash_attention(q, k, v, **kw),
                           batch=RG_LOCAL)
            plain_ms = median_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                 batch=RG_LOCAL)
            qs, ks, vs = (q.reshape(1, S, H, hd).transpose(1, 2),
                          k.transpose(1, 2), v.transpose(1, 2))
            i = torch.arange(S, device="cuda")[:, None]
            j = torch.arange(S, device="cuda")[None, :]
            mask = (j <= i) & ((i - j) < RG_WINDOW)

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=mask,
                                                      enable_gqa=True)
            sdpa_err = float((sdpa().transpose(1, 2).reshape(want.shape)
                              .float() - want.float()).abs().max())
            library_ms = median_ms(sdpa, batch=RG_LOCAL)
            cost = flash_attention_cost(q, k, v, **kw)
            bound, by, nbytes, flops = _bound(cost)
            print(f"[flash-hybrid] {name} window {RG_WINDOW}: KV={KV} G={G} "
                  f"hd={hd}: {ms:.4f} ms/launch; plain {plain_ms:.4f} ms; "
                  f"sdpa (boolean window mask) {library_ms:.4f} ms (max abs "
                  f"diff {sdpa_err:.3g}); bound {bound:.4f} ms by {by} "
                  f"({nbytes} B, {flops} flops at "
                  f"{R.PEAKS[cost['math']] / 1e12:.0f} TFLOP/s); max abs err "
                  f"{err:.3g}, bitwise run to run [{smi}]")
            rec[name] = {"ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound,
                         "bound_by": by, "bytes": nbytes, "flops": flops,
                         "err": err, "sdpa_err": sdpa_err}
            del q, k, v, want, qs, ks, vs, mask
            torch.cuda.empty_cache()
    return rec


def phase_hybrid_slot_vs_dense(smi: str, model, params, prompts,
                               gen: int = 16) -> dict:
    """Greedy decode of 2 prompts of 2,040 tokens for ``gen`` steps (the
    ring wraps at position 2,048) through the slot layout against the
    dense layout at the same batch width (dense cache_len 2,057; both
    rings 2,048 wide): every step's logits bitwise, teacher-forced by the
    dense argmax, and finite.  The slot layout stores its rings and conv
    states at the compute dtype (bf16), as the reference's does, where the
    dense prefill's cache keeps the f32 of the f32 weights' products; the
    dense cache is held at the slot layout's storage dtypes, so that the
    two differ in layout (ring slots, per-row masks) only."""
    from repro_torch import tree as T
    from repro_torch.models.cache import DenseLayout, PagedLayout
    B, P = len(prompts), len(prompts[0])
    toks = torch.tensor(prompts, device="cuda")
    lay = PagedLayout(model, n_slots=B, num_pages=2, page_size=PAGE,
                      max_pages=1)
    slot_cache = lay.init_cache(device="cuda")
    dense = DenseLayout(model)
    logits, cache = dense.prefill(params, {"tokens": toks},
                                  cache_len=P + gen + 1)
    cache = T.map(lambda a, b: a.to(b.dtype), cache, slot_cache)
    ring = cache[0]["b2"]["k"].shape[2]
    trace = [logits]
    pos = torch.tensor(P, device="cuda")
    for _ in range(gen):
        logits, cache = dense.decode_step(params, cache, {
            "tokens": trace[-1].argmax(-1)[:, None], "pos": pos})
        trace.append(logits)
        pos = pos + 1
    del cache
    check(slot_cache[0]["b2"]["k"].shape[2] == ring == RG_WINDOW,
          f"[hybrid-slot] rings {slot_cache[0]['b2']['k'].shape} and "
          f"{ring}")
    slots = torch.arange(B, device="cuda")
    logits, slot_cache = lay.prefill_into(
        params, slot_cache, {"tokens": toks},
        torch.zeros((B, 0), dtype=torch.long, device="cuda"), slots)
    same = [torch.equal(logits, trace[0])]
    bt = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), P, device="cuda")
    for t in range(gen):
        logits, slot_cache = lay.decode_step(
            params, slot_cache, trace[t].argmax(-1)[:, None], pos, bt)
        same.append(torch.equal(logits, trace[t + 1]))
        pos = pos + 1
    V = model.cfg.vocab_size
    check(all(bool(torch.isfinite(t[:, :V]).all()) for t in trace),
          "[hybrid-slot] non-finite logits")
    print(f"[hybrid-slot] {B} prompts of {P} tokens, {gen} greedy steps "
          f"past the ring's wrap at {RG_WINDOW}: slot ring == dense ring "
          f"bitwise at {sum(same)} of {len(same)} steps (prefill + decode) "
          f"[{smi}]")
    check(all(same), f"[hybrid-slot] slot decode differs from dense at "
          f"steps {[i for i, x in enumerate(same) if not x]}")
    del slot_cache, trace
    torch.cuda.empty_cache()
    return {"steps": len(same), "bitwise": all(same), "prompt": P}


def phase_serve_hybrid(smi: str) -> dict:
    """Serve 16 requests (prompts 512 / 2,040 / 2,560 / 4,096, gen 32..64
    from seed 0) with recurrentgemma-9b at its published widths and full
    depth (38 layers, 10,444,771,328 params, f32 weights from seed 0, bf16
    compute) through ``repro_torch.launch.serve``, ``--slots 8
    --decode-burst 4``, greedy, whole-prompt.  Every kernel count is set to
    0 just before the run and read just after: flash_attention 12 times
    per prefill (B5 over the window), nothing else; the page pool
    untouched; the slot state (rings, RG-LRU) at its shapes.  Then the
    host synchronisations of a steady burst and two bursts profiled, slot
    decode against dense decode bitwise past the ring's wrap, and the
    prefill's kernel route against its plain route."""
    from repro_torch import tree as T
    from repro_torch.launch import serve
    path = _write_rg_requests()
    args = serve.build_argparser().parse_args(
        RG_ARGS + ["--requests", str(path)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, params, _ = serve.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_params = sum(x.numel() for x in T.leaves(params))
    check(cfg.n_layers == RG_LAYERS and cfg.d_model == 4096
          and cfg.rglru.attention_window == RG_WINDOW
          and n_params == RG_PARAMS,
          f"recurrentgemma-9b at full depth and width: {cfg}, {n_params}")
    check([(st.kinds, st.repeats) for st in model.stages]
          == [(("recurrent", "recurrent", "attention_local"), 12),
              (("recurrent", "recurrent"), 1)], "stage plan")
    reqs = serve.load_requests(args.requests, cfg.vocab_size, args.gen,
                               seed=args.seed)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    sch = serve.run_scheduler(model, params, reqs, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    done = {r.rid: r for r in sch.finished}
    check(sorted(done) == sorted(r.rid for r in reqs),
          f"[serve-hybrid] {len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        check(len(done[r.rid].out) == r.max_new,
              f"[serve-hybrid] request {r.rid}: {len(done[r.rid].out)} "
              f"tokens, expected {r.max_new}")
    prefills, steps = sch.stats["prefills"], sch.stats["decode_steps"]
    check(launches["flash_attention"] == RG_LOCAL * prefills,
          f"[serve-hybrid] flash_attention launched "
          f"{launches['flash_attention']} times, expected {RG_LOCAL} x "
          f"{prefills} prefills")
    check(all(n == 0 for k, n in launches.items()
              if k != "flash_attention"),
          f"[serve-hybrid] other kernels launched: {launches}")
    check(not sch.layout.uses_pages and sch.pool.used_pages == 0
          and sch.pool.total_allocs == 0, "[serve-hybrid] the page pool "
          "was touched")
    c0, c1 = sch.cache
    shapes = {f"stage{si}/{b}/{n}": (tuple(t.shape), str(t.dtype)[6:])
              for si, unit in enumerate(sch.cache) for b, c in unit.items()
              for n, t in c.items()}
    check(tuple(c0["b2"]["k"].shape) == (12, 8, RG_WINDOW, 1, 256)
          and c0["b2"]["k"].dtype == torch.bfloat16
          and c0["b0"]["h"].dtype == torch.float32
          and tuple(c1["b1"]["h"].shape) == (1, 8, 4096),
          f"[serve-hybrid] slot state {shapes}")
    state_bytes = sum(t.numel() * t.element_size()
                      for unit in sch.cache for c in unit.values()
                      for t in c.values())
    check(all(bool(torch.isfinite(t.float()).all())
              for unit in sch.cache for c in unit.values()
              for t in c.values()), "[serve-hybrid] non-finite state")
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
        "slot_state_bytes": state_bytes, "slot_state": shapes,
        **{k: s[k] for k in ("p50_token_latency_s", "p95_token_latency_s",
                             "p50_ttft_s", "p95_ttft_s")},
    }
    print(f"[serve-hybrid] recurrentgemma-9b x{RG_LAYERS} ({n_params} "
          f"params, f32, init {init_s:.1f} s): {len(reqs)} requests, "
          f"{s['tokens']} tokens in {wall:.3f} s "
          f"({rec['tokens_per_s']:.1f} tok/s); decode {decode_tokens} "
          f"tokens in {steps} steps, {decode_s:.3f} s "
          f"({rec['decode_tokens_per_s']:.1f} tok/s, {rec['step_ms']:.3f} "
          f"ms/step); {prefills} prefills; flash_attention launches "
          f"{launches['flash_attention']} = {RG_LOCAL} x {prefills}; pool "
          f"untouched [{smi}]")
    print(f"[serve-hybrid] inter-token p50 "
          f"{s['p50_token_latency_s'] * 1e3:.3f} ms p95 "
          f"{s['p95_token_latency_s'] * 1e3:.3f} ms; TTFT p50 "
          f"{s['p50_ttft_s'] * 1e3:.1f} ms p95 {s['p95_ttft_s'] * 1e3:.1f} "
          f"ms; slot state {state_bytes} B for 8 slots (rings of "
          f"{RG_WINDOW} whatever the prompt); peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} B), of which "
          f"{before / 2**20:.1f} MiB were allocated before the run [{smi}]")
    del sch, c0, c1
    torch.cuda.empty_cache()
    short = [r for r in reqs if len(r.prompt) == RG_PROMPTS[0]]
    rec["profile"] = phase_serve_profile(smi, model, params, short, RG_ARGS,
                                         "serve-hybrid-profile",
                                         "profile_serve_hybrid.txt")
    rec["slot_vs_dense"] = phase_hybrid_slot_vs_dense(
        smi, model, params, [r.prompt for r in reqs
                             if len(r.prompt) == RG_PROMPTS[1]][:2])
    rec["routes"] = phase_prefill_routes(
        smi, model, params, [reqs[0].prompt, reqs[3].prompt],
        "prefill-routes recurrentgemma", 10)
    del model, params
    torch.cuda.empty_cache()
    return rec


def phase_train_recurrent(smi: str) -> dict:
    """falcon-mamba-7b at its published widths, depth 64 -> 1 (637,992,960
    params), dc_s3gd, W = 2, 2 x 256 tokens per worker, mean_allreduce, 4
    buckets, fused tail, 5 steps through the differentiable chunked scan:
    finite losses, A1/A2 once per bucket and step and nothing else, step
    time and peak memory; A1/A2 against their plain versions at its
    bucket sizes; the chunked scan's y and h_last against ssm_scan_plain
    at E 8,192, N 16 (atol 1e-4, as B6's checks).  Then reduced
    recurrentgemma (its two stages in the buckets), 2 steps: finite
    losses and the kernel counts, nothing measured."""
    from repro_torch import tree as T
    from repro_torch.kernels.ref import ssm_scan_plain
    from repro_torch.launch import train
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.parallel.buckets import plan_buckets
    rec = {}
    args = train.build_argparser().parse_args(FM_TRAIN)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    result = train.run(args)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = result["state"]
    plan = plan_buckets(state.params, N_BUCKETS, strip_leading_axis=True)
    nb = len(plan.bucket_sizes)
    n_params = sum(x[0].numel() for x in T.leaves(state.params))
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    check(n_params == FM_TRAIN_PARAMS, f"[train-fm] {n_params} params")
    check(len(losses) == FM_TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"[train-fm] losses {losses}")
    check(all(h["lambda"] > 0 and math.isfinite(h["distance_norm"])
              for h in hist[2:]), f"[train-fm] lambda / |D| {hist}")
    check(launches["dc_norms"] == FM_TRAIN_STEPS * nb
          and launches["dc_fused_update"] == FM_TRAIN_STEPS * nb
          and sum(launches.values()) == 2 * FM_TRAIN_STEPS * nb,
          f"[train-fm] launches {launches}, {nb} buckets")
    step_ms = _step_ms(hist)
    tokens = W * 2 * 256
    print(f"[train-fm] falcon-mamba-7b x{FM_TRAIN_LAYERS} ({n_params} "
          f"params), W={W}, dc_s3gd, fused tail, {nb} buckets "
          f"{plan.bucket_sizes}: losses {losses}; launches {launches}; step "
          f"{step_ms:.3f} ms (median of steps 2-4, {tokens / step_ms * 1e3:.1f}"
          f" tokens/s); peak memory {peak / 2**30:.3f} GiB ({peak} B), of "
          f"which {before / 2**20:.1f} MiB were allocated before [{smi}]")
    rec["falcon_mamba"] = {"losses": losses, "launches": launches,
                           "step_ms": step_ms, "peak_bytes": peak,
                           "params": n_params,
                           "bucket_sizes": plan.bucket_sizes,
                           "bucket_decay": plan.bucket_decay}
    del result, state
    torch.cuda.empty_cache()
    rec["falcon_mamba_kernels"] = phase_kernels(
        plan.bucket_sizes, smi, W=W, select=False,
        tag="kernels-falcon-mamba")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(9)
    scan = {}
    for S in (256, 512):
        a_log, dt, dtx, b, c = _ssm_case(gen, 1, S, SSM_E)
        y, h = ssm_mod._scan_chunked(a_log, dt, dtx, b, c, 256)
        py, ph = ssm_scan_plain(a_log, dt, dtx, b, c)
        torch.cuda.synchronize()
        ey = float((y - py).abs().max())
        eh = float((h - ph).abs().max())
        ms = median_ms(lambda: ssm_mod._scan_chunked(a_log, dt, dtx, b, c,
                                                     256))
        print(f"[train-fm] chunked scan (chunk 256) vs ssm_scan_plain, B=1 "
              f"S={S} E={SSM_E} N={SSM_N}: max |dy| {ey:.3g}, max "
              f"|dh_last| {eh:.3g} (atol 1e-4); {ms:.3f} ms forward [{smi}]")
        check(ey <= 1e-4 and eh <= 1e-4, f"[train-fm] chunked scan S={S}: "
              f"{ey} {eh}")
        scan[f"S={S}"] = {"err_y": ey, "err_h": eh, "ms": ms}
        del a_log, dt, dtx, b, c, y, h, py, ph
    rec["chunked_scan"] = scan
    torch.cuda.empty_cache()
    args = train.build_argparser().parse_args(RG_TRAIN)
    _zero_counts()
    result = train.run(args)
    torch.cuda.synchronize()
    launches = _read_counts()
    plan = plan_buckets(result["state"].params, N_BUCKETS,
                        strip_leading_axis=True)
    nb = len(plan.bucket_sizes)
    losses = [h["loss"] for h in result["history"]]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"[train-rg] losses {losses}")
    check(sorted(result["state"].params) == ["embed", "final_norm",
                                             "stage0", "stage1", "unembed"],
          "[train-rg] the multi-stage tree")
    check(launches["dc_norms"] == 2 * nb
          and launches["dc_fused_update"] == 2 * nb
          and sum(launches.values()) == 4 * nb,
          f"[train-rg] launches {launches}, {nb} buckets")
    print(f"[train-rg] reduced recurrentgemma (stage0 + stage1), W={W}, "
          f"dc_s3gd, fused tail, {nb} buckets: losses {losses}; launches "
          f"{launches} (a route check: nothing measured) [{smi}]")
    rec["recurrentgemma_reduced"] = {"losses": losses, "launches": launches}
    del result
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the MoE family and MLA (slice 11), and C5 on the card
# ---------------------------------------------------------------------------

OLMOE_LAYERS = 16
OLMOE_PARAMS = 6_919_624_704         # the reference's init, 16 layers
OLMOE_ARGS = ["--arch", "olmoe-1b-7b", *DENSE_ARGS]
PHI_LAYERS = 8                       # 32 -> 8: 167.5 GB of f32 weights
PHI_PARAMS = 10_666_708_992
PHI_ARGS = ["--arch", "phi3.5-moe-42b-a6.6b", "--layers", str(PHI_LAYERS),
            *DENSE_ARGS]
PHI_REQUESTS = 8
# B4 and B5 where the MoE serve paths reach them: (name, kv heads, query
# heads per kv head, hd, layers)
MOE_SHAPES = (("olmoe", 16, 1, 128, OLMOE_LAYERS),
              ("phi3.5-moe", 8, 4, 128, PHI_LAYERS))
ROUTE_REQUESTS = 4
OLMOE_TRAIN_STEPS = 5
OLMOE_TRAIN_PARAMS = 626_137_344     # depth 1
OLMOE_TRAIN = ["--arch", "olmoe-1b-7b", "--layers", "1", "--algo",
               "dc_s3gd", "--workers", str(W), "--batch-per-worker", "2",
               "--seq", "256", "--buckets", str(N_BUCKETS), "--seed", "0",
               "--log-every", "1", "--steps", str(OLMOE_TRAIN_STEPS),
               "--use-kernels"]
MINICPM_LAYERS = 62
MINICPM_PARAMS = 4_262_025_728
MINICPM_ARGS = ["--arch", "minicpm3-4b", *DENSE_ARGS]
MINICPM_TOKEN_BYTES = 62 * (256 + 32) * 2    # bf16 ckv + k_rope, 35,712
# the prefix check's depth: at 62 layers its hot and cold runs took
# 157-200 s of host-bound decode steps (6,225 launches a step); the
# bitwise pin does not depend on the depth
MINICPM_PREFIX_LAYERS = 8
QWEN3_TOKEN_BYTES = 28 * 2 * 8 * 128 * 2     # bf16 k + v, 114,688
MINICPM_TRAIN = ["--arch", "minicpm3-4b", "--layers", "2", "--algo",
                 "dc_s3gd", "--workers", str(W), "--batch-per-worker", "2",
                 "--seq", "256", "--buckets", str(N_BUCKETS), "--seed", "0",
                 "--log-every", "1", "--steps", "2", "--use-kernels"]


def _params_count(params) -> int:
    from repro_torch import tree as T
    return sum(x.numel() for x in T.leaves(params))


def phase_moe_kernel_shapes(smi: str) -> dict:
    """B4 and B5 at the MoE serve paths' attention shapes: olmoe-1b-7b's
    16 kv heads at G 1 and phi3.5-moe's 8 kv heads at G 4 (hd 128).  B4:
    16 rows, the serve phase's ragged lengths 1..577 and 640-wide tables,
    bf16 and f32 pools, held to its plain version in float64 (1e-6),
    bitwise run to run, timed over one launch on each of the model's
    per-layer pools beside its byte bound and the plain version (and, for
    bf16, gather + SDPA).  B5: one 512-token prompt, f32 and bf16
    (`flash_atol`), timed beside its bound, the plain version and SDPA."""
    rec = {"paged": phase_paged_shapes(smi, MOE_SHAPES,
                                       ("bfloat16", "float32"),
                                       "paged-moe-shapes")}
    gen = torch.Generator(device="cuda").manual_seed(11)
    rec["flash"] = {}
    for model, KV, G, hd, layers in MOE_SHAPES:
        for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            name = f"{model} KV={KV} G={G} S=512 {n}"
            rec["flash"][name] = _flash_case(smi, gen, name, KV, G, hd,
                                             layers, 512, 512, 0, dt,
                                             "flash-moe-shapes")
    return rec


def phase_moe_dropless(smi: str, model, params) -> dict:
    """The decode's dropless routed FFN (``moe_ffn(capacity_factor=-1)``)
    against the all-experts oracle ``moe_ffn_dense`` at the model's widths
    on its first block's weights, for 16 decode rows (f32 activations, as
    the residual stream is after the first block): the same function
    summed in another order, held to 2^-16 of the oracle's largest
    output."""
    from repro_torch.models import moe
    cfg = model.cfg
    p = {k: v[0] for k, v in params["stage0"]["b0"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((16, 1, cfg.d_model), generator=gen, device="cuda")
    got, aux_a = moe.moe_ffn(p, x, cfg.moe, cfg.activation,
                             capacity_factor=-1.0)
    want, aux_b = moe.moe_ffn_dense(p, x, cfg.moe, cfg.activation)
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    bound = 2.0 ** -16 * top
    print(f"[moe-dropless] {cfg.name}: moe_ffn(capacity_factor=-1) vs "
          f"moe_ffn_dense, 16 rows, E={cfg.moe.n_experts} top-"
          f"{cfg.moe.top_k}, d={cfg.d_model}, f={cfg.moe.d_ff_expert}: max "
          f"|d| {err:.3g} (bound {bound:.3g} = 2^-16 x {top:.4g}); aux "
          f"{float(aux_a):.6g} / {float(aux_b):.6g} [{smi}]")
    check(err <= bound and float(aux_a) == float(aux_b),
          f"[moe-dropless] {err} > {bound} or aux differs")
    return {"max_abs_err": err, "max_out": top, "bound": bound}


def phase_moe_routes(smi: str, model, params, reqs) -> dict:
    """The kernel route (B5 prefill, B4 decode) against the plain route
    (``Model(cfg, kernels=False)``, gather decode) on the first
    ``ROUTE_REQUESTS`` requests, whole-prompt, greedy, through the
    scheduler with f32 pools (where the two routes differ in summation
    order only): the same tokens."""
    from repro_torch.models.transformer import Model
    from repro_torch.serve import Request, Scheduler
    out = []
    for m, use_kernel in ((model, True),
                          (Model(model.cfg, kernels=False), False)):
        sch = Scheduler(m, params, slots=16, pages=641, page_size=PAGE,
                        use_kernel=use_kernel, decode_burst=4,
                        kv_dtype="float32")
        _zero_counts()
        done = sch.run([Request(rid=r.rid, prompt=r.prompt,
                                max_new=r.max_new)
                        for r in reqs[:ROUTE_REQUESTS]])
        launches = _read_counts()
        check((launches["paged_attention"] > 0) == use_kernel
              and (launches["flash_attention"] > 0) == use_kernel,
              f"[moe-routes] launches {launches} (kernel route "
              f"{use_kernel})")
        out.append({r.rid: list(r.out) for r in done})
        del sch
    same = sum(out[0][r] == out[1][r] for r in out[0])
    n_tok = sum(len(t) for t in out[0].values())
    print(f"[moe-routes] {model.cfg.name}: kernel route vs plain route, "
          f"{len(out[0])} requests ({n_tok} tokens), f32 pools: greedy "
          f"tokens equal for {same} of {len(out[0])} [{smi}]")
    check(same == len(out[0]), "[moe-routes] greedy tokens differ")
    torch.cuda.empty_cache()
    return {"requests": len(out[0]), "tokens": n_tok, "equal": same}


def phase_serve_moe(smi: str, path: Path) -> dict:
    """olmoe-1b-7b at its published widths and full depth (16 layers,
    6,919,624,704 params, f32 weights from seed 0, bf16 compute and KV)
    over phase 8's 48 requests through ``repro_torch.launch.serve`` with
    ``--slots 16 --pages 641 --page-size 16 --decode-burst 4
    --paged-kernel``, whole-prompt: every request at its length, B4 16
    times per decode step, B5 16 times per prefill; the routed prefill
    (capacity factor 1.25) and the dropless decode.  Then the dropless FFN
    against the oracle, the kernel route against the plain route, the
    host synchronisations of a burst (0) and two bursts profiled.
    phi3.5-moe-42b-a6.6b cut to 8 of 32 layers (10,666,708,992 params)
    serves 8 requests: B4 and B5 at GQA 32/8 (G 4)."""
    from repro_torch.launch import serve
    rec = {}
    args = serve.build_argparser().parse_args(OLMOE_ARGS + ["--requests",
                                                            str(path)])
    t0 = time.perf_counter()
    model, params, _ = serve.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = _params_count(params)
    cfg = model.cfg
    check(n == OLMOE_PARAMS and cfg.moe.n_experts == 64
          and cfg.moe.top_k == 8 and not model.moe_dense,
          f"olmoe-1b-7b: {n} params, {cfg.moe}")
    expert_bytes = sum(params["stage0"]["b0"]["moe"][k].numel() * 4
                       for k in ("w_up", "w_gate", "w_down"))
    print(f"[serve-olmoe] olmoe-1b-7b x{OLMOE_LAYERS}: {n} params "
          f"({n * 4 / 1e9:.2f} GB f32; the experts {expert_bytes / 1e9:.2f}"
          f" GB, all read by each dropless decode step), init {init_s:.1f} s"
          f" [{smi}]")
    rec["olmoe"], _, reqs = phase_serve(
        smi, path, (), None, "serve-olmoe", (model, params, None),
        OLMOE_ARGS, OLMOE_LAYERS)
    rec["olmoe"]["params"] = n
    rec["olmoe"]["expert_bytes"] = expert_bytes
    rec["olmoe"]["init_s"] = init_s
    rec["olmoe_dropless"] = phase_moe_dropless(smi, model, params)
    rec["olmoe_routes"] = phase_moe_routes(smi, model, params, reqs)
    rec["olmoe_profile"] = phase_serve_profile(
        smi, model, params, reqs, OLMOE_ARGS, "serve-olmoe-profile",
        "profile_serve_olmoe.txt")
    del model, params
    torch.cuda.empty_cache()
    args = serve.build_argparser().parse_args(PHI_ARGS + ["--requests",
                                                          str(path)])
    model, params, _ = serve.build(args)
    n = _params_count(params)
    check(n == PHI_PARAMS and model.cfg.eff_n_kv_heads == 8
          and model.cfg.n_heads == 32, f"phi3.5-moe x{PHI_LAYERS}: {n}")
    rec["phi"], _, _ = phase_serve(
        smi, path, (), PHI_REQUESTS, "serve-phi3.5-moe",
        (model, params, None), PHI_ARGS, PHI_LAYERS)
    rec["phi"]["params"] = n
    del model, params
    torch.cuda.empty_cache()
    return rec


def phase_train_moe(smi: str) -> dict:
    """olmoe-1b-7b at its published widths, depth 16 -> 1 (626,137,344
    params), dc_s3gd, W = 2, 2 x 256 tokens per worker, 4 buckets, fused
    tail, 5 steps, the routed FFN (capacity factor 1.25: 80 slots per
    expert): finite losses, A1/A2 once per bucket and step and nothing
    else, step time, peak memory and the aux loss of worker 0's final
    weights on one batch (finite, > 0); then A1/A2 against their plain
    versions at its bucket sizes, whose first holds the (E, d, f) expert
    leaves.  minicpm3-4b cut to 2 layers trains 2 steps as a route
    check."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.buckets import plan_buckets
    rec = {}
    args = train.build_argparser().parse_args(OLMOE_TRAIN)
    # the launcher routes at the published widths (moe_dense only under
    # --reduced); this twin of its model reads the aux loss afterwards
    model = Model(dataclasses.replace(get_config("olmoe-1b-7b"),
                                      n_layers=1))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    result = train.run(args)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = result["state"]
    plan = plan_buckets(state.params, N_BUCKETS, strip_leading_axis=True)
    nb = len(plan.bucket_sizes)
    n = sum(x[0].numel() for x in T.leaves(state.params))
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    check(n == OLMOE_TRAIN_PARAMS and not args.reduced,
          f"[train-olmoe] {n} params")
    check(moe.capacity(2 * 256, model.cfg.moe, 1.25) == 80,
          "[train-olmoe] capacity")
    check(len(losses) == OLMOE_TRAIN_STEPS
          and all(map(math.isfinite, losses)), f"[train-olmoe] {losses}")
    check(launches["dc_norms"] == OLMOE_TRAIN_STEPS * nb
          and launches["dc_fused_update"] == OLMOE_TRAIN_STEPS * nb
          and sum(launches.values()) == 2 * OLMOE_TRAIN_STEPS * nb,
          f"[train-olmoe] launches {launches}, {nb} buckets")
    data = SyntheticLMDataset(model.cfg.vocab_size, 256, seed=0)
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in data.batch(0, 0, 2).items()}
    aux = []
    with torch.no_grad():
        p0 = T.map(lambda a: a[0], state.params)
        model._backbone(p0, model._embed(p0, batch), aux=aux)
    aux_total = float(sum(aux))
    check(len(aux) == 1 and math.isfinite(aux_total) and aux_total > 0,
          f"[train-olmoe] aux {aux}")
    step_ms = _step_ms(hist)
    print(f"[train-olmoe] olmoe-1b-7b x1 ({n} params), W={W}, dc_s3gd, "
          f"routed (80 slots per expert), fused tail, {nb} buckets "
          f"{plan.bucket_sizes}: losses {losses}; aux loss {aux_total:.6g};"
          f" launches {launches}; step {step_ms:.3f} ms (median of steps "
          f"2-4); peak memory {peak / 2**30:.3f} GiB ({peak} B), of which "
          f"{before / 2**20:.1f} MiB were allocated before [{smi}]")
    rec["olmoe"] = {"losses": losses, "aux": aux_total,
                    "launches": launches, "step_ms": step_ms,
                    "peak_bytes": peak, "params": n,
                    "bucket_sizes": plan.bucket_sizes,
                    "bucket_decay": plan.bucket_decay}
    del result, state, model, p0
    torch.cuda.empty_cache()
    rec["olmoe_kernels"] = phase_kernels(plan.bucket_sizes, smi, W=W,
                                         select=False, tag="kernels-olmoe")
    torch.cuda.empty_cache()
    args = train.build_argparser().parse_args(MINICPM_TRAIN)
    _zero_counts()
    result = train.run(args)
    torch.cuda.synchronize()
    launches = _read_counts()
    plan = plan_buckets(result["state"].params, N_BUCKETS,
                        strip_leading_axis=True)
    nb = len(plan.bucket_sizes)
    losses = [h["loss"] for h in result["history"]]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"[train-minicpm3] losses {losses}")
    check(launches["dc_norms"] == 2 * nb
          and launches["dc_fused_update"] == 2 * nb
          and sum(launches.values()) == 4 * nb,
          f"[train-minicpm3] launches {launches}, {nb} buckets")
    print(f"[train-minicpm3] minicpm3-4b x2 (MLA), W={W}, dc_s3gd, fused "
          f"tail, {nb} buckets: losses {losses}; launches {launches} (a "
          f"route check: nothing measured) [{smi}]")
    rec["minicpm3"] = {"losses": losses, "launches": launches}
    del result
    torch.cuda.empty_cache()
    return rec


def phase_serve_mla(smi: str, path: Path) -> dict:
    """minicpm3-4b at its published widths and full depth (62 layers,
    4,262,025,728 params, f32 weights from seed 0, bf16 compute) on the
    paged latent pools (ckv 256 + k_rope 32 a token and layer): 16 of
    phase 8's requests whole-prompt, then 8 over int8 pools, through
    ``repro_torch.launch.serve`` (every request at its length; B4 and B5
    never launch: MLA's latent pages are read by gather and its prefill
    takes the plain core, as in the reference); the latent token bytes
    beside qwen3-0.6b's; two decode bursts profiled (0 host syncs).  Then,
    at its published widths cut to 8 of its 62 layers, phase 12's 32
    requests behind the 392-token system prompt with ``--prefill-chunk
    128 --prefix-cache`` against the cold chunked run: greedy tokens
    bitwise, >= 31 hits, >= 1 copy-on-write, fewer pages (block tables as
    wide as the longest request, 713 tokens or 45 pages, as every decode
    step gathers and scores the whole table)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.cache import PagedLayout
    from repro_torch.models.transformer import Model
    rec = {}
    args = serve.build_argparser().parse_args(MINICPM_ARGS + ["--requests",
                                                              str(path)])
    model, params, _ = serve.build(args)
    n = _params_count(params)
    check(n == MINICPM_PARAMS and [st.kinds for st in model.stages]
          == [("mla",)], f"minicpm3-4b: {n} params, {model.stages}")
    rec["whole"], _, reqs = phase_serve(
        smi, path, (), 16, "serve-minicpm3", (model, params, None),
        MINICPM_ARGS, MINICPM_LAYERS, attention_kernels=False)
    rec["int8"], _, _ = phase_serve(
        smi, path, ("--kv-dtype", "int8"), 8, "serve-minicpm3-int8",
        (model, params, None), MINICPM_ARGS, MINICPM_LAYERS,
        attention_kernels=False)
    kw = dict(n_slots=16, num_pages=641, page_size=PAGE, max_pages=640)
    mla_bytes = PagedLayout(model, **kw).kv_bytes_per_token()
    qwen_bytes = PagedLayout(Model(get_config("qwen3-0.6b")),
                             **kw).kv_bytes_per_token()
    print(f"[serve-minicpm3] latent pool bytes a token (bf16, 62 layers x "
          f"(256 + 32) x 2): {mla_bytes} B, against qwen3-0.6b's k + v "
          f"{qwen_bytes} B ({qwen_bytes / mla_bytes:.2f}x); int8: "
          f"{rec['int8']['kv_bytes_per_token']} B [{smi}]")
    check(mla_bytes == MINICPM_TOKEN_BYTES and qwen_bytes ==
          QWEN3_TOKEN_BYTES, f"token bytes {mla_bytes} {qwen_bytes}")
    rec["token_bytes"] = {"minicpm3": mla_bytes, "qwen3": qwen_bytes}
    rec["profile"] = phase_serve_profile(
        smi, model, params, reqs, MINICPM_ARGS, "serve-minicpm3-profile",
        "profile_serve_minicpm3.txt")
    del model, params
    torch.cuda.empty_cache()
    cut = MINICPM_ARGS + ["--layers", str(MINICPM_PREFIX_LAYERS)]
    model, params, _ = serve.build(serve.build_argparser().parse_args(cut))
    ppath = _write_prefix_requests(model.cfg.vocab_size)
    chunked = cut + ["--prefill-chunk", str(CHUNK)]
    rec["hot"] = _serve_warm_then_rest(smi, model, params, ppath,
                                       chunked + ["--prefix-cache"],
                                       "prefix-minicpm3-hot",
                                       attention_kernels=False,
                                       fit_table=True)
    rec["cold"] = _serve_warm_then_rest(smi, model, params, ppath, chunked,
                                        "prefix-minicpm3-cold",
                                        attention_kernels=False,
                                        fit_table=True)
    hot, cold = rec["hot"], rec["cold"]
    check(hot["tokens"] == cold["tokens"], "[prefix-minicpm3] prefix-hit "
          "greedy tokens differ from the cold chunked run's")
    check(hot["prefix_hits"] >= PREFIX_REQUESTS - 1
          and hot["cow_copies"] >= 1
          and hot["pages_allocated"] < cold["pages_allocated"],
          f"[prefix-minicpm3] hits {hot['prefix_hits']}, CoW "
          f"{hot['cow_copies']}, pages {hot['pages_allocated']} vs cold "
          f"{cold['pages_allocated']}")
    print(f"[prefix-minicpm3] minicpm3-4b x{MINICPM_PREFIX_LAYERS}: prefix "
          f"hit == cold chunked, greedy tokens "
          f"bitwise, all {PREFIX_REQUESTS} requests; pages allocated hot "
          f"{hot['pages_allocated']} vs cold {cold['pages_allocated']} "
          f"({hot['cache_tokens_allocated']} vs "
          f"{cold['cache_tokens_allocated']} token slots); TTFT p50 hot "
          f"{hot['p50_ttft_s'] * 1e3:.1f} ms vs cold "
          f"{cold['p50_ttft_s'] * 1e3:.1f} ms [{smi}]")
    for r in ("hot", "cold"):
        rec[r].pop("last_logits")
        rec[r].pop("tokens")
    del model, params
    torch.cuda.empty_cache()
    return rec


def phase_c5(smi: str) -> dict:
    """ROADMAP queue C5 on the card: reduced falcon-mamba-7b and
    recurrentgemma-9b (f32, random weights from seed 0), prompts of 1 and
    2 tokens (shorter than conv_kernel - 1 = 3) prefilled into the slot
    layout, then 4 decode steps teacher-forced: the prefill's and every
    step's logits within 1e-5 of the whole-sequence forward's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.cache import PagedLayout
    from repro_torch.models.transformer import Model
    rec = {}
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        model = Model(reduced(get_config(arch)))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        for P in (1, 2):
            B, S = 2, P + 4
            toks = torch.randint(0, model.cfg.vocab_size, (B, S),
                                 generator=gen, device="cuda")
            want = model.logits(params, {"tokens": toks})
            lay = PagedLayout(model, n_slots=B, num_pages=2, page_size=PAGE,
                              max_pages=1)
            cache = lay.init_cache(device="cuda")
            logits, cache = lay.prefill_into(
                params, cache, {"tokens": toks[:, :P]},
                torch.zeros((B, 0), dtype=torch.long, device="cuda"),
                torch.arange(B, device="cuda"))
            err = float((logits - want[:, P - 1]).abs().max())
            bt = torch.zeros((B, 1), dtype=torch.long, device="cuda")
            for t in range(P, S):
                logits, cache = lay.decode_step(
                    params, cache, toks[:, t:t + 1],
                    torch.full((B,), t, device="cuda"), bt)
                err = max(err, float((logits - want[:, t]).abs().max()))
            print(f"[c5] {arch} reduced, P={P}: slot-layout prefill + 4 "
                  f"decode steps vs the whole-sequence forward: max "
                  f"|dlogit| {err:.3g} (1e-5) [{smi}]")
            check(err <= 1e-5, f"[c5] {arch} P={P}: {err}")
            rec[f"{arch} P={P}"] = err
        del model, params
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 15: the vlm and encdec families (qwen2-vl-7b, whisper-large-v3)
# ---------------------------------------------------------------------------

VLM_LAYERS = 28
VLM_PARAMS = 7_628_332_544           # the reference's init, 28 layers
VLM_BATCH, VLM_PROMPT, VLM_GEN = 4, 128, 32
VLM_PATCHES = 1024
VLM_ARGS = ["--arch", "qwen2-vl-7b", "--batch", str(VLM_BATCH),
            "--prompt-len", str(VLM_PROMPT), "--gen", str(VLM_GEN)]
WHISPER_LAYERS = 32                  # the decoder's; the encoder's too
WHISPER_PARAMS = 1_601_459_200
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 8, 64, 64
WHISPER_FRAMES = 1500
WHISPER_ARGS = ["--arch", "whisper-large-v3", "--batch", str(WHISPER_BATCH),
                "--prompt-len", str(WHISPER_PROMPT), "--gen",
                str(WHISPER_GEN)]
# B5 where the new prefills reach it: (name, batch, kv heads, G, hd,
# launches per prefill, Sq, Sk, causal)
MM_FLASH = (("qwen2-vl prefill", VLM_BATCH, 4, 7, 128, VLM_LAYERS,
             VLM_PATCHES + VLM_PROMPT, VLM_PATCHES + VLM_PROMPT, True),
            ("whisper encoder", WHISPER_BATCH, 20, 1, 64, WHISPER_LAYERS,
             WHISPER_FRAMES, WHISPER_FRAMES, False),
            ("whisper decoder self", WHISPER_BATCH, 20, 1, 64,
             WHISPER_LAYERS, WHISPER_PROMPT, WHISPER_PROMPT, True),
            ("whisper cross", WHISPER_BATCH, 20, 1, 64, WHISPER_LAYERS,
             WHISPER_PROMPT, WHISPER_FRAMES, False))
# B4 where the new paged decodes reach it: (name, kv heads, G, hd, layers)
MM_PAGED = (("qwen2-vl", 4, 7, 128, VLM_LAYERS),
            ("whisper", 20, 1, 64, WHISPER_LAYERS))
WHISPER_TRAIN_LAYERS = 8             # encoder and decoder, 32 -> 8 each
WHISPER_TRAIN_STEPS = 3
VLM_TRAIN_STEPS = 2
MM_SEQ = 256                         # training tokens per sequence


def phase_multimodal_kernel_shapes(smi: str) -> dict:
    """B5 and B4 where qwen2-vl-7b's and whisper-large-v3's paths reach
    them.  B5 at the paths' batches: qwen2-vl's causal prefill (4 kv
    heads, G 7, hd 128, 4 x 1,152 positions), whisper's bidirectional
    encoder (20 kv heads, G 1, hd 64, 8 x 1,500 frames), its decoder's
    causal self-attention (8 x 64) and its cross-attention (8 x 64 queries
    over 1,500 frames, the last key tile ragged), f32 and bf16
    (`flash_atol`), bitwise run to run, timed (one launch per layer per sample)
    beside its bound, the plain version and SDPA in the same dtype.  B4 at
    KV 4 G 7 hd 128 and KV 20 G 1 hd 64 (16 rows, ragged lengths 1..577,
    640-wide tables), bf16 and f32 pools, held to its plain version in
    float64 (1e-6), timed beside its byte bound, the plain version and
    gather + SDPA."""
    rec = {"paged": phase_paged_shapes(smi, MM_PAGED,
                                       ("bfloat16", "float32"),
                                       "paged-mm-shapes")}
    gen = torch.Generator(device="cuda").manual_seed(13)
    rec["flash"] = {}
    for name, Bt, KV, G, hd, layers, sq, sk, causal in MM_FLASH:
        for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            key = f"{name} Sq={sq} Sk={sk} {n}"
            rec["flash"][key] = _flash_case(
                smi, gen, key, KV, G, hd, layers, sq, sk, 0, dt,
                "flash-mm-shapes", batch=Bt, causal=causal, plain_reps=3)
    return rec


def _mm_oneshot(smi: str, argv, tag: str, prefill_launches: int) -> dict:
    """``repro_torch.launch.serve`` one-shot (model built from seed 0,
    stub inputs drawn from it, one prefill, greedy decode over the dense
    cache): counts zeroed before and read after; B5 ``prefill_launches``
    times and B4 never (the dense decode gathers nothing)."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    ids = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    args = serve.build_argparser().parse_args(argv)
    check(tuple(ids.shape) == (args.batch, args.gen)
          and int(ids.min()) >= 0, f"[{tag}] ids {tuple(ids.shape)}")
    check(launches["flash_attention"] == prefill_launches
          and launches["paged_attention"] == 0
          and sum(launches.values()) == prefill_launches,
          f"[{tag}] launches {launches}")
    print(f"[{tag}] one-shot through repro_torch.launch.serve: {args.batch}"
          f" x {args.prompt_len} tokens, {args.gen} generated, greedy: "
          f"{wall:.2f} s with the model's init; launches {launches}; peak "
          f"{peak / 2**30:.3f} GiB [{smi}]")
    return {"wall_s": wall, "launches": launches, "peak_bytes": peak,
            "first": ids[0].tolist()}


def _mm_paged(model, params, batch: dict, offset: int, gen: int,
              kernel: bool, teacher=None, extra_steps: int = 0):
    """``batch`` through `PagedLayout` over f32 pools: ``prefill_into``
    block tables covering the prompt (``offset`` patch positions before
    its tokens), then ``gen - 1`` greedy decode steps over the full-width
    tables (fed ``teacher``'s tokens when given).  ``kernel`` picks the
    kernel route (B5 prefill, B4 decode) or the plain one.  Returns
    (tokens (B, gen), per-step logits, launches, TTFT s, decode s, the
    layout, the cache, the next step's (tokens, pos, tables))."""
    from repro_torch.models.cache import PagedLayout
    B, P = batch["tokens"].shape
    mp = -(-(P + offset + gen + extra_steps) // PAGE)
    lay = PagedLayout(model, n_slots=B, num_pages=B * mp + 1,
                      page_size=PAGE, max_pages=mp, use_kernel=kernel,
                      kv_dtype="float32")
    cache = lay.init_cache(device="cuda")
    pages = torch.arange(1, B * mp + 1, device="cuda").reshape(B, mp)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    logits, cache = lay.prefill_into(
        params, cache, batch, pages[:, :lay.pages_for(P + offset)],
        torch.arange(B, device="cuda"))
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    out, trace = [tok], [logits]
    pos = torch.full((B,), P + offset, device="cuda")
    t0 = time.perf_counter()
    for t in range(gen - 1):
        fed = tok if teacher is None else teacher[:, t]
        logits, cache = lay.decode_step(params, cache, fed[:, None], pos,
                                        pages)
        tok = logits.argmax(-1)
        out.append(tok)
        trace.append(logits)
        pos = pos + 1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = _read_counts()
    nxt = (tok[:, None], pos, pages)
    return (torch.stack(out, 1), trace, launches, ttft, decode_s, lay,
            cache, nxt)


def _mm_routes(smi: str, model, params, batch: dict, offset: int, gen: int,
               layers: int, prefill_launches: int, tag: str,
               profile_name: str) -> dict:
    """The kernel route (B5 ``prefill_launches`` times in the prefill, B4
    ``layers`` times a decode step) and the plain route
    (``Model(cfg, kernels=False)``, the gather decode, no launch) over
    f32 pools: the plain route fed the kernel route's tokens gives the
    same greedy token at every step.  Then two steady steps of the kernel
    route profiled."""
    from repro_torch.models.transformer import Model
    B = batch["tokens"].shape[0]
    toks, trace, launches, ttft, decode_s, lay, cache, nxt = _mm_paged(
        model, params, batch, offset, gen, True, extra_steps=8)
    steps = gen - 1
    check(launches["flash_attention"] == prefill_launches
          and launches["paged_attention"] == layers * steps
          and sum(launches.values()) == prefill_launches + layers * steps,
          f"[{tag}] kernel route launches {launches}")
    plain = Model(model.cfg, kernels=False)
    p_toks, p_trace, p_launches, p_ttft, p_decode_s = _mm_paged(
        plain, params, batch, offset, gen, False, teacher=toks)[:5]
    check(sum(p_launches.values()) == 0,
          f"[{tag}] plain route launches {p_launches}")
    same = int((p_toks == toks).sum())
    dlogit = max(float((a - b).abs().max()) for a, b in zip(trace, p_trace))
    print(f"[{tag}] {model.cfg.name} paged (f32 pools, {B} rows, "
          f"{lay.max_pages}-page tables): kernel route TTFT {ttft:.3f} s, "
          f"{steps} decode steps {decode_s * 1e3 / steps:.3f} ms each "
          f"(launches {launches}); plain route TTFT {p_ttft:.3f} s, "
          f"{p_decode_s * 1e3 / steps:.3f} ms a step; greedy tokens equal "
          f"{same} of {toks.numel()} (the plain route teacher-forced), max "
          f"|dlogit| {dlogit:.3g} [{smi}]")
    check(same == toks.numel(), f"[{tag}] kernel and plain routes' greedy "
          "tokens differ")
    tok, pos, pages = nxt

    def step():
        lay.decode_step(params, cache, tok, pos, pages)
    prof = _profile_decode(smi, step, 1, "decode step", f"{tag}-profile",
                           profile_name)
    return {"ttft_s": ttft, "step_ms": decode_s * 1e3 / steps,
            "plain_ttft_s": p_ttft, "plain_step_ms": p_decode_s * 1e3 / steps,
            "launches": launches, "tokens": toks.numel(), "equal": same,
            "max_dlogit": dlogit, "profile": prof, "layout": lay,
            "cache": cache, "next": nxt}


def phase_serve_vlm(smi: str) -> dict:
    """qwen2-vl-7b at its published widths and full depth (28 layers,
    7,628,332,544 params, f32 weights from seed 0, bf16 compute): 4
    prompts of 1,024 stub patch positions + 128 tokens, 32 generated,
    greedy, one-shot through ``repro_torch.launch.serve`` (B5 28 times,
    causal at KV 4, G 7, hd 128), then the same batch through
    `PagedLayout` over f32 pools (B4 28 times a decode step, M-RoPE
    positions (3, B, 1)), kernel route == plain route, two steps
    profiled."""
    from repro_torch.launch import serve
    rec = {"oneshot": _mm_oneshot(smi, VLM_ARGS, "serve-vlm", VLM_LAYERS)}
    args = serve.build_argparser().parse_args(VLM_ARGS)
    t0 = time.perf_counter()
    model, params, _ = serve.build(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = _params_count(params)
    cfg = model.cfg
    check(n == VLM_PARAMS and cfg.vlm.n_patches == VLM_PATCHES
          and cfg.vlm.mrope_sections == (16, 24, 24)
          and cfg.n_heads // cfg.n_kv_heads == 7,
          f"qwen2-vl-7b: {n} params, {cfg.vlm}")
    print(f"[serve-vlm] qwen2-vl-7b x{VLM_LAYERS}: {n} params "
          f"({n * 4 / 1e9:.2f} GB f32), init {init_s:.1f} s [{smi}]")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT),
                            generator=gen, device="cuda")
    batch = {"tokens": prompts, **serve.stub_inputs(cfg, VLM_BATCH,
                                                    VLM_PROMPT, gen)}
    torch.cuda.reset_peak_memory_stats()
    routes = _mm_routes(smi, model, params, batch, VLM_PATCHES, VLM_GEN,
                        VLM_LAYERS, VLM_LAYERS, "serve-vlm",
                        "profile_serve_vlm.txt")
    routes["peak_bytes"] = torch.cuda.max_memory_allocated()
    for k in ("layout", "cache", "next"):
        routes.pop(k)
    rec.update(routes=routes, params=n, init_s=init_s)
    print(f"[serve-vlm] peak {routes['peak_bytes'] / 2**30:.3f} GiB over "
          f"the paged runs [{smi}]")
    del model, params, batch
    torch.cuda.empty_cache()
    return rec


def phase_serve_whisper(smi: str) -> dict:
    """whisper-large-v3 at its published widths and full depth (32
    encoder + 32 decoder layers, 1,601,459,200 params, f32 weights from
    seed 0, bf16 compute): 8 prompts of 64 tokens over 1,500 stub frames
    each, 64 generated, greedy, one-shot through
    ``repro_torch.launch.serve`` (B5 96 times: 32 bidirectional over the
    frames, 32 causal decoder-self, 32 cross at 64 x 1,500), then through
    `PagedLayout` over f32 pools (the self part paged, B4 32 times a
    decode step; xk / xv slot-indexed), kernel route == plain route, two
    steps profiled.  Then the shares: the encoder pass of the prefill,
    and the 32 cross-attention reads (plain ``attend_one`` over (8, 1,500,
    20, 64), no kernel in the reference) of a decode step."""
    from repro_torch import tree as T
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    rec = {"oneshot": _mm_oneshot(smi, WHISPER_ARGS, "serve-whisper",
                                  3 * WHISPER_LAYERS)}
    args = serve.build_argparser().parse_args(WHISPER_ARGS)
    model, params, _ = serve.build(args)
    n = _params_count(params)
    cfg = model.cfg
    check(n == WHISPER_PARAMS and cfg.encoder.n_frames == WHISPER_FRAMES
          and cfg.encoder.n_layers == WHISPER_LAYERS
          and not cfg.mlp_gated, f"whisper-large-v3: {n} params")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (WHISPER_BATCH, WHISPER_PROMPT), generator=gen,
                            device="cuda")
    batch = {"tokens": prompts, **serve.stub_inputs(
        cfg, WHISPER_BATCH, WHISPER_PROMPT, gen)}
    torch.cuda.reset_peak_memory_stats()
    routes = _mm_routes(smi, model, params, batch, 0, WHISPER_GEN,
                        WHISPER_LAYERS, 3 * WHISPER_LAYERS, "serve-whisper",
                        "profile_serve_whisper.txt")
    routes["peak_bytes"] = torch.cuda.max_memory_allocated()
    lay, cache, (tok, pos, pages) = (routes.pop(k) for k in
                                     ("layout", "cache", "next"))
    blk = cache[0]["b0"]
    check(tuple(blk["xk"].shape) == (WHISPER_LAYERS, WHISPER_BATCH,
                                     WHISPER_FRAMES, 20, 64)
          and blk["xk"].dtype == torch.bfloat16,
          f"[serve-whisper] xk {tuple(blk['xk'].shape)} {blk['xk'].dtype}")
    xs = [T.map(lambda a: a[r], params["stage0"]["b0"]["xattn"])
          for r in range(WHISPER_LAYERS)]
    x = torch.randn((WHISPER_BATCH, 1, cfg.d_model), generator=gen,
                    device="cuda")

    def cross_reads():
        for r in range(WHISPER_LAYERS):
            attn.attention_decode(xs[r], {"k": blk["xk"][r],
                                          "v": blk["xv"][r]}, x, pos,
                                  rope_theta=0.0, cross=True)
    cross_ms = median_ms(cross_reads, reps=5)
    step_ms = median_ms(lambda: lay.decode_step(params, cache, tok, pos,
                                                pages), reps=5)
    prefill_ms = median_ms(lambda: model.prefill(params, batch,
                                                 WHISPER_PROMPT + 1), reps=3)
    encoder_ms = median_ms(lambda: model._encoder_out(
        params, batch["frames"], "flash"), reps=3)
    print(f"[serve-whisper] a paged decode step {step_ms:.3f} ms, of which "
          f"the 32 cross-attention reads (q, attend_one over "
          f"{WHISPER_FRAMES} bf16 frames, wo) alone take {cross_ms:.3f} ms "
          f"({100 * cross_ms / step_ms:.1f}%); the prefill {prefill_ms:.3f}"
          f" ms, of which the encoder pass alone takes {encoder_ms:.3f} ms "
          f"({100 * encoder_ms / prefill_ms:.1f}%) (CUDA events, medians) "
          f"[{smi}]")
    routes.update(cross_ms=cross_ms, decode_step_event_ms=step_ms,
                  prefill_ms=prefill_ms, encoder_ms=encoder_ms)
    rec.update(routes=routes, params=n)
    print(f"[serve-whisper] peak {routes['peak_bytes'] / 2**30:.3f} GiB "
          f"over the paged runs [{smi}]")
    del model, params, batch, lay, cache, blk, xs
    torch.cuda.empty_cache()
    return rec


def _mm_train(smi: str, cfg, steps: int, per_worker: int, tag: str) -> dict:
    """dc_s3gd at W = 2, 4 buckets, the fused tail (A1/A2), ``steps``
    steps through `Engine.fit` (the launcher's loop) with batches whose
    sequences carry their stub inputs (a VLM's patches and tiled M-RoPE
    positions, an encoder-decoder's frames): the algorithm's ``step``
    with ``Model.loss``, as the reference's model tests reach it (its
    launchers' token stream has neither).  Finite losses, A1/A2 once per
    bucket and step and nothing else, step time, peak memory."""
    from repro_torch import tree as T
    from repro_torch.core import registry
    from repro_torch.core.types import DCS3GDConfig
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.buckets import plan_buckets
    model = Model(cfg, loss_chunk=256)
    dc = DCS3GDConfig(learning_rate=0.05, momentum=0.9, lambda0=0.2,
                      warmup_steps=1, total_steps=steps)
    alg = registry.make("dc_s3gd", dc, n_workers=W, use_kernels=True,
                        buckets=N_BUCKETS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = alg.init(model.init(torch.Generator(device="cuda")
                                .manual_seed(0)))
    d, V = cfg.d_model, cfg.vocab_size

    def batch_fn(it, n_workers=None):
        g = torch.Generator(device="cuda").manual_seed(1000 + it)
        lead = (W, per_worker)
        b = {"tokens": torch.randint(0, V, lead + (MM_SEQ,), generator=g,
                                     device="cuda"),
             "labels": torch.randint(0, V, lead + (MM_SEQ,), generator=g,
                                     device="cuda")}
        if cfg.vlm is not None:
            n = cfg.vlm.n_patches
            b["patches"] = torch.randn(lead + (n, d), generator=g,
                                       device="cuda")
            b["mrope_positions"] = torch.arange(
                n + MM_SEQ, device="cuda").expand(W, 3, n + MM_SEQ)
        if cfg.encoder is not None:
            b["frames"] = torch.randn(lead + (cfg.encoder.n_frames, d),
                                      generator=g, device="cuda")
        return b
    _zero_counts()
    state, hist, _ = Engine(model, alg).fit(state, batch_fn, steps=steps,
                                            log_every=1)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    plan = plan_buckets(state.params, N_BUCKETS, strip_leading_axis=True)
    nb = len(plan.bucket_sizes)
    n = sum(x[0].numel() for x in T.leaves(state.params))
    losses = [h["loss"] for h in hist]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"[{tag}] losses {losses}")
    check(launches["dc_norms"] == steps * nb
          and launches["dc_fused_update"] == steps * nb
          and sum(launches.values()) == 2 * steps * nb,
          f"[{tag}] launches {launches}, {nb} buckets")
    step_ms = _step_ms(hist) if steps > 2 else None
    timing = "" if step_ms is None else \
        f"; step {step_ms:.3f} ms (median of steps 2..)"
    print(f"[{tag}] {cfg.name} x{cfg.n_layers}"
          f"{'' if cfg.encoder is None else f' + encoder x{cfg.encoder.n_layers}'}"
          f" ({n} params), W={W}, dc_s3gd, fused tail, {nb} buckets "
          f"{plan.bucket_sizes}: losses {losses}; launches {launches}"
          f"{timing}; peak memory {peak / 2**30:.3f} GiB ({peak} B), of "
          f"which {before / 2**20:.1f} MiB were allocated before [{smi}]")
    rec = {"losses": losses, "launches": launches, "step_ms": step_ms,
           "peak_bytes": peak, "params": n, "layers": cfg.n_layers,
           "bucket_sizes": plan.bucket_sizes}
    del state, alg, model
    torch.cuda.empty_cache()
    return rec


def phase_train_multimodal(smi: str) -> dict:
    """whisper-large-v3 at its published widths, depth cut to 8 encoder +
    8 decoder layers, 3 dc_s3gd steps at W = 2 over 2 x 256 tokens and
    their 1,500 stub frames a worker, then A1/A2 against their plain
    versions at its bucket sizes (A2 bitwise); qwen2-vl-7b at the
    reduced widths (its embedding and unembedding alone hold 1.09 B
    params: not even one layer fits at W = 2), 2 steps with patches and
    M-RoPE positions."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config("whisper-large-v3")
    cfg = dataclasses.replace(
        cfg, n_layers=WHISPER_TRAIN_LAYERS,
        encoder=dataclasses.replace(cfg.encoder,
                                    n_layers=WHISPER_TRAIN_LAYERS))
    rec = {"whisper": _mm_train(smi, cfg, WHISPER_TRAIN_STEPS, 2,
                                "train-whisper")}
    k = phase_kernels(rec["whisper"]["bucket_sizes"], smi, W=W,
                      select=False, tag="kernels-whisper")
    check(k["dc_fused_update"]["err"] == 0.0,
          f"[kernels-whisper] A2 off its plain version by "
          f"{k['dc_fused_update']['err']}")
    rec["whisper_kernels"] = k
    torch.cuda.empty_cache()
    rec["qwen2_vl"] = _mm_train(smi, reduced(get_config("qwen2-vl-7b")),
                                VLM_TRAIN_STEPS, 2, "train-vlm")
    return rec


# ---------------------------------------------------------------------------
# slice 13: the analysis layer on the card (roofline, autotuner, kernel
# settings it reaches, the lint subset)
# ---------------------------------------------------------------------------

TRAIN_CELL = MAIN_ARGS + ["--use-kernels", "--steps", "8"]
ROOF_STEPS = 6
# the lint subset on the card: mean_allreduce and topk inline and overlapped
# (bf16 wire) and the int8 point, at qwen3-0.6b x4, fused kernels
LINT_POINTS = (("mean_allreduce", False, "bfloat16"),
               ("mean_allreduce", True, "bfloat16"),
               ("topk", False, "bfloat16"), ("topk", True, "bfloat16"),
               ("topk", False, "int8"))
NEW_PAGES = (8, 16, 32)


def phase_roofline(smi: str) -> dict:
    """The H100 roofline of one training step of the cell (qwen3-0.6b x4,
    W = 2, 4 x 256 tokens a worker, 4 buckets, fused tail) from
    ``Engine.trace_train_step``: FLOPs and bytes by group, the three
    terms, the bottleneck, beside the measured median step (CUDA events
    around each of 5 steady steps) and ``train_step_mfu``, the model's
    6·N·D over the step time and the bf16 peak, with the share against
    the f32 CUDA-core peak beside it."""
    from repro_torch.analysis import roofline as R
    from repro_torch.core.types import InputShape
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    args = train.build_argparser().parse_args(TRAIN_CELL)
    model, alg, state, batch_fn = train.build(args)
    engine = Engine(model, alg)
    state, _ = alg.step(state, batch_fn(0), loss_fn=model.loss)
    tr, state, _ = engine.trace_train_step(state, batch_fn(1))
    times = []
    for it in range(2, 2 + ROOF_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        state, m = alg.step(state, batch_fn(it), loss_fn=model.loss)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times[1:])
    shape = InputShape("train_cell", 256, W * 4, "train")
    roof = R.analyze(tr, model.cfg, shape, 1)
    mfu = roof.model_flops / (step_ms * 1e-3 * R.PEAK_FLOPS_BF16)
    mfu32 = roof.model_flops / (step_ms * 1e-3 * R.PEAK_FLOPS_F32)
    by_math = {}
    for o in tr.ops:
        if o.dot_flops:
            by_math[o.math] = by_math.get(o.math, 0) + o.dot_flops
    groups = tr.by_group()
    for g, v in sorted(groups.items()):
        print(f"[roofline] {g}: {v['ops']} ops, {v['flops']} FLOPs, "
              f"{v['bytes']} B [{smi}]")
    print(f"[roofline] qwen3-0.6b x4 train step, W={W}, 4x256 tokens a "
          f"worker: {len(tr.ops)} ops, {roof.flops:.6g} FLOPs (dot "
          f"{tr.dot_flops:.6g}: {by_math}), {roof.hbm_bytes:.6g} B; compute "
          f"{roof.compute_s * 1e3:.4f} ms, memory {roof.memory_s * 1e3:.4f} "
          f"ms, collective {roof.collective_s * 1e3:.4f} ms beside the step "
          f"({roof.coll_bytes:.6g} B over NVLink); bottleneck "
          f"{roof.bottleneck}; measured step {step_ms:.3f} ms (median of "
          f"{ROOF_STEPS - 1}); model {roof.model_flops:.6g} FLOPs, "
          f"train_step_mfu {mfu:.4f} (of 989 TFLOP/s bf16), {mfu32:.4f} of "
          f"the 67 TFLOP/s f32 peak [{smi}]")
    check(roof.flops > 0 and roof.hbm_bytes > 0 and math.isfinite(step_ms),
          "roofline terms")
    check(all(math.isfinite(float(v)) for v in m.values()
              if isinstance(v, (int, float))), "roofline steps' metrics")
    rec = {"step_ms": step_ms, "train_step_mfu": mfu, "mfu_f32_peak": mfu32,
           "roofline": roof.to_dict(), "groups": groups,
           "dot_flops_by_math": by_math, "ops": len(tr.ops)}
    del tr, state, m, alg, model, engine
    torch.cuda.empty_cache()
    return rec


def _repaged(ps: int, pool: str):
    """The serving shape's rows (PA_SHAPE, lengths 1..577) with the same
    token contents laid into pages of ``ps`` tokens through a shuffled
    block table: (q, k_pool, v_pool, table, lengths, scales)."""
    from repro_torch.models.cache import _quantize_tokens
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    B, KV, G, hd = PA_SHAPE
    total = sum(PA_LENGTHS)
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev)
    ks = torch.randn((total, KV, hd), generator=gen, device=dev)
    vs = torch.randn((total, KV, hd), generator=gen, device=dev)
    live = [-(-n // ps) for n in PA_LENGTHS]
    n_pages = sum(live) + 1
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(ps)).to(dev) + 1
    k = torch.zeros((n_pages, ps, KV, hd), device=dev)
    v = torch.zeros_like(k)
    bt = torch.zeros((B, max(live)), dtype=torch.int32, device=dev)
    tok = page = 0
    for b, n in enumerate(PA_LENGTHS):
        pages = perm[page:page + live[b]]
        for dst, src in ((k, ks), (v, vs)):
            rows = torch.zeros((live[b] * ps, KV, hd), device=dev)
            rows[:n] = src[tok:tok + n]
            dst[pages] = rows.view(live[b], ps, KV, hd)
        bt[b, :live[b]] = pages.int()
        tok, page = tok + n, page + live[b]
    ln = torch.tensor(PA_LENGTHS, dtype=torch.int32, device=dev)
    if pool == "int8":
        k, k_s = _quantize_tokens(k, pool, 2)
        v, v_s = _quantize_tokens(v, pool, 2)
        return q, k, v, bt, ln, (k_s, v_s)
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16), bt, ln, ()


def phase_new_settings(smi: str) -> dict:
    """The kernel settings the autotuner reaches that no earlier run used.
    A1 / A2 at the cell's buckets padded to 2·BLOCK (the plan of
    ``plan_block=2·BLOCK``; zero padding in every operand, as a packed
    bucket has it): A1 within rtol 1e-5 of its plain version, A2 bitwise,
    each timed (cold, per launch) beside its byte bound and the plain
    version.  paged_attention at pages of 8 and 32 (and 16) over the same
    rows' tokens, bf16 and int8 pools, held to its plain version in
    float64 (1e-6 / 2e-5), bitwise across the three page sizes (the
    split-K ranges are whole 32-token tiles), timed as phase 8 times it
    (one launch on each of 28 per-layer pools per sample) beside its byte
    bound and the plain version."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.kernels import dc_update as K
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_cost)
    from repro_torch.kernels.ref import paged_attention_plain
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.buckets import BLOCK, plan_buckets
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    plan = plan_buckets(params, N_BUCKETS, block=2 * BLOCK)
    fill = [0] * plan.n_buckets
    for slot in plan.slots:
        fill[slot.bucket] += slot.size
    del params
    print(f"[settings] qwen3-0.6b x4 buckets at plan_block {2 * BLOCK}: "
          f"{plan.bucket_sizes} (filled {fill}) [{smi}]")
    gen = torch.Generator(device=dev).manual_seed(3)
    args = dict(mu=0.9, eta=0.05, wd=2.3e-4)
    rec = {"bucket_sizes": plan.bucket_sizes, "two_block": {}, "paged": {}}
    acc = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
           for k in ("dc_norms", "dc_fused_update")}
    for n, used in zip(plan.bucket_sizes, fill):
        g, d, m, w = (torch.randn((W, n), generator=gen, device=dev)
                      for _ in range(4))
        for t in (g, d, m, w):
            t[:, used:] = 0
        lam = torch.linspace(0.3, 0.7, W, device=dev)
        got, ref = K.dc_norms(g, d), K.dc_norms_plain(g, d)
        out = K.dc_fused_update(g, d, m, w, lam=lam, **args)
        want = K.dc_fused_update_plain(g, d, m, w, lam=lam, **args)
        torch.cuda.synchronize()
        rel = max(float(((x - r).abs() / r.abs()).max())
                  for x, r in zip(got, (ref[:, 0], ref[:, 1])))
        check(rel <= 1e-5, f"dc_norms at 2·BLOCK padding n={n}: rel {rel}")
        check(all(torch.equal(x, y) for x, y in zip(out, want)),
              f"dc_fused_update at 2·BLOCK padding n={n}: not bitwise")
        check(not out[0][:, used:].any() and not out[1][:, used:].any(),
              f"dc_fused_update wrote into the padding, n={n}")
        err = max(float((x - r).abs().max())
                  for x, r in zip(got, (ref[:, 0], ref[:, 1])))
        del got, ref, out, want
        for name, fn, plain, bpe, cost in (
                ("dc_norms", K.dc_norms, K.dc_norms_plain, 8,
                 K.dc_norms_cost(g, d)),
                ("dc_fused_update",
                 lambda *o: K.dc_fused_update(*o, lam=lam, **args),
                 lambda *o: K.dc_fused_update_plain(*o, lam=lam, **args),
                 28, K.dc_fused_update_cost(g, d, m, w, lam=lam))):
            ops = _rotation((g, d) if bpe == 8 else (g, d, m, w),
                            bpe * W * n)
            k_ms, p_ms = cold_ms(fn, ops), cold_ms(plain, ops)
            del ops
            bound = _bound(cost)[0]
            a = acc[name]
            a["ms"] += k_ms
            a["plain_ms"] += p_ms
            a["bound_ms"] += bound
            a["err"] = max(a["err"], err if bpe == 8 else 0.0)
            print(f"[settings] {name} n={n} W={W} (2·BLOCK padding): "
                  f"{k_ms:.4f} ms/launch, plain {p_ms:.4f}, bound "
                  f"{bound:.4f} ms [{smi}]")
        del g, d, m, w
        torch.cuda.empty_cache()
    rec["two_block"] = acc
    for pool in ("bfloat16", "int8"):
        outs = {}
        for ps in NEW_PAGES:
            q, k, v, bt, ln, scales = _repaged(ps, pool)
            kw = dict(zip(("k_scale", "v_scale"), scales))
            outs[ps] = paged_attention(q, k, v, bt, ln, **kw)
            want = paged_attention_plain(q.double(), k, v, bt, ln, *scales)
            torch.cuda.synchronize()
            err = float((outs[ps].double() - want).abs().max())
            atol = 2e-5 if scales else 1e-6
            check(err <= atol, f"paged_attention page {ps} {pool}: max abs "
                  f"err {err} > {atol}")
            kL, vL = _layers(k), _layers(v)
            sL = tuple(_layers(t) for t in scales)

            def launch(i):
                return paged_attention(q, kL[i], vL[i], bt, ln, **{
                    n: t[i] for n, t in zip(("k_scale", "v_scale"), sL)})
            ms = median_ms(_rotating(launch), batch=PA_LAYERS)
            plain_ms = median_ms(_rotating(lambda i: paged_attention_plain(
                q, kL[i], vL[i], bt, ln, *(t[i] for t in sL))),
                batch=PA_LAYERS)
            bound, _, nbytes, _ = _bound(paged_attention_cost(
                q, k, v, bt, ln, **kw))
            print(f"[settings] paged_attention page {ps} {pool} pools (the "
                  f"serving shape, lengths 1..577): {ms:.4f} ms/launch, "
                  f"plain {plain_ms:.4f}, bound {bound:.4f} ms; max abs "
                  f"err {err:.3g} vs float64 [{smi}]")
            rec["paged"][f"page {ps} {pool}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "err": err, "bytes": nbytes}
            del q, k, v, bt, ln, scales, kL, vL, sL, want
            torch.cuda.empty_cache()
        check(all(torch.equal(outs[ps], outs[16]) for ps in NEW_PAGES),
              f"paged_attention {pool}: pages of 8 / 16 / 32 differ")
        print(f"[settings] paged_attention {pool}: pages of 8, 16 and 32 "
              f"give bitwise the same output [{smi}]")
    return rec


def phase_autotune(smi: str) -> dict:
    """The autotuner on the card: the train candidates (buckets {1, 2, 4,
    8} x plan_block {None, 2·BLOCK}, qwen3-0.6b x4, W = 2, fused kernels)
    and the serve candidates (page_size {8, 16, 32} x decode_burst {1, 4,
    8, 16}, qwen3-0.6b x28, 16 slots, 16 requests from seed 0 at the serve
    cell's lengths, two rounds over the candidates in turn), each
    candidate's prediction beside its measurement;
    the tuned config is the best candidate only where it beats the
    default by more than the measured spread (checked against the rule
    restated here), tuned <= default ms/step, tuned >= default tokens/s,
    greedy tokens identical across every serve candidate (the probe
    raises otherwise);
    A1 / A2 launched in the train probe, B4 / B5 in the serve probe.  The
    blob goes to chiprun_out/autotune.json."""
    from repro_torch.analysis import autotune as A
    out = {}
    _zero_counts()
    t0 = time.perf_counter()
    train = A.probe_train(A.train_space(False))
    out["train_launches"] = _read_counts()
    out["train_s"] = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    serve = A.probe_serve(A.serve_space(False))
    out["serve_launches"] = _read_counts()
    out["serve_s"] = time.perf_counter() - t0
    tl, sl = out["train_launches"], out["serve_launches"]
    check(tl["dc_norms"] > 0 and tl["dc_fused_update"] > 0,
          f"autotune train probe launched A1/A2 {tl}")
    check(sl["paged_attention"] > 0 and sl["flash_attention"] > 0,
          f"autotune serve probe launched B4/B5 {sl}")
    for r in train:
        print(f"[autotune] train {r['config']}: {r['ms_per_step']:.3f} "
              f"ms/step measured (median of {len(r['step_ms'])} steps by "
              f"CUDA events, {min(r['step_ms']):.3f}-"
              f"{max(r['step_ms']):.3f}), {r['predicted_ms']:.3f} predicted "
              f"(wire "
              f"term {r['predicted_comm_s'] * 1e3:.4f} ms) [{smi}]")
    for r in serve:
        print(f"[autotune] serve {r['config']}: {r['tokens_per_s']:.1f} "
              f"tokens/s measured (runs {[round(x, 1) for x in r['run_tps']]}"
              f"), {r['predicted_tokens_per_s']:.1f} "
              f"predicted, {r['tokens']} tokens, {r['decode_steps']} decode "
              f"steps [{smi}]")
    blob = {"version": 1, "smoke": False, "device": "cuda", "card": smi,
            "hardware": {"peak_flops_bf16": A.PEAK_FLOPS_BF16,
                         "hbm_bw": A.HBM_BW, "nvlink_bw": A.NVLINK_BW},
            "train": A.train_entry(train), "serve": A.serve_entry(serve)}
    # the adoption rule, restated: the best candidate is tuned only when
    # it beats the default by more than the larger range of the two
    # candidates' samples (steps / runs); else the default is
    for side, key, samples, sign in (("train", "ms_per_step", "step_ms", -1),
                                     ("serve", "tokens_per_s", "run_tps",
                                      1)):
        b = blob[side]
        recs = b["candidates"]
        d = next(r for r in recs if r["config"] == b["default"])
        best = max(recs, key=lambda r: sign * r[key])
        width = max(max(r[samples]) - min(r[samples]) for r in (best, d))
        clears = best is not d and sign * (best[key] - d[key]) > width
        want = best if clears else d
        print(f"[autotune] {side}: best {best['config']} {best[key]:.3f} "
              f"vs default {d[key]:.3f}, spread {width:.3f}: "
              f"{'adopted' if clears else 'within the spread, default kept'}"
              f" [{smi}]")
        check(b["adopted"] == clears and b["tuned"] == want["config"]
              and b["margin_" + ("ms" if sign < 0 else "tps")] == width,
              f"autotune {side}: tuned {b['tuned']} (adopted "
              f"{b['adopted']}) but the rule gives {want['config']} "
              f"(adopted {clears}, spread {width})")
    check(blob["train"]["tuned_ms"] <= blob["train"]["default_ms"],
          "autotune: tuned ms/step above the default's")
    check(blob["serve"]["tuned_tps"] >= blob["serve"]["default_tps"],
          "autotune: tuned tokens/s below the default's")
    t, v = blob["train"], blob["serve"]
    path = ROOT / "chiprun_out" / "autotune.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(blob, indent=2))
    print(f"[autotune] train: default {t['default']} "
          f"{t['default_ms']:.3f} ms/step -> tuned {t['tuned']} "
          f"{t['tuned_ms']:.3f}; serve: default {v['default']} "
          f"{v['default_tps']:.1f} tokens/s -> tuned {v['tuned']} "
          f"{v['tuned_tps']:.1f}; greedy tokens identical across "
          f"{len(serve)} serve candidates; probes {out['train_s']:.1f} s + "
          f"{out['serve_s']:.1f} s; blob -> {path.relative_to(ROOT)} "
          f"[{smi}]")
    out["blob"] = blob
    return out


def phase_lint_card(smi: str) -> dict:
    """The lint passes on the card (`repro_torch.analysis.lint`): dc_s3gd
    on qwen3-0.6b x4 (W = 2, 4 x 256 tokens a worker, fused kernels) at
    mean_allreduce and topk, inline and overlapped (bf16 wire), and the
    int8 point: 0 findings, each traced step under
    set_sync_debug_mode("error") (0 host syncs), the donation pass's
    memory check and weak references, the retrace pass's caches steady;
    A1 / A2 launched at every point, B3 at the bf16 topk points."""
    from repro_torch.analysis import lint as L
    rec = {}
    for reducer, overlap, wire in LINT_POINTS:
        point = L.GridPoint("dc_s3gd", reducer, N_BUCKETS, overlap,
                            wire=wire)
        _zero_counts()
        t0 = time.perf_counter()
        prog = L.Program(point, model="transformer", device="cuda",
                         use_kernels=True)
        found = L.run_point(prog)
        launches = _read_counts()
        secs = time.perf_counter() - t0
        print(f"[lint] {point.name} on qwen3-0.6b x4: {len(found)} "
              f"findings, launches {launches}, {secs:.1f} s [{smi}]")
        for f in found:
            print(f"[lint]   {f.pass_name} {f.op} {f.location}: {f.message}")
        check(not found, f"lint {point.name}: {len(found)} findings")
        check(prog.sync_error is None, f"lint {point.name}: host sync")
        check(launches["dc_norms"] > 0 and launches["dc_fused_update"] > 0,
              f"lint {point.name}: A1/A2 never launched")
        if reducer == "topk" and wire == "bfloat16":
            check(launches["select_ef_mean"] > 0,
                  f"lint {point.name}: B3 never launched")
        rec[point.name] = {"findings": len(found), "launches": launches,
                           "s": secs}
        del prog
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
    flash_shapes = phase_flash_shapes(smi)
    paged_shapes = phase_paged_shapes(smi)
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
    t0 = time.perf_counter()
    prefix = phase_serve_prefix(smi, model, params)
    prefix["phase_s"] = time.perf_counter() - t0
    print(f"[prefix] the prefix-cache phase took {prefix['phase_s']:.1f} s "
          f"[{smi}]")
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
    t0 = time.perf_counter()
    dense = phase_dense_family(smi, requests)
    dense["phase_s"] = time.perf_counter() - t0
    print(f"[dense] the stablelm-3b and granite-20b phases took "
          f"{dense['phase_s']:.1f} s [{smi}]")
    t0 = time.perf_counter()
    hybrid = {"flash": phase_flash_hybrid(smi)}
    hybrid["serve"] = phase_serve_hybrid(smi)
    hybrid["train"] = phase_train_recurrent(smi)
    hybrid["phase_s"] = time.perf_counter() - t0
    print(f"[hybrid] the recurrentgemma-9b and recurrent-training phases "
          f"took {hybrid['phase_s']:.1f} s [{smi}]")
    t0 = time.perf_counter()
    moe = {"kernels": phase_moe_kernel_shapes(smi)}
    moe["serve"] = phase_serve_moe(smi, requests)
    moe["train"] = phase_train_moe(smi)
    moe["mla"] = phase_serve_mla(smi, requests)
    moe["c5"] = phase_c5(smi)
    moe["phase_s"] = time.perf_counter() - t0
    print(f"[moe] the MoE, MLA and C5 phases took {moe['phase_s']:.1f} s "
          f"[{smi}]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mm = {"kernels": phase_multimodal_kernel_shapes(smi)}
    mm["vlm"] = phase_serve_vlm(smi)
    mm["whisper"] = phase_serve_whisper(smi)
    mm["train"] = phase_train_multimodal(smi)
    mm["phase_s"] = time.perf_counter() - t0
    print(f"[mm] the qwen2-vl-7b and whisper-large-v3 phases took "
          f"{mm['phase_s']:.1f} s [{smi}]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s13 = {"roofline": phase_roofline(smi)}
    s13["lint"] = phase_lint_card(smi)
    s13["settings"] = phase_new_settings(smi)
    s13["autotune"] = phase_autotune(smi)
    s13["phase_s"] = time.perf_counter() - t0
    print(f"[analysis] the roofline, lint, kernel-settings and autotune "
          f"phases took {s13['phase_s']:.1f} s [{smi}]")
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
    for name in ("dc_norms", "dc_fused_update"):
        k = dense["stablelm_kernels"][name]
        print(f"[times] {name} on stablelm-3b x4: {k['ms']:.4f} ms per "
              f"step ({len(dense['stablelm_train']['bucket_sizes'])} "
              f"launches, W={W}), plain {k['plain_ms']:.4f} ms, byte bound "
              f"{k['bound_ms']:.4f} ms, max abs err {k['err']:.3g} [{smi}]")
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
    for S in (512, 2048, 4096):
        f, b = (hybrid["flash"][f"S={S} {n}"] for n in ("f32", "bf16"))
        print(f"[times] flash_attention at recurrentgemma's local attention "
              f"(KV 1, G 16, hd 256, window {RG_WINDOW}) S={S}: f32 "
              f"{f['ms']:.4f} ms/launch (bound {f['bound_ms']:.4f}, sdpa "
              f"{f['library_ms']:.4f}), bf16 {b['ms']:.4f} (bound "
              f"{b['bound_ms']:.4f}, sdpa {b['library_ms']:.4f}) [{smi}]")
    hs = hybrid["serve"]
    print(f"[times] serve recurrentgemma-9b x{RG_LAYERS}, 8 slots: "
          f"{hs['decode_tokens_per_s']:.1f} decode tok/s, "
          f"{hs['step_ms']:.3f} ms/decode step, TTFT p50/p95 "
          f"{hs['p50_ttft_s'] * 1e3:.1f}/{hs['p95_ttft_s'] * 1e3:.1f} ms, "
          f"peak {hs['peak_bytes'] / 2**30:.3f} GiB; flash_attention "
          f"{hs['launches']['flash_attention']} launches = {RG_LOCAL} x "
          f"{hs['prefills']} prefills [{smi}]")
    ft = hybrid["train"]["falcon_mamba"]
    print(f"[times] train falcon-mamba-7b x{FM_TRAIN_LAYERS}, W={W}: step "
          f"{ft['step_ms']:.3f} ms, peak {ft['peak_bytes'] / 2**30:.3f} GiB"
          f" [{smi}]")
    for name in ("dc_norms", "dc_fused_update"):
        k = hybrid["train"]["falcon_mamba_kernels"][name]
        print(f"[times] {name} on falcon-mamba-7b x{FM_TRAIN_LAYERS}: "
              f"{k['ms']:.4f} ms per step ({len(ft['bucket_sizes'])} "
              f"launches, W={W}), plain {k['plain_ms']:.4f} ms, byte bound "
              f"{k['bound_ms']:.4f} ms, max abs err {k['err']:.3g} [{smi}]")
    for key, what in (("olmoe", f"olmoe-1b-7b x{OLMOE_LAYERS}"),
                      ("phi", f"phi3.5-moe x{PHI_LAYERS}")):
        r = moe["serve"][key]
        print(f"[times] serve {what}, 16 slots, bf16 KV, paged kernel: "
              f"{r['decode_tokens_per_s']:.1f} decode tok/s, "
              f"{r['step_ms']:.3f} ms/decode step, TTFT p50/p95 "
              f"{r['p50_ttft_s'] * 1e3:.1f}/{r['p95_ttft_s'] * 1e3:.1f} ms, "
              f"peak {r['peak_bytes'] / 2**30:.3f} GiB; B4 "
              f"{r['launches']['paged_attention']}, B5 "
              f"{r['launches']['flash_attention']} launches [{smi}]")
    r = moe["mla"]["whole"]
    print(f"[times] serve minicpm3-4b x{MINICPM_LAYERS} (MLA), 16 slots, "
          f"bf16 latent pages: {r['decode_tokens_per_s']:.1f} decode tok/s,"
          f" {r['step_ms']:.3f} ms/decode step, TTFT p50/p95 "
          f"{r['p50_ttft_s'] * 1e3:.1f}/{r['p95_ttft_s'] * 1e3:.1f} ms, "
          f"peak {r['peak_bytes'] / 2**30:.3f} GiB; "
          f"{moe['mla']['token_bytes']['minicpm3']} B a token [{smi}]")
    ot = moe["train"]["olmoe"]
    print(f"[times] train olmoe-1b-7b x1, W={W}, routed: step "
          f"{ot['step_ms']:.3f} ms, peak {ot['peak_bytes'] / 2**30:.3f} GiB"
          f" [{smi}]")
    for name in ("dc_norms", "dc_fused_update"):
        k = moe["train"]["olmoe_kernels"][name]
        print(f"[times] {name} on olmoe-1b-7b x1: {k['ms']:.4f} ms per step "
              f"({len(ot['bucket_sizes'])} launches, W={W}), plain "
              f"{k['plain_ms']:.4f} ms, byte bound {k['bound_ms']:.4f} ms, "
              f"max abs err {k['err']:.3g} [{smi}]")
    for key, what in (("vlm", f"qwen2-vl-7b x{VLM_LAYERS}"),
                      ("whisper", f"whisper-large-v3 x{WHISPER_LAYERS} + "
                                  f"encoder x{WHISPER_LAYERS}")):
        r = mm[key]["routes"]
        print(f"[times] serve {what} one-shot {mm[key]['oneshot']['wall_s']:.2f}"
              f" s with its init; paged, f32 pools: TTFT {r['ttft_s']:.3f} s, "
              f"{r['step_ms']:.3f} ms/decode step, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB; B4 "
              f"{r['launches']['paged_attention']}, B5 "
              f"{r['launches']['flash_attention']} launches [{smi}]")
    wt = mm["train"]["whisper"]
    print(f"[times] train whisper-large-v3 x{WHISPER_TRAIN_LAYERS} + encoder "
          f"x{WHISPER_TRAIN_LAYERS}, W={W}: step {wt['step_ms']:.3f} ms, peak "
          f"{wt['peak_bytes'] / 2**30:.3f} GiB [{smi}]")
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
    # B4 and B5 on each serve path of this run (counts zeroed before each
    # and read after), and at each new shape beside its bound
    paths = {"serve qwen3 (main)": served["launches"],
             "prefix qwen3 hot": prefix["hot"]["launches"],
             "prefix qwen3 cold": prefix["cold"]["launches"],
             "prefix qwen3 small pool": prefix["small_pool"]["launches"],
             "serve stablelm-3b": dense["stablelm"]["launches"],
             "serve stablelm-3b chunked":
                 dense["stablelm_chunked"]["launches"],
             "serve granite-20b x12": dense["granite"]["launches"],
             "serve olmoe-1b-7b x16": moe["serve"]["olmoe"]["launches"],
             "serve phi3.5-moe x8": moe["serve"]["phi"]["launches"]}
    shapes = {"paged_attention": {**paged_shapes,
                                  **moe["kernels"]["paged"],
                                  **mm["kernels"]["paged"]},
              "flash_attention":
              {**{k: v for k, v in flash_shapes.items()
                  if isinstance(v, dict)},
               **{f"recurrentgemma {k}": v
                  for k, v in hybrid["flash"].items()},
               **moe["kernels"]["flash"], **mm["kernels"]["flash"]}}
    # minicpm3's paths (latent pages by gather, the plain prefill core)
    mla_paths = {"serve minicpm3-4b x62": moe["mla"]["whole"]["launches"],
                 "serve minicpm3-4b int8": moe["mla"]["int8"]["launches"],
                 "prefix minicpm3 hot": moe["mla"]["hot"]["launches"],
                 "prefix minicpm3 cold": moe["mla"]["cold"]["launches"]}
    hybrid_paths = {"serve recurrentgemma-9b": hybrid["serve"]["launches"]}
    # the new families: B5 on their one-shot and paged paths, B4 on the
    # paged ones (the one-shot decode reads the dense cache)
    mm_paths = {
        "flash_attention": {
            "oneshot qwen2-vl-7b": mm["vlm"]["oneshot"]["launches"],
            "paged qwen2-vl-7b": mm["vlm"]["routes"]["launches"],
            "oneshot whisper-large-v3": mm["whisper"]["oneshot"]["launches"],
            "paged whisper-large-v3": mm["whisper"]["routes"]["launches"]},
        "paged_attention": {
            "paged qwen2-vl-7b": mm["vlm"]["routes"]["launches"],
            "paged whisper-large-v3": mm["whisper"]["routes"]["launches"]}}
    for entry in kernels:
        name = entry["name"]
        if name in shapes:
            entry["launches_by_path"] = {
                p: n[name] for p, n in {
                    **paths, **(hybrid_paths if name == "flash_attention"
                                else {}), **mm_paths[name]}.items()}
            entry["shapes"] = {c: {f: r[f] for f in (
                "ms", "plain_ms", "bound_ms", "library_ms", "err",
                "gather_sdpa_ms")
                if f in r} for c, r in shapes[name].items()}
            check(all(n > 0 for n in entry["launches_by_path"].values()),
                  f"{name}: a serve path launched it no time: "
                  f"{entry['launches_by_path']}")
            entry["launches_on_mla_paths"] = {p: n[name]
                                              for p, n in mla_paths.items()}
            check(not any(entry["launches_on_mla_paths"].values()),
                  f"{name} launched on an MLA path")
    # slice 13: where the analysis phases launched each kernel, A1 / A2 at
    # 2·BLOCK padding and B4 at pages of 8 and 32, each beside its bound
    for entry in kernels:
        name = entry["name"]
        entry["analysis"] = {
            "launches_autotune_train": s13["autotune"]["train_launches"][name],
            "launches_autotune_serve": s13["autotune"]["serve_launches"][name],
            "launches_lint": {p: r["launches"][name]
                              for p, r in s13["lint"].items()}}
        if name in s13["settings"]["two_block"]:
            k = s13["settings"]["two_block"][name]
            entry["analysis"]["two_block"] = {
                "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes", "bucket_sizes":
                    s13["settings"]["bucket_sizes"]}
        if name == "paged_attention":
            entry["analysis"]["pages"] = s13["settings"]["paged"]
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
            # and on stablelm-3b x4's training path (2 steps, W = 2), per
            # step over its bucket sizes
            k = dense["stablelm_kernels"][entry["name"]]
            entry["stablelm"] = {
                "launches": dense["stablelm_train"]["launches"][
                    entry["name"]],
                "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes"}
            # and on falcon-mamba-7b x2's training path (5 steps, W = 2)
            k = hybrid["train"]["falcon_mamba_kernels"][entry["name"]]
            entry["falcon_mamba"] = {
                "launches": hybrid["train"]["falcon_mamba"]["launches"][
                    entry["name"]],
                "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes"}
            # and on olmoe-1b-7b x1's routed training path (5 steps, W = 2)
            k = moe["train"]["olmoe_kernels"][entry["name"]]
            entry["olmoe"] = {
                "launches": moe["train"]["olmoe"]["launches"][
                    entry["name"]],
                "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes"}
            # and on whisper-large-v3 x8 + x8's training path (3 steps,
            # W = 2)
            k = mm["train"]["whisper_kernels"][entry["name"]]
            entry["whisper"] = {
                "launches": mm["train"]["whisper"]["launches"][
                    entry["name"]],
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
              "cnn": cnn, "state": state, "flash_shapes": flash_shapes,
              "paged_shapes": paged_shapes, "serve_prefix": prefix,
              "dense_family": dense, "hybrid": hybrid, "moe_mla": moe,
              "vlm_encdec": mm, "analysis": s13,
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

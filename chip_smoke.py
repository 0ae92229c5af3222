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
10. serving falcon-mamba-7b at its published widths and 16 of its 64
   layers (since PR 26, for the time limit; f32 params, bf16 compute, random weights from seed 0) through
   ``repro_torch.launch.serve`` over the same 48 requests (token ids under
   its 65,024 vocab), ``--slots 16 --decode-burst 4``, greedy: every
   request completes at its length, the page pool is never touched,
   ssm_scan launches once per layer and prefill, no host synchronisation inside
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
   4 of its 28 layers (since PR 26, for the time limit) over 32 requests behind one 392-token system prompt
   (request 0 first, then 31 together) through ``repro_torch.launch.
   serve``'s scheduler with ``--prefill-chunk 128 --prefix-cache``: greedy
   tokens bitwise the cold chunked run's, >= 31 hits, >= 1 copy-on-write,
   fewer pages than cold, B5 at q_start > 0 (one per layer and chunk),
   B4 one per layer and decode step, last-chunk logits within 2^-5 of the whole-prompt
   prefill's largest logit, TTFT / inter-token latency beside the
   whole-prompt run, a 120-page pool that preempts and finishes every
   request; the chunk route against its plain route (2^-7).
   stablelm-3b at 8 of its 32 layers (since PR 26, for the time limit)
   serves 16 requests whole-prompt and chunked (B4 / B5 one per layer and
   step / prefill or chunk), routes checked, and trains two dc_s3gd steps at depth 4, W =
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
   recurrentgemma-9b at its published widths and 14 of its 38 layers
   (since PR 26, for the time limit; f32 weights from seed 0, bf16
   compute) through
   ``repro_torch.launch.serve`` over 16 requests (prompts 512 / 2,040 /
   2,560 / 4,096, gen 32..64 from seed 0; ``--slots 8 --decode-burst 4``,
   greedy, whole-prompt): every request at its length, B5 once per
   local-attention layer (4) and prefill and nothing else, the pool untouched, the slot state (rings
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
   and 8 of its 16 layers (since PR 26, for the time limit; f32 weights
   from seed 0, bf16 compute and KV) over phase 8's 48 requests: B4 one
   per layer and decode step, B5 one per layer and prefill, the routed prefill and the dropless decode;
   the dropless FFN against the all-experts oracle at its widths (2^-16
   of the largest output); kernel route == plain route greedy on 4
   requests over f32 pools; 0 host syncs a burst, two bursts profiled.
   phi3.5-moe-42b-a6.6b cut to 8 of 32 layers (10,666,708,992 params)
   serves 8 requests (B4 / B5 at G 4).  olmoe cut to 1 layer trains 5
   routed dc_s3gd steps at W = 2 (80 slots per expert; finite losses and
   aux loss, A1/A2 once per bucket and step, step time, peak), A1/A2
   against their plain versions at its bucket sizes; minicpm3-4b cut to 2
   layers trains 2 steps.  minicpm3-4b at 16 of its 62 layers (since PR
   26, for the time limit) on bf16 latent pages (at 62 layers 35,712 B a
   token beside qwen3's 114,688): 16 requests whole-prompt, 8 over int8 pools, two
   bursts profiled, then phase 12's 32 shared-prompt requests chunked
   (128) with and without the prefix cache, block tables 45 pages wide
   (greedy tokens bitwise, >= 31 hits, copy-on-write, fewer pages); B4
   and B5 never launch on its path (the prefix requests at 4 of its 62
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
   float64 (1e-6).  qwen2-vl-7b at its published widths and 8 of its 28
   layers (since PR 26, for the time limit; f32 weights from seed 0,
   bf16 compute) served one-shot through ``repro_torch.launch.serve`` (4
   prompts of 1,024 stub patches + 128 tokens, 32 generated, greedy: B5
   once per layer), then the same batch through `PagedLayout` over f32
   pools (B4 once per layer and decode step): kernel route == plain route on every
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
   8 train candidates and 12 serve candidates (qwen3-0.6b cut to 14 of
   its 28 layers, for the script's time limit) measured beside their
   predictions, tuned <= default ms/step, tuned >= default tokens/s,
   greedy tokens identical across the serve candidates; the blob in
   ``chiprun_out/autotune.json``.

17. the worker axis over real process groups: (a) the main cell on an
   NCCL mesh of one rank (``init_device_mesh("cuda", (1, 1))``, a
   ``file://`` store), ``Engine(model, alg, mesh)``, 3 steps inline and
   3 overlapped, each bitwise the ``mesh=None`` run (params, opt,
   delta_prev, losses; deterministic algorithms), A1 / A2 12 times a run,
   0 host syncs in a steady step, the step beside ``mesh=None``'s; (b)
   two gloo ranks on the one card (spawned; NCCL refuses two ranks on
   one device): ResNet-18's layout at W = 8, 3 steps, the gathered params
   and losses within 1e-5 of the one-process run, A1 / A2 18 times a
   rank; (c) ``repro_torch.launch.dryrun`` for qwen3-0.6b x decode_32k
   and x train_4k on the pod mesh, rank 0's step at 'model' 16, in
   subprocesses started with the script (nothing placed on the card):
   ``status: ok``, the per-device argument, temp and peak bytes and the
   collectives over 'model' (records in ``chiprun_out/dryrun_torch``).
   After (a), what device memory outlives a training run, named from the
   allocator's history (`_leftover_probe`).

18. tensor parallelism over the mesh's 'model' axis (gloo ranks sharing
   the card, spawned): (a) qwen3-0.6b at its published widths, depth 28
   -> 4, W = 2, on a (1, 2) mesh, 3 steps through ``Engine(model, alg,
   mesh)``; (c) olmoe-1b-7b at depth 1, W = 2, 32 of its 64 experts a
   rank, on the same ranks; (b) qwen3 at depth 2, computing in f32, on a
   (2, 2) mesh of four ranks; the launcher's Model (no remat, attention
   in blocks of 64 x 64 on each rank's local heads).  Each rank first
   runs the cell with ``mesh=None`` (one rank at a time; in (a) and (b)
   rank 0 alone, which sends each rank its slices) and keeps the slices
   it holds; its shards of the weights then lie within 1e-5 of each
   leaf's scale from them and the metrics within 1e-5; the updates
   (momentum, deltas) within 1e-5 at f32 compute, within 1e-3 at the
   published bf16 compute, where the embedding's rows enter the first
   block in bf16 (`tok` and the first norm within 2e-2); the replicated
   leaves bitwise equal across the model ranks after every step, A1 / A2
   once per local bucket and step on every rank; each rank's peak beside
   mesh=None's.
   Since slice 19 also the compressed and quantized wires on qwen3 x2
   at f32 (the dense wire, topk 1 %, topk_exact, randk, powersgd, int8,
   fp8 per leaf): each reduces the whole buckets gathered over 'model',
   is held to its twin by a count of flipped coordinates, its reducer
   state bitwise across the model ranks, B3 12 = 3 x 4 whole buckets a
   rank under topk / topk_exact (its cross-rank modes first held to its
   plain version at the whole size the main cell's check lacks), each
   cell's peak a rank printed beside the dense wire's.

19. the paper's worker axis across ranks for every reducer: (a) the main
   cell on an NCCL mesh of one rank under gossip, hierarchical, topk 1 %,
   topk_exact, randk, powersgd, dynamic_ssp (worker 0 scripted 3x
   slower: step 2 revoked) and dc_asgd, 3 steps each, ``mesh=None`` and
   the mesh in turn, bitwise in params, opt, comm and metrics, A1 / A2 12
   times a DC-S3GD run, B3 12 times a topk / topk_exact run; (b) two gloo
   ranks on the card, ResNet-18's layout at W = 8, 3 steps of gossip,
   hierarchical (groups 1, 2, 4), topk_exact, powersgd, dynamic_ssp,
   dc_asgd and an elastic 8 -> 6 -> 4 stale run, each within 1e-5 of the
   one-process run (gossip, hierarchical, dc_asgd bitwise; the elastic
   run at each part's scale, ``eval_params`` bitwise across each resize,
   the transition log equal), the metrics the same on both ranks; (c)
   topk_exact on the main cell over two gloo ranks, one row a rank, B3
   with the cross-rank union mask 12 times a rank, each rank's rows
   within 1e-5 of one process, each rank's peak.  B3's partial and mask
   modes are held bitwise to the plain version in the kernel phases, at
   the main cell's and the CNN's bucket sizes.

20. serving over the mesh (gloo ranks sharing the card, spawned; each
   cell's one-process twin first, in this process): B5 at the local
   shapes of a 'model' axis of 2 (qwen3's 4 of 8 KV heads, granite's G
   24, whisper's encoder and cross-attention on 10 of 20 heads) and B6
   on falcon-mamba's 4,096 of 8,192 channels, against their plain
   versions, timed beside bound, plain version and SDPA; then (a)
   qwen3-0.6b at its widths and 8 of 28 layers (28 until slice 19 made
   room for phase 18's wire cells) over (1, 2), 4 prompts of 512
   tokens and 64 generated, at f32 and at the served bf16 compute, and
   each family at the smallest depth that holds its block kinds
   (granite-20b x1: KV by position; falcon-mamba-7b x1; recurrentgemma-9b
   x3: a ring by position; minicpm3-4b x1: latents by position;
   olmoe-1b-7b x1: 32 of 64 experts a rank; whisper-large-v3 1 + 1;
   qwen2-vl-7b x1), f32, over (1, 2); (b) qwen3 at 4 of 28 layers over
   (2, 2), four ranks, a pair of rows a data rank.  Through
   ``Engine(model, mesh=mesh)`` without an algorithm: each rank's logits
   (teacher-forced on the twin's tokens) within 1e-5 of each step's
   scale (bf16: 2^-9, tokens up to the first position of low twin
   margin and wherever the margin clears twice the bound), its greedy
   tokens and ``Engine.generate``'s (f32) equal to the twin's, its cache
   bytes equal to
   ``shard_bytes`` under ``cache_specs``, B5 / B6 once per attention /
   Mamba block and prefill; each rank's peak beside the twin's.

21. the example twins (quickstart, serve_batched, train_lm_100m) as a
   user runs them.

22. long-sequence training: the main cell at train_4k's 4,096-token
   sequences, the Model at the reference's defaults (attention in blocks
   of 512 x 1,024, loss chunks of 2,048): (i) one sequence a worker,
   ``remat`` off and on, 3 steps each on the fused tail, bitwise the
   same state, each run's peak, step time and A1 / A2 launches; (ii) the
   largest batch ``remat`` fits, by arithmetic from the peaks, and
   whether ``remat`` off fits it, then a step at it; (iii) the plain
   tail's traced step on the card beside the dry-run's fake-mode peak of
   the same step, within 10 %; then the plain core at one key block,
   its online softmax and the plain softmax it takes, timed.

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
import os
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


def phase_select_modes(sizes, n_workers: int, smi: str,
                       tag: str = "kernels") -> dict:
    """B3's cross-rank modes against the plain version, bitwise, at
    ``sizes`` (one bucket a launch) and ``n_workers`` rows, f32 and bf16
    wires: the partial row sum, the external union mask, both; and the
    partial sum finished by `finish_mean` against the full mode's mean.
    These comparison launches are no path's."""
    from repro_torch.core.compress import _k_of, magnitude_threshold
    from repro_torch.kernels import compress as KC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    modes = ("partial", "mask", "mask+partial", "finish_mean")
    for n in sizes:
        a = torch.randn((n_workers, n), generator=gen, device=dev) \
            * torch.rand((n_workers, n), generator=gen, device=dev) ** 4
        t = magnitude_threshold(a.abs(), _k_of(n, 0.01))
        mask = (a.abs() >= t.reshape(-1, 1)).any(0, keepdim=True) \
            .to(torch.uint8)
        for dt in (torch.float32, torch.bfloat16):
            for kw in ({"union": False, "partial": True},
                       {"union": True, "mask": mask},
                       {"union": True, "mask": mask, "partial": True}):
                got = KC.select_ef_mean(a, t, comm_dtype=dt, **kw)
                want = KC.select_ef_mean_plain(a, t, comm_dtype=dt, **kw)
                for x, y in zip(got, want):
                    check(torch.equal(x, y), f"select_ef_mean {kw.keys()} "
                          f"not bitwise the plain version: n={n} {dt}")
                del got, want
            for union in (False, True):
                full, _ = KC.select_ef_mean(a, t, comm_dtype=dt, union=union)
                part, _ = KC.select_ef_mean(a, t, comm_dtype=dt, union=union,
                                            partial=True)
                check(torch.equal(KC.finish_mean(part, n_workers, dt), full),
                      f"select_ef_mean partial + finish_mean is not the "
                      f"full mean: n={n} {dt} union={union}")
                del full, part
        del a, t, mask
        torch.cuda.empty_cache()
    print(f"[{tag}] select_ef_mean cross-rank modes {', '.join(modes)} "
          f"bitwise the plain version at W={n_workers}, n in "
          f"{tuple(sizes)}, f32 and bf16 wires [{smi}]")
    return {"modes": list(modes), "sizes": list(sizes), "W": n_workers}


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


def _device_groups(avgs, groups: dict, other: str):
    """(kernels by device time, busy ms, ms by group) of a profile's
    ``key_averages()``: each kernel goes to the first group one of whose
    keys its name holds.  The profiles record CUDA activity only (the
    kernels, copies and runtime calls; since PR 26): the host's operator
    events cost seconds to parse and added their own overhead to the
    profiled window."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in avgs
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    avgs = prof.key_averages()
    kernels, busy_ms, by_group, dev_us = _device_groups(avgs, groups,
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
        avgs.table(sort_by="self_cuda_time_total",
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    avgs = prof.key_averages()
    kernels, busy_ms, by_group, dev_us = _device_groups(avgs, groups, other)
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
        avgs.table(sort_by="self_cuda_time_total",
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    avgs = prof.key_averages()
    kernels, busy_ms, by_group, dev_us = _device_groups(
        avgs, groups, "other (elementwise, norms, softmax, argmax)")
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
        avgs.table(sort_by="self_cuda_time_total",
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
# the prefix traffic's depth: 28 -> 4 since PR 26 (for the script's 1,200 s
# limit: at 28 layers its four host-bound runs took 68-104 s); the pins
# (hit == cold bitwise, the hits, CoW, preemption) do not depend on it
PREFIX_LAYERS = 4


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


def phase_serve_prefix(smi: str) -> dict:
    """qwen3-0.6b at ``PREFIX_LAYERS`` of its 28 layers (published widths,
    f32 weights from seed 0) over the prefix traffic, through
    ``repro_torch.launch.serve``'s scheduler with ``--prefill-chunk 128
    --prefix-cache --slots 16 --pages 641 --page-size 16 --decode-burst 4
    --paged-kernel``, greedy, seed 0: request 0 alone, then the other 31
    together.  Checks: every request finishes at its length; the greedy
    tokens are bitwise those of the same schedule without the prefix cache
    (cold chunked); >= 31 hits, >= 1 copy-on-write, fewer token slots
    allocated than the cold run; B5 launches at q_start > 0 and once per
    layer and chunk, B4 once per layer and decode step; each request's
    last-chunk
    logits within 2^-5 of the largest logit of its whole-prompt prefill's
    (the chunk route attends over the pages' bf16 keys and values, the
    whole prompt over its f32 ones: bf16's 2^-9 in every layer's k and v,
    with room for its growth through 28 layers, more than this depth's),
    the count of first
    tokens that agree printed; a 120-page pool (preemptions > 0) finishes
    every request with no refcount error.  The whole-prompt run of the
    same requests and schedule is printed beside them."""
    from repro_torch.launch import serve
    model, params, _ = serve.build(serve.build_argparser().parse_args(
        SERVE_ARGS + ["--layers", str(PREFIX_LAYERS)]))
    check(model.cfg.n_layers == PREFIX_LAYERS, "[prefix] depth")
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
    del model, params
    torch.cuda.empty_cache()
    return rec


DENSE_ARGS = ["--slots", "16", "--pages", "641", "--page-size", str(PAGE),
              "--decode-burst", "4", "--seed", "0", "--paged-kernel"]
# the served depth: 32 -> 8 since PR 26 (for the script's 1,200 s limit;
# the serve steps are host-bound)
STABLELM_LAYERS = 8
STABLELM_ARGS = ["--arch", "stablelm-3b", "--layers", str(STABLELM_LAYERS),
                 *DENSE_ARGS]
STABLELM_PARAMS = 892_687_360        # 2,796,098,560 at 32 layers
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
    """stablelm-3b at its published widths and ``STABLELM_LAYERS`` of its
    32 layers (f32 weights from seed 0, bf16 compute and KV): 16 of the
    serve phase's requests whole-prompt and then in chunks of 128 through
    ``repro_torch.launch.serve`` (every request at its length, B4 once
    per layer and decode step, B5 once per layer and prefill or chunk), its prefill logits
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
# serving falcon-mamba-7b (kernel B6 in every prefill)
# ---------------------------------------------------------------------------

# depth 64 -> 16 since PR 26 (for the script's 1,200 s limit; the serve
# steps are host-bound, so their time goes with the depth)
FM_LAYERS = 16
FM_ARGS = ["--arch", "falcon-mamba-7b", "--layers", str(FM_LAYERS),
           "--slots", "16", "--decode-burst", "4", "--seed", "0"]
FM_PARAMS = 2_217_676_800     # 16 x 105,312,256 + 2 x 65,024 x 4,096 + 4,096


def phase_serve_ssm(smi: str, path: Path) -> dict:
    """Serve the request file with falcon-mamba-7b at its published widths
    and ``FM_LAYERS`` of its 64 layers through ``repro_torch.launch.serve``
    (f32 params from seed 0, bf16 compute, 16 slots, bursts of 4, greedy).
    Every kernel count is set to 0 just before the run and read just
    after: ssm_scan once per layer and prefill, nothing else.  Then the host synchronisations of a
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
    check(cfg.n_layers == FM_LAYERS and cfg.d_model == 4096
          and cfg.ssm.state_dim == SSM_N and n_params == FM_PARAMS,
          f"falcon-mamba-7b at full width: {cfg}, {n_params}")
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
    check(launches["ssm_scan"] == FM_LAYERS * prefills,
          f"[serve-ssm] ssm_scan launched {launches['ssm_scan']} times, "
          f"expected {FM_LAYERS} layers x {prefills} prefills")
    check(all(n == 0 for k, n in launches.items() if k != "ssm_scan"),
          f"[serve-ssm] other kernels launched: {launches}")
    check(not sch.layout.uses_pages and sch.pool.used_pages == 0
          and sch.pool.total_allocs == 0, "[serve-ssm] the page pool was "
          "touched")
    state = sch.cache[0]["b0"]
    check(state["conv"].dtype == torch.bfloat16
          and state["ssm"].dtype == torch.float32
          and tuple(state["ssm"].shape) == (FM_LAYERS, 16, SSM_E, SSM_N),
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
    print(f"[serve-ssm] falcon-mamba-7b x{FM_LAYERS} ({n_params} params, f32,"
          f" init {init_s:.1f} s): {len(reqs)} requests, {s['tokens']} "
          f"tokens in "
          f"{wall:.3f} s ({rec['tokens_per_s']:.1f} tok/s); decode "
          f"{decode_tokens} tokens in {steps} steps, {decode_s:.3f} s "
          f"({rec['decode_tokens_per_s']:.1f} tok/s, {rec['step_ms']:.3f} "
          f"ms/step); {prefills} prefills; ssm_scan launches "
          f"{launches['ssm_scan']} = {FM_LAYERS} x {prefills}; pool untouched "
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
# the recurrent families: recurrentgemma-9b served (B5 on its
# local attention, RG-LRU and the slot ring), falcon-mamba and
# recurrentgemma trained through the chunked scan
# ---------------------------------------------------------------------------

# recurrentgemma-9b's local attention: one kv head, G 16, hd 256, a
# 2,048-token window, in its 12 attention_local blocks
RG_SHAPE = (1, 16, 256)
RG_WINDOW = 2048
RG_LOCAL = 12                 # local-attention layers of the 38
# the served depth: 38 -> 14 since PR 26 (for the script's 1,200 s limit;
# the serve steps are host-bound): 4 (recurrent, recurrent, local) units
# and the closing (recurrent, recurrent), as the full model ends
RG_LAYERS = 14
RG_SERVE_LOCAL = 4
RG_PARAMS = 5_192_912_896     # 10,444,771,328 at 38 layers
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
    ``RG_LAYERS`` of its 38 layers (f32 weights from seed 0, bf16 compute)
    through ``repro_torch.launch.serve``, ``--slots 8
    --decode-burst 4``, greedy, whole-prompt.  Every kernel count is set to
    0 just before the run and read just after: flash_attention once per
    local-attention layer and prefill (B5 over the window), nothing else; the page pool
    untouched; the slot state (rings, RG-LRU) at its shapes.  Then the
    host synchronisations of a steady burst and two bursts profiled, slot
    decode against dense decode bitwise past the ring's wrap, and the
    prefill's kernel route against its plain route."""
    from repro_torch import tree as T
    from repro_torch.launch import serve
    path = _write_rg_requests()
    args = serve.build_argparser().parse_args(
        RG_ARGS + ["--layers", str(RG_LAYERS), "--requests", str(path)])
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
          f"recurrentgemma-9b at full width: {cfg}, {n_params}")
    check([(st.kinds, st.repeats) for st in model.stages]
          == [(("recurrent", "recurrent", "attention_local"), RG_SERVE_LOCAL),
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
    check(launches["flash_attention"] == RG_SERVE_LOCAL * prefills,
          f"[serve-hybrid] flash_attention launched "
          f"{launches['flash_attention']} times, expected {RG_SERVE_LOCAL} x "
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
    check(tuple(c0["b2"]["k"].shape) == (RG_SERVE_LOCAL, 8, RG_WINDOW, 1, 256)
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
          f"{launches['flash_attention']} = {RG_SERVE_LOCAL} x {prefills}; "
          f"pool "
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
# the served depth: 16 -> 8 since PR 26 (for the script's 1,200 s limit;
# the serve steps are host-bound)
OLMOE_SERVE_LAYERS = 8
OLMOE_PARAMS = 3_563_098_112         # 6,919,624,704 at 16 layers
OLMOE_ARGS = ["--arch", "olmoe-1b-7b", "--layers", str(OLMOE_SERVE_LAYERS),
              *DENSE_ARGS]
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
# the served depth: 62 -> 16 since PR 26 (for the script's 1,200 s limit:
# at 62 layers the whole, int8 and profiled runs took ~45 s of host-bound
# steps); the latent token bytes are still read at all 62
MINICPM_LAYERS = 16
MINICPM_PARAMS = 1_378_978_304       # 4,262,025,728 at 62 layers
MINICPM_ARGS = ["--arch", "minicpm3-4b", *DENSE_ARGS]
MINICPM_TOKEN_BYTES = 62 * (256 + 32) * 2    # bf16 ckv + k_rope, 35,712
# the prefix check's depth: at 62 layers its hot and cold runs took
# 157-200 s of host-bound decode steps (6,225 launches a step); the
# bitwise pin does not depend on the depth (8 from PR 22, 4 since PR 26)
MINICPM_PREFIX_LAYERS = 4
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
    """olmoe-1b-7b at its published widths and ``OLMOE_SERVE_LAYERS`` of
    its 16 layers (f32 weights from seed 0, bf16 compute and KV) over
    phase 8's 48 requests through ``repro_torch.launch.serve`` with
    ``--slots 16 --pages 641 --page-size 16 --decode-burst 4
    --paged-kernel``, whole-prompt: every request at its length, B4 once
    per layer and decode step, B5 once per layer and prefill; the routed prefill
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
    print(f"[serve-olmoe] olmoe-1b-7b x{OLMOE_SERVE_LAYERS}: {n} params "
          f"({n * 4 / 1e9:.2f} GB f32; the experts {expert_bytes / 1e9:.2f}"
          f" GB, all read by each dropless decode step), init {init_s:.1f} s"
          f" [{smi}]")
    rec["olmoe"], _, reqs = phase_serve(
        smi, path, (), None, "serve-olmoe", (model, params, None),
        OLMOE_ARGS, OLMOE_SERVE_LAYERS)
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
    """minicpm3-4b at its published widths and ``MINICPM_LAYERS`` of its 62
    layers (f32 weights from seed 0, bf16 compute) on the paged latent
    pools (ckv 256 + k_rope 32 a token and layer): 16 of
    phase 8's requests whole-prompt, then 8 over int8 pools, through
    ``repro_torch.launch.serve`` (every request at its length; B4 and B5
    never launch: MLA's latent pages are read by gather and its prefill
    takes the plain core, as in the reference); the latent token bytes
    (at all 62 layers) beside qwen3-0.6b's; two decode bursts profiled (0 host syncs).  Then,
    at its published widths cut to 4 of its 62 layers, phase 12's 32
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
    args = serve.build_argparser().parse_args(
        MINICPM_ARGS + ["--layers", str(MINICPM_LAYERS), "--requests",
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
    mla_bytes = PagedLayout(Model(get_config("minicpm3-4b")),
                            **kw).kv_bytes_per_token()
    qwen_bytes = PagedLayout(Model(get_config("qwen3-0.6b")),
                             **kw).kv_bytes_per_token()
    print(f"[serve-minicpm3] latent pool bytes a token (bf16, 62 layers x "
          f"(256 + 32) x 2): {mla_bytes} B, against qwen3-0.6b's k + v "
          f"{qwen_bytes} B ({qwen_bytes / mla_bytes:.2f}x); int8 at "
          f"{MINICPM_LAYERS} layers: {rec['int8']['kv_bytes_per_token']} B "
          f"[{smi}]")
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
# the served depth: 28 -> 8 since PR 26 (for the script's 1,200 s limit;
# the decode steps are host-bound); B5 / B4 are timed at all 28 below
VLM_SERVE_LAYERS = 8
VLM_PARAMS = 2_967_268_864           # 7,628,332,544 at 28 layers
VLM_BATCH, VLM_PROMPT, VLM_GEN = 4, 128, 32
VLM_PATCHES = 1024
VLM_ARGS = ["--arch", "qwen2-vl-7b", "--layers", str(VLM_SERVE_LAYERS),
            "--batch", str(VLM_BATCH), "--prompt-len", str(VLM_PROMPT),
            "--gen", str(VLM_GEN)]
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
    """qwen2-vl-7b at its published widths and ``VLM_SERVE_LAYERS`` of its
    28 layers (f32 weights from seed 0, bf16 compute): 4 prompts of 1,024
    stub patch positions + 128 tokens, 32 generated, greedy, one-shot
    through ``repro_torch.launch.serve`` (B5 once per layer, causal at KV
    4, G 7, hd 128), then the same batch through `PagedLayout` over f32
    pools (B4 once per layer and decode step, M-RoPE
    positions (3, B, 1)), kernel route == plain route, two steps
    profiled."""
    from repro_torch.launch import serve
    rec = {"oneshot": _mm_oneshot(smi, VLM_ARGS, "serve-vlm",
                                  VLM_SERVE_LAYERS)}
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
    print(f"[serve-vlm] qwen2-vl-7b x{VLM_SERVE_LAYERS}: {n} params "
          f"({n * 4 / 1e9:.2f} GB f32), init {init_s:.1f} s [{smi}]")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT),
                            generator=gen, device="cuda")
    batch = {"tokens": prompts, **serve.stub_inputs(cfg, VLM_BATCH,
                                                    VLM_PROMPT, gen)}
    torch.cuda.reset_peak_memory_stats()
    routes = _mm_routes(smi, model, params, batch, VLM_PATCHES, VLM_GEN,
                        VLM_SERVE_LAYERS, VLM_SERVE_LAYERS, "serve-vlm",
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


def _mm_batches(cfg, workers: int, per_worker: int):
    """``batch_fn(it)``: (workers, per_worker) sequences of ``MM_SEQ``
    random tokens and labels (seed 1000 + it) carrying their stub inputs:
    a VLM's patches and tiled M-RoPE positions, an encoder-decoder's
    frames."""
    d, V = cfg.d_model, cfg.vocab_size

    def batch_fn(it, n_workers=None):
        g = torch.Generator(device="cuda").manual_seed(1000 + it)
        lead = (workers, per_worker)
        b = {"tokens": torch.randint(0, V, lead + (MM_SEQ,), generator=g,
                                     device="cuda"),
             "labels": torch.randint(0, V, lead + (MM_SEQ,), generator=g,
                                     device="cuda")}
        if cfg.vlm is not None:
            n = cfg.vlm.n_patches
            b["patches"] = torch.randn(lead + (n, d), generator=g,
                                       device="cuda")
            b["mrope_positions"] = torch.arange(
                n + MM_SEQ, device="cuda").expand(workers, 3, n + MM_SEQ)
        if cfg.encoder is not None:
            b["frames"] = torch.randn(lead + (cfg.encoder.n_frames, d),
                                      generator=g, device="cuda")
        return b
    return batch_fn


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
    # no remat, as the launcher; the Model's own attention blocks (the
    # launcher refuses whisper; its 64 x 64 blocks over 1,500 frames cost
    # ~60 s more here)
    model = Model(cfg, remat=False, loss_chunk=256)
    dc = DCS3GDConfig(learning_rate=0.05, momentum=0.9, lambda0=0.2,
                      warmup_steps=1, total_steps=steps)
    alg = registry.make("dc_s3gd", dc, n_workers=W, use_kernels=True,
                        buckets=N_BUCKETS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = alg.init(model.init(torch.Generator(device="cuda")
                                .manual_seed(0)))
    batch_fn = _mm_batches(cfg, W, per_worker)
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


AUTOTUNE_SERVE_LAYERS = 4


def phase_autotune(smi: str) -> dict:
    """The autotuner on the card: the train candidates (buckets {1, 2, 4,
    8} x plan_block {None, 2·BLOCK}, qwen3-0.6b x4, W = 2, fused kernels)
    and the serve candidates (page_size {8, 16, 32} x decode_burst {1, 4,
    8, 16}, qwen3-0.6b at its published widths cut to
    ``AUTOTUNE_SERVE_LAYERS`` of 28 layers (the probe's decode steps are
    host-bound, 93 s of PR 23's phase at 28), 16 slots, 16 requests from
    seed 0 at the serve cell's lengths, two rounds over the candidates in
    turn), each
    candidate's prediction beside its measurement;
    the tuned config is the best candidate only where it beats the
    default by more than the measured spread (checked against the rule
    restated here), tuned <= default ms/step, tuned >= default tokens/s,
    greedy tokens identical across every serve candidate (the probe
    raises otherwise);
    A1 / A2 launched in the train probe, B4 / B5 in the serve probe.  The
    blob goes to chiprun_out/autotune.json."""
    from repro_torch.analysis import autotune as A
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    out = {}
    _zero_counts()
    t0 = time.perf_counter()
    train = A.probe_train(A.train_space(False))
    out["train_launches"] = _read_counts()
    out["train_s"] = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    serve = A.probe_serve(A.serve_space(False), model=Model(
        dataclasses.replace(get_config("qwen3-0.6b"),
                            n_layers=AUTOTUNE_SERVE_LAYERS)))
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


# ---------------------------------------------------------------------------
# slice 14: the worker axis over real process groups (an NCCL mesh of one
# rank on the main cell, two gloo ranks on the one card for the CNN) and
# the dry-run on fake tensors
# ---------------------------------------------------------------------------

MESH_STEPS = 3
MESH_TIMED = 3               # further steps on the host clock, not compared
MESH_TOL = 1e-5              # two ranks vs one process, of each leaf's scale
MESH_RANKS = 2
RANKS_LIMIT_S = 300          # a group of spawned ranks is killed after this
RANKS_GRACE_S = 30           # ... or this long after one of them failed
# (c)'s combos, rank 0's step at 'model' 16 on the pod mesh; train_4k's
# trace takes ~2 min of one CPU core, so (c) starts with the script
DRYRUN_COMBOS = (("qwen3-0.6b", "decode_32k", "pod"),
                 ("qwen3-0.6b", "train_4k", "pod"))


def _mesh_main_run(smi: str, mesh, overlap: bool) -> dict:
    """The main cell (``MAIN_ARGS``, fused tail) for ``MESH_STEPS`` steps
    through ``Engine(model, alg, mesh=mesh)`` under deterministic
    algorithms, counts zeroed just before and read just after; then
    ``MESH_TIMED`` steps on the host clock and one steady step under
    sync-debug mode."""
    from repro_torch import tree as T
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    args = train.build_argparser().parse_args(
        MAIN_ARGS + ["--steps", str(MESH_STEPS + MESH_TIMED + 1),
                     "--use-kernels"] + (["--overlap"] if overlap else []))
    model, alg, state, batch_fn = train.build(args)
    engine = Engine(model, alg, mesh=mesh)
    if mesh is not None:
        # the rank's rows of the same weights (train.build's seed)
        del state
        state = engine.init_state(model.init(
            torch.Generator(device="cuda").manual_seed(args.seed)))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _zero_counts()
        state, hist, _ = engine.fit(state, batch_fn, steps=MESH_STEPS,
                                    log_every=1)
        torch.cuda.synchronize()
        launches = _read_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    kept = {"params": T.map(torch.clone, state.params),
            "opt": T.map(torch.clone, state.opt),
            "delta_prev": T.map(torch.clone, state.comm["delta_prev"]),
            "losses": [h["loss"] for h in hist]}
    walls = []
    for it in range(MESH_STEPS, MESH_STEPS + MESH_TIMED):
        batch = batch_fn(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = alg.step(state, engine.local_batch(batch),
                            loss_fn=model.loss)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    batch = engine.local_batch(batch_fn(MESH_STEPS + MESH_TIMED))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, m = alg.step(state, batch, loss_fn=model.loss)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(m["loss"])), "[mesh] loss not finite")
    # the run's teardown waits for the last step's issue: an asynchronous
    # collective never waited on keeps its tensors (one set of bucket sums)
    # in c10d until a later collective retires it
    alg.drain()
    del state
    return {"kept": kept, "launches": launches,
            "step_ms": statistics.median(walls) * 1e3,
            "host_syncs": syncs, "peak_bytes": peak,
            "allocated_before": before}


def _leftover_probe(smi: str, mesh) -> dict:
    """What device memory outlives a training run: one more inline run of
    the main cell (2 steps, ``mesh=None`` or on ``mesh``) under the
    allocator's history, then ``drain`` and the run's teardown.  The
    blocks allocated during the run and still alive are named by the
    frames that allocated them; then counted again after a garbage
    collection (a reference cycle's) and after 2 s more (a collective's
    stash that c10d's watchdog releases)."""
    import gc
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()

    def run(context):
        torch.cuda.memory._record_memory_history(
            max_entries=100_000, context=context, stacks="python")
        # the backward pass on this thread (it does not cure the failure
        # below; the history is the same)
        torch.autograd.set_multithreading_enabled(False)
        try:
            args = train.build_argparser().parse_args(
                MAIN_ARGS + ["--steps", "2", "--use-kernels"])
            model, alg, state, batch_fn = train.build(args)
            engine = Engine(model, alg, mesh=mesh)
            state, _, _ = engine.fit(state, batch_fn, steps=2, log_every=1)
            alg.drain()
            torch.cuda.synchronize()
            del state, engine, alg, model, batch_fn
            torch.cuda.synchronize()
            return (torch.cuda.memory_allocated() - base,
                    torch.cuda.memory._snapshot())
        finally:
            torch.autograd.set_multithreading_enabled(True)
            torch.cuda.memory._record_memory_history(enabled=None)
    try:
        left, snap = run("all")
    except SystemError as e:
        # with stacks for every event, a backward through the loss chunks'
        # recompute fails with a SystemError without a message (torch
        # 2.11 on the card); the history of allocations alone still names
        # the allocating frames
        print(f"[mesh] the allocator history with stacks failed the run "
              f"({e!r}); again without stacks [{smi}]")
        gc.collect()
        torch.cuda.empty_cache()
        left, snap = run(None)
    holders = {}
    for seg in snap["segments"]:
        for b in seg["blocks"]:
            if b["state"] != "active_allocated" or not b.get("frames"):
                continue
            frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in b["frames"]
                      if "repro_torch" in f["filename"]
                      or "chip_smoke" in f["filename"]][:4]
            key = " < ".join(frames) or "no python frame"
            holders[key] = holders.get(key, 0) + b["size"]
    del snap
    gc.collect()
    torch.cuda.synchronize()
    after_gc = torch.cuda.memory_allocated() - base
    time.sleep(2.0)
    torch.cuda.synchronize()
    later = torch.cuda.memory_allocated() - base
    top = sorted(holders.items(), key=lambda kv: -kv[1])[:6]
    which = "mesh=None" if mesh is None else "NCCL mesh"
    print(f"[mesh] leftover after a 2-step {which} run, drain and "
          f"teardown: {left} B ({left / 2**30:.3f} GiB); {after_gc} B after"
          f" gc.collect(), {later} B 2 s later; blocks alive before the "
          f"collection by allocating frames: "
          + ("; ".join(f"{v} B at {k}" for k, v in top) or "none")
          + f" [{smi}]")
    return {"left_bytes": left, "after_gc_bytes": after_gc,
            "left_bytes_2s": later,
            "holders": [{"bytes": v, "frames": k} for k, v in top]}


def phase_mesh_nccl(smi: str) -> dict:
    """(a) The main cell on an NCCL mesh of one rank: a ``file://`` store
    in a scratch directory, ``init_device_mesh("cuda", (1, 1), ("data",
    "model"))``, ``Engine(model, alg, mesh)``; 3 steps inline and 3 under
    overlap, each bitwise the ``mesh=None`` run in params, opt and
    delta_prev (and its losses), A1 and A2 12 times each a run, 0 host
    syncs in a steady step, the median step beside ``mesh=None``'s."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    rec = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        M.init_process_group(device_type="cuda",
                             init_method=f"file://{tmp}/store", rank=0,
                             world_size=1)
        try:
            mesh = M.make_debug_mesh(1, 1, device_type="cuda")
            check(dist.get_backend() == "nccl", "[mesh] backend")
            for overlap in (False, True):
                tag = "overlap" if overlap else "inline"
                ref = _mesh_main_run(smi, None, overlap)
                got = _mesh_main_run(smi, mesh, overlap)
                for what in ("params", "opt", "delta_prev", "losses"):
                    same = got["kept"][what] == ref["kept"][what] \
                        if what == "losses" else \
                        _bitwise(got["kept"][what], ref["kept"][what])
                    check(same, f"[mesh] NCCL 1 rank {tag}: {what} differs "
                          f"from mesh=None")
                for r, which in ((ref, "mesh=None"), (got, "mesh")):
                    for name, n in r["launches"].items():
                        want = MESH_STEPS * N_BUCKETS \
                            if name in ("dc_norms", "dc_fused_update") else 0
                        check(n == want, f"[mesh] {tag} {which}: {name} "
                              f"launched {n} times, expected {want}")
                check(got["host_syncs"] == 0,
                      f"[mesh] {tag}: {got['host_syncs']} host syncs in a "
                      f"steady step")
                for r in (ref, got):
                    del r["kept"]
                rec[tag] = {"mesh": got, "none": ref}
                print(f"[mesh] NCCL mesh (1, 1) {tag}: bitwise mesh=None "
                      f"in params, opt, delta_prev and losses over "
                      f"{MESH_STEPS} steps; A1 / A2 "
                      f"{got['launches']['dc_norms']} / "
                      f"{got['launches']['dc_fused_update']}; step "
                      f"{got['step_ms']:.3f} ms vs mesh=None "
                      f"{ref['step_ms']:.3f} ms (median of {MESH_TIMED}); "
                      f"host syncs {got['host_syncs']}; peak "
                      f"{got['peak_bytes'] / 2**30:.3f} GiB vs "
                      f"{ref['peak_bytes'] / 2**30:.3f} (allocated before "
                      f"{got['allocated_before'] / 2**30:.3f} vs "
                      f"{ref['allocated_before'] / 2**30:.3f}: the "
                      f"mesh=None run's kept state) [{smi}]")
                torch.cuda.empty_cache()
            rec["leftover"] = {"none": _leftover_probe(smi, None),
                               "mesh": _leftover_probe(smi, mesh)}
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    rec["leftover"]["after_destroy_bytes"] = torch.cuda.memory_allocated()
    print(f"[mesh] allocated after the process group's destruction: "
          f"{rec['leftover']['after_destroy_bytes']} B [{smi}]")
    return rec


def _mesh_cnn(rank: int, store: str, out: str) -> None:
    """One rank of phase (b) (a spawned process): ResNet-18's layout, W =
    8, ``MESH_STEPS`` DC-S3GD steps through the example twin's build, 4
    buckets, fused tail, on a gloo mesh of ``MESH_RANKS`` ranks on the
    one card; writes its metrics, its launch counts and (rank 0) the
    gathered params."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import tree as T
    from repro_torch.examples import cnn_paper_repro as twin
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.models.cnn import init_resnet
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # NCCL refuses two ranks of one communicator on one device: gloo,
    # which all-reduces and broadcasts CUDA tensors through host copies
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=MESH_RANKS)
    try:
        mesh = M.make_debug_mesh(MESH_RANKS, 1, device_type="cuda")
        with _cudnn_deterministic():
            model, alg, state, batch_fn, _ = _cnn_twin(steps=MESH_STEPS)
            del state
            engine = Engine(model, alg, mesh=mesh)
            state = engine.init_state(init_resnet(
                torch.Generator(device="cuda").manual_seed(0), **RESNET18))
            _zero_counts()
            state, hist, wall = engine.fit(state, batch_fn, steps=MESH_STEPS,
                                           log_every=1)
            torch.cuda.synchronize()
            launches = _read_counts()
        full = engine.gather_state(state)
        res = {"hist": hist, "launches": launches, "wall_s": wall,
               "rows": T.leaves(state.params)[0].shape[0]}
        if M.worker_index(mesh) == 0:
            res["params"] = T.map(lambda x: x.cpu(), full.params)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _wait_ranks(procs, limit: float = RANKS_LIMIT_S) -> list:
    """Wait for spawned ranks; ``RANKS_GRACE_S`` after one exits with an
    error, or once ``limit`` seconds have passed, kill the rest (a rank
    left in a collective whose peer died would wait for gloo's 30 min
    timeout; the grace lets a rank that failed too finish printing its
    own error).  Their exit codes."""
    deadline = time.perf_counter() + limit
    while any(p.is_alive() for p in procs):
        now = time.perf_counter()
        if now > deadline:
            break
        if any(p.exitcode not in (None, 0) for p in procs):
            deadline = min(deadline, now + RANKS_GRACE_S)
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    return [p.exitcode for p in procs]


def _start_pair(target, world: int = MESH_RANKS, extra=(),
                gated: bool = False):
    """Start ``target(rank, store, out, *extra)`` on ``world`` spawned
    ranks (a ``file://`` store in a temporary directory of their own;
    daemons, so that a failing parent leaves none behind).  ``gated``:
    the ranks reach the card and then wait in `_await_gate` until
    `_open_gate`, so that their start overlaps the parent's work."""
    import multiprocessing as mp
    import tempfile
    tmp = tempfile.mkdtemp()
    if not gated:
        Path(tmp, "go").touch()
    outs = [f"{tmp}/rank{r}.pt" for r in range(world)]
    procs = [mp.get_context("spawn").Process(
        target=target, args=(r, f"{tmp}/store", outs[r], *extra),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs, tmp


def _open_gate(started) -> None:
    """Let a gated `_start_pair`'s ranks go on."""
    Path(started[2], "go").touch()


def _await_gate(store: str) -> None:
    """In a spawned rank, after its imports and its CUDA context: wait
    until the parent opens the gate (at most 900 s)."""
    gate = Path(store).parent / "go"
    deadline = time.perf_counter() + 900
    while not gate.exists():
        check(time.perf_counter() < deadline, "the gate never opened")
        time.sleep(0.1)


def _join_pair(started, limit: float = RANKS_LIMIT_S) -> tuple:
    """Wait for a `_start_pair`'s ranks (`_wait_ranks`) and remove their
    directory: ``(results in rank order or None, exit codes)``."""
    import shutil
    procs, outs, tmp = started
    try:
        codes = _wait_ranks(procs, limit)
        res = [torch.load(o, weights_only=False) for o in outs] \
            if all(c == 0 for c in codes) else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, codes


def _spawn_pair(target, tag: str) -> list:
    """`_start_pair` then `_join_pair`; the results in rank order."""
    res, codes = _join_pair(_start_pair(target))
    check(res is not None, f"[{tag}] gloo ranks exited {codes}")
    return res


def phase_mesh_gloo(smi: str) -> dict:
    """(b) Two ranks on the one card over gloo: the paper's CNN at
    ResNet-18's layout, W = 8 (4 workers a rank), 3 DC-S3GD steps with the
    fused tail.  The gathered params within ``MESH_TOL`` of each leaf's
    largest magnitude of the one-process W = 8 run, the losses within
    ``MESH_TOL`` relative; A1 and A2 18 times a rank (6 buckets x 3
    steps).  The ranks copy through the host: the wall is no speed
    figure."""
    from repro_torch import tree as T
    from repro_torch.launch.engine import Engine
    with _cudnn_deterministic():
        model, alg, state, batch_fn, _ = _cnn_twin(steps=MESH_STEPS)
        state, ref_hist, _ = Engine(model, alg).fit(
            state, batch_fn, steps=MESH_STEPS, log_every=1)
        ref = T.map(lambda x: x.cpu(), state.params)
    del state, model, alg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = _spawn_pair(_mesh_cnn, "mesh")
    wall = time.perf_counter() - t0
    worst = 0.0
    for a, b in zip(T.leaves(res[0]["params"]), T.leaves(ref)):
        scale = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / scale)
    check(worst <= MESH_TOL, f"[mesh] gloo params {worst:.3g} of scale from "
          f"the one-process run")
    losses = [[h["loss"] for h in r["hist"]] for r in res]
    ref_losses = [h["loss"] for h in ref_hist]
    check(all(l == losses[0] for l in losses),
          "[mesh] gloo ranks report different losses")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[0],
                                                       ref_losses))
    check(loss_err <= MESH_TOL, f"[mesh] gloo losses {losses[0]} vs "
          f"{ref_losses}")
    for r in res:
        check(r["rows"] == CNN_W // MESH_RANKS, f"[mesh] rows {r['rows']}")
        for name, n in r["launches"].items():
            want = MESH_STEPS * len(CNN_BUCKETS) \
                if name in ("dc_norms", "dc_fused_update") else 0
            check(n == want, f"[mesh] gloo rank: {name} launched {n} "
                  f"times, expected {want}")
    print(f"[mesh] gloo, 2 ranks on one card, ResNet-18 layout W={CNN_W} "
          f"({CNN_W // MESH_RANKS} a rank), {MESH_STEPS} steps: params "
          f"within {worst:.3g} of each leaf's scale, losses within "
          f"{loss_err:.3g} of the one-process run; A1 / A2 "
          f"{[r['launches']['dc_norms'] for r in res]} / "
          f"{[r['launches']['dc_fused_update'] for r in res]} a rank; "
          f"{wall:.1f} s wall with the ranks' start [{smi}]")
    return {"params_err": worst, "loss_err": loss_err, "losses": losses[0],
            "launches": [r["launches"] for r in res], "wall_s": wall,
            "fit_s": [r["wall_s"] for r in res]}


def _start_dryrun() -> tuple:
    """Start (c)'s dry-run subprocesses, one combo of `DRYRUN_COMBOS`
    after the other, then phase 22's fake-mode trace
    (`main_long_fake_peak`), on a thread of their own: they place nothing
    on the card, so they run beside the card's phases; `phase_dryrun` and
    `phase_long_seq` join them.  (thread, a dict that gets each one's
    ``r`` and ``wall``)."""
    import threading
    box = {}

    def run():
        for arch, shape, mesh in DRYRUN_COMBOS:
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
                 str(ROOT / "chiprun_out" / "dryrun_torch")],
                capture_output=True, text=True, timeout=600, cwd=ROOT,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            box[shape] = {"r": r, "wall": time.perf_counter() - t0}
        # phase 22's fake-mode peak (~40 s of one core)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke as cs; cs.main_long_fake_peak()"],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"})
        box["long_fake"] = {"r": r, "wall": time.perf_counter() - t0}
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def phase_dryrun(smi: str, started: tuple) -> dict:
    """(c) The dry-run combos as subprocesses in the card's environment
    (`_start_dryrun`'s, joined here): ``status: ok``, rank 0's per-device
    argument, temp and peak bytes and its collectives over 'model'."""
    out = ROOT / "chiprun_out" / "dryrun_torch"
    thread, box = started
    thread.join()
    recs = {}
    for arch, shape, mesh in DRYRUN_COMBOS:
        check(shape in box, f"[dryrun] {shape}: the subprocess did not run")
        r, wall = box[shape]["r"], box[shape]["wall"]
        check(r.returncode == 0, f"[dryrun] {shape} exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        rec = json.loads((out / f"{arch}__{shape}__{mesh}__dc_s3gd.json")
                         .read_text())
        m, ro = rec["memory"], rec["roofline"]
        check(rec["status"] == "ok" and rec["n_chips"] == 256
              and m["peak_bytes"] > m["argument_bytes"] > 0
              and ro["tp_bytes"] > 0, f"[dryrun] {shape} record {rec}")
        print(f"[dryrun] {arch} x {shape} x {mesh}, rank 0's step at "
              f"'model' 16: ok, {m['argument_bytes']} B of arguments a "
              f"device ({m['argument_bytes'] / 2**30:.3f} GiB), "
              f"{m['output_bytes']} B out, temp {m['temp_bytes']} B, peak "
              f"{m['peak_bytes']} B ({m['peak_bytes'] / 2**30:.3f} GiB); "
              f"'model' collectives {ro['tp_bytes']:.0f} B "
              f"({ro['collective_tp_s'] * 1e3:.2f} ms at NVLink's rate), "
              f"the wire {ro['coll_bytes']:.0f} B; roofline "
              f"{ro['bottleneck']}-bound; {wall:.1f} s wall (a subprocess "
              f"beside the card's phases) [{smi}]")
        recs[shape] = {"record": rec, "wall_s": wall}
    return recs


# ---------------------------------------------------------------------------
# phase 18: tensor parallelism over the mesh's 'model' axis
# ---------------------------------------------------------------------------

TP_STEPS = 3
TP_RANKS_LIMIT_S = 600   # the (1, 2) pair runs every cell of TP_PAIR
# cells whose ranks run the allocator with expandable segments: with
# fixed ones the one-process turns of olmoe and falcon-mamba reserved
# 73.3 / 74.0 GiB (65.4 / 66.6 GiB of tensors), within 2.5 GiB of what
# the card had free beside the other rank and the parent, once less
# than it; expandable segments reserve ~1 GiB above the tensors but map
# and unmap the card's pages at every growth and `empty_cache`, which
# made every cell 1.2-1.5x slower, so only these two take them
TP_EXPANDABLE = ("c", "mamba")
TP_TOL = 1e-5       # of each leaf's scale, the CPU tests' f32 bound
                    # (measured 3.1e-6 there); the metrics relative
# The published configs compute in bf16: the embedding's rows enter the
# first block in bf16, so the gradients reaching `tok` and that block's
# norm are rounded to bf16, and where a rank's f32 partial sum lands on
# the other side of a rounding boundary than the one-process product's,
# an element moves one bf16 ulp (2^-8; 2 of 7,680 elements of the reduced
# qwen3's tok gradient on the CPU).  From the next step on the embedding
# rows differ by that much, and every gradient with them: under bf16
# compute the step's updates (momentum, carried deltas) are held to
# TP_TOL_BF16_UPDATE of each leaf's scale and those two leaves to
# TP_TOL_BF16 (a few ulps, after Eq. 10's g^2 D term), the weights and
# metrics to TP_TOL.  The f32-compute cell holds every leaf to TP_TOL.
TP_BF16_LEAVES = ("embed/tok", "stage0/b0/ln1/scale")
TP_TOL_BF16 = 2e-2
TP_TOL_BF16_UPDATE = 1e-3
# (cell, the launcher's arguments (their step count is TP_STEPS), the
# compute dtype: the published configs' bf16, or f32 for the cell that
# holds every leaf to TP_TOL)
TP_FAMILY_ARGS = ["--algo", "dc_s3gd", "--workers", str(W),
                  "--batch-per-worker", "2", "--seq", "256", "--buckets",
                  str(N_BUCKETS), "--seed", "0", "--log-every", "1"]
# the other families over (1, 2), f32 compute (every leaf to TP_TOL):
# falcon-mamba-7b x1, minicpm3-4b x2 and whisper-large-v3 x2 + 2 at their
# published widths; recurrentgemma-9b and qwen2-vl-7b reduced (one unit
# of recurrentgemma at full width holds 2.8 B params and qwen2-vl's
# embedding and unembedding 1.09 B: at ~14 worker-stacked copies of the
# params, more than the card's 80 GB for the two ranks together)
TP_FAMILIES = (
    ("mamba", ["--arch", "falcon-mamba-7b", "--layers", "1"]
     + TP_FAMILY_ARGS, "float32"),
    ("mla", ["--arch", "minicpm3-4b", "--layers", "2"] + TP_FAMILY_ARGS,
     "float32"),
    ("whisper", ["--arch", "whisper-large-v3", "--layers", "2"]
     + TP_FAMILY_ARGS, "float32"),
    ("hybrid", ["--arch", "recurrentgemma-9b", "--reduced"]
     + TP_FAMILY_ARGS, "float32"),
    ("vlm", ["--arch", "qwen2-vl-7b", "--reduced"] + TP_FAMILY_ARGS,
     "float32"))
# the training pieces on qwen3-0.6b at its widths, depth 28 -> 2, f32
# compute: the local optimizers and per-tensor λ take the plain tail (the
# fused one is momentum with global λ only), the rest the fused one
TP_QWEN2 = ["--arch", "qwen3-0.6b", "--layers", "2"] + TP_FAMILY_ARGS
TP_PIECES = (
    ("nesterov", TP_QWEN2 + ["--local-optimizer", "nesterov"], "float32"),
    ("adam", TP_QWEN2 + ["--local-optimizer", "adam"], "float32"),
    ("lars", TP_QWEN2 + ["--local-optimizer", "lars"], "float32"),
    ("per_tensor", TP_QWEN2, "float32"),
    ("overlap", TP_QWEN2 + ["--overlap"], "float32"),
    ("gossip", TP_QWEN2 + ["--reducer", "gossip"], "float32"),
    ("hierarchical", TP_QWEN2 + ["--reducer", "hierarchical"], "float32"),
    ("dynamic_ssp", TP_QWEN2 + ["--staleness", "dynamic_ssp"], "float32"),
    ("dc_asgd", TP_QWEN2 + ["--algo", "dc_asgd"], "float32"))
# the compressed and quantized wires over 'model' (slice 19) on the same
# qwen3 x2, f32 compute, beside the dense wire's cell: each reduces the
# whole buckets, gathered over the axis (fp8 per leaf: the per-leaf fused
# tail, A1 / A2 once per leaf and step)
TP_WIRES = (
    ("dense", TP_QWEN2, "float32"),
    ("topk", TP_QWEN2 + COMPRESSED, "float32"),
    ("topk_exact", TP_QWEN2 + ["--reducer", "topk_exact"], "float32"),
    ("randk", TP_QWEN2 + ["--reducer", "randk"], "float32"),
    ("powersgd", TP_QWEN2 + ["--reducer", "powersgd"], "float32"),
    ("int8", TP_QWEN2 + ["--comm-dtype", "int8"], "float32"),
    ("fp8", TP_QWEN2 + ["--comm-dtype", "fp8", "--buckets", "0"],
     "float32"))
TP_WIRE_TAGS = tuple(t for t, _, _ in TP_WIRES if t != "dense")
# the flip-count rule of the CPU tests (tests/test_torch_tp_wires.py,
# tests/test_torch_tp_reference.py): a coordinate more than TP_WIRE_TOL
# of its leaf's scale (of a weight's update, for params) off its twin's
# counts as flipped (a selection threshold or a quantum boundary crossed
# by last-bit differences of the gathered gradients), and a part of a
# rank may hold TP_WIRE_FLIPS[tag] of its coordinates so: the larger of
# the CPU tests' bound (300 of the reduced qwen3's 2,886,656 update
# coordinates) and four times the worst share these cells flipped in the
# CPU rehearsal at the reduced size (int8 16 and fp8 per leaf 84 of a
# rank's 1,444,864 params; none under the compressed wires), fixed before
# the first card run
TP_WIRE_TOL = 1e-4
TP_WIRE_FLIPS = {t: max(300 / 2_886_656, 4 * n / 1_444_864) for t, n in (
    ("topk", 0), ("topk_exact", 0), ("randk", 0), ("powersgd", 0),
    ("int8", 16), ("fp8", 84))}
TP_PAIR = (("a", MAIN_ARGS, "bfloat16"), ("c", OLMOE_TRAIN, "bfloat16")) \
    + TP_FAMILIES + TP_PIECES + TP_WIRES
TP_FOUR = (("b", MAIN_ARGS + ["--layers", "2"], "float32"),)
# the cells whose one-process run is made once, on rank 0, which sends
# each rank its slices over gloo (through the host): where that run is
# long against its state (a card run, NVIDIA H100 80GB
# HBM3 at 700 W: a's run 14-19 s against 3.7 GB a rank; b's four runs
# 17-24 s each against three ranks' 2 GB).  Every other cell's ranks run
# it in turn, which is quicker there (a qwen3 x2 cell's turn 0.5-1.8 s,
# its slices kept on the card, against 4.1 GB a rank to send)
TP_SHARED = ("a", "b")
# Adam at eps 1: at its default 1e-8 the first step is lr·sign(g), and a
# gradient at the rounding floor flips its sign, so no rounding-order
# twin tracks it; at eps 1 its update's derivative in g is at most 1 / eps
TP_ADAM_EPS = 1.0
# the weight-mixing reducers and dynamic_ssp's revoked step (D = R(w) − w,
# or the pull mean(w) − w, cancels down to the weights' last bits) and
# DC-ASGD (Eq. 17's λ reaches ~1e4) are ill-conditioned in one process
# already: their one-process run is made twice more, from weights one
# ulp up and one ulp down, and each leaf (each metric) is held to the
# larger of TP_TOL of its scale and twice the larger of the two runs'
# moves, the nudge rule of the CPU tests (which nudge up only: on the
# card one direction moved DC-ASGD's ln1/scale momentum by 7.4e-5 and
# the other by 2.0e-4, which of its elements flip a quantum of D being
# chance); the move itself must stay within TP_NUDGE_CAP of the leaf's
# scale, so the bound stays tight
TP_ILL = ("gossip", "hierarchical", "dynamic_ssp", "dc_asgd")
TP_NUDGE_CAP = 1e-3
TP_NUDGES = (float("inf"), float("-inf"))   # one ulp up, one ulp down
# dynamic_ssp's cell runs one `Engine.fit` over its steps with a scripted
# straggler (worker 0 eight times slower): step 2's window is revoked
TP_SKEW = (8.0, 1.0)
TP_REVOKED = [1.0, 1.0, 0.0]


def _tp_fused(tag: str, argv) -> bool:
    """Whether a cell takes the fused tail (A1 / A2): momentum with
    global λ, DC-S3GD."""
    return tag != "per_tensor" and not any(
        f in argv for f in ("--local-optimizer", "dc_asgd"))


def _tp_build(args):
    """``train.build``'s (model, algorithm, state, batch_fn) for a
    phase-18 cell; an encoder-decoder or a VLM (which the launcher's
    token stream cannot feed) the same way from `_mm_batches`, whisper's
    encoder cut to the decoder's depth."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import registry
    from repro_torch.core.types import DCS3GDConfig
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    cfg = get_config(args.arch)
    if cfg.encoder is None and cfg.vlm is None:
        # the launcher's own Model: no remat, attention in 64 x 64 blocks
        return train.build(args)
    cfg = reduced(cfg) if args.reduced else cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_layers=args.layers))
    # no remat, as the launcher; the Model's own attention blocks (the
    # launcher's 64 x 64 over whisper's 1,500 frames cost ~60 s more)
    model = Model(cfg, remat=False, loss_chunk=256)
    dc = DCS3GDConfig(learning_rate=args.lr, momentum=args.momentum,
                      lambda0=args.lambda0, total_steps=args.steps,
                      warmup_steps=max(int(args.warmup_frac * args.steps),
                                       1))
    alg = registry.make(args.algo, dc, n_workers=args.workers,
                        use_kernels=args.use_kernels, buckets=args.buckets)
    state = alg.init(model.init(torch.Generator(device="cuda")
                                .manual_seed(args.seed)))
    return model, alg, state, _mm_batches(cfg, args.workers,
                                          args.batch_per_worker)


def _tp_cell(mesh, tag: str, argv, compute: str) -> dict:
    """One rank's share of a phase-18 cell: the one-process run of
    ``argv`` (one at a time: two of qwen3 x4's ~36 GiB runs do not fit
    the card together; in a `TP_SHARED` cell once, on rank 0, which sends
    each rank its slices), keeping the slices of its params, momentum and
    carried deltas that this rank holds; then
    ``Engine(model, alg, mesh)`` for ``TP_STEPS`` steps from the same
    weights, counts zeroed just before and read just after, a digest of
    the replicated leaves after every step (after the one `Engine.fit`
    of the straggler cell); then each leaf's largest difference from the
    kept slices and the slices' own scale.  A `TP_ILL` cell's
    one-process run is made again from weights one ulp up and one ulp
    down (`TP_NUDGES`), and each leaf's (each metric's) larger move under
    the two nudges is kept beside.  A `TP_WIRE_TAGS` cell also counts,
    per part, the coordinates flipped against the kept slices (the
    params' as moves from the rank's initial weights) and digests its
    whole-layout ``comm["reducer"]`` with the replicated leaves.  The
    model computes in ``compute``."""
    import hashlib
    import numpy as np
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.cluster.membership import rebuild_algorithm
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    from repro_torch.parallel import sharding as shd
    args = train.build_argparser().parse_args(argv)
    args.steps, args.use_kernels = TP_STEPS, _tp_fused(tag, argv)
    sizes, coord = M.axis_sizes(mesh), M.coordinate(mesh)
    me, world = dist.get_rank(), dist.get_world_size()
    fit = {} if tag != "dynamic_ssp" else dict(
        measure_skew=True, skew_probe=lambda it, dt: [TP_SKEW[0]] + [
            TP_SKEW[1]] * (W - 1))

    def adjust(alg):
        # the launcher has no flag for either
        if tag == "adam":
            alg.local_optimizer.eps = TP_ADAM_EPS
        if tag == "per_tensor":
            alg.compensator.mode = "per_tensor"
        return alg

    def mine(tree, cfg, stacked, at=coord):
        specs = dict(shd.flat_specs(shd.param_specs(
            cfg, tree, model_size=sizes["model"],
            worker_axes="data" if stacked else None), tree))
        return shd.map_with_path(lambda p, x: x[shd.local_slices(
            tuple(x.shape), specs[p], sizes, at)], tree)

    def parts(alg, state):
        out = {"params": state.params, "m": state.opt["m"]}
        dp = state.comm.get("delta_prev")
        if isinstance(dp, list):
            out["delta"] = alg._plan(state.params).unpack(dp)
        elif dp is not None:    # the per-leaf wire
            out["delta"] = dp
        return out

    def run(engine, state, batch_fn):
        """``TP_STEPS`` steps; (state, metric history, digests of the
        replicated leaves or None without a mesh)."""
        hist, digests = [], []
        for t in ([TP_STEPS - 1] if fit else range(TP_STEPS)):
            state, h, _ = engine.fit(state, batch_fn, steps=t + 1,
                                     start=0 if fit else t, log_every=1,
                                     **fit)
            hist += h
            if engine.model_axis is None:
                continue
            flags = shd.sharded_over_model(model.cfg, state.params,
                                           model_size=sizes["model"])
            whole = [x for f, x in zip(flags, T.leaves(state.params))
                     if not f] + [x for f, x in zip(
                         flags, T.leaves(state.opt["m"])) if not f]
            dp = state.comm.get("delta_prev")
            if isinstance(dp, list):
                plan = engine.alg._plan(state.params)
                whole += [b for f, b in zip(plan.sharded, dp) if not f]
            elif dp is not None:
                whole += [x for f, x in zip(flags, T.leaves(dp)) if not f]
            digest = hashlib.sha256()
            for x in whole:
                digest.update(x.detach().cpu().numpy().tobytes())
            if "reducer" in state.comm:
                # the whole-layout residuals (and powersgd's warm start),
                # the same on every model rank: summed on the card
                digest.update(_bits_sums([
                    x for x in T.leaves(state.comm["reducer"])
                    if isinstance(x, torch.Tensor)]).cpu().numpy()
                    .tobytes())
                digest.update(str(state.comm["reducer"].get("step"))
                              .encode())
            digests.append(digest.hexdigest())
        return state, hist, digests
    rec, t_cell = {}, time.perf_counter()
    coords = [None] * world
    dist.all_gather_object(coords, coord)
    with warnings.catch_warnings():
        # deprecated in favour of a private torch._C call; same effect
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(
            f"expandable_segments:{tag in TP_EXPANDABLE}")

    def build():
        model, alg, state, batch_fn = _tp_build(args)
        model = Model(dataclasses.replace(model.cfg, compute_dtype=compute),
                      remat=model.remat, q_chunk=model.q_chunk,
                      kv_chunk=model.kv_chunk, scan_chunk=model.scan_chunk,
                      loss_chunk=model.loss_chunk, moe_dense=model.moe_dense)
        return model, adjust(alg), state, batch_fn
    # the one-process run: in a `TP_SHARED` cell once, on rank 0 while
    # the others wait, which sends each rank its slices of the params,
    # momentum and carried deltas (flat lists of leaves) and of the
    # nudged runs' moves over the gloo group; in any other cell each rank
    # runs it in turn and keeps its own slices
    shared = tag in TP_SHARED
    targets, refs = (coords if shared else [coord]), None
    # a turn's own slices stay on the card (the other ranks' turns and the
    # mesh run have the room; copying them out and back cost ~2 s a rank
    # and cell), but where they travel over gloo or the card is tight
    keep = (lambda x: x.cpu().contiguous()) \
        if shared or tag in TP_EXPANDABLE \
        else (lambda x: x.clone(memory_format=torch.contiguous_format))
    for turn in range(1 if shared else world):
        if turn != me:
            dist.barrier()
            continue
        t_turn = time.perf_counter()
        _free_card()
        twin = {"free_at_turn": torch.cuda.mem_get_info()[0]}
        model, alg, state, batch_fn = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, hist, _ = run(Engine(model, alg), state, batch_fn)
        torch.cuda.synchronize()
        twin["peak_none"] = torch.cuda.max_memory_allocated()
        twin["reserved_none"] = torch.cuda.max_memory_reserved()
        twin["hist_none"] = [{k: h[k] for k in TP_METRICS if k in h}
                             for h in hist]
        twin["admit_none"] = [h.get("ssp_admit") for h in hist]
        stacked = getattr(alg, "worker_stacked", False)
        refs = [{k: [keep(x) for x in T.leaves(
                     mine(v, model.cfg, stacked, at))]
                 for k, v in parts(alg, state).items()} for at in targets]
        del state
        alg = adjust(rebuild_algorithm(alg, args.workers))
        torch.cuda.empty_cache()
        metas = [{} for _ in targets]
        for way in (TP_NUDGES if tag in TP_ILL else ()):
            nudged = T.map(lambda x: torch.nextafter(
                x, torch.full_like(x, way)), model.init(
                    torch.Generator(device="cuda").manual_seed(args.seed)))
            state, hist_up, _ = run(Engine(model, alg), alg.init(nudged),
                                    batch_fn)
            del nudged
            for at, ref, got in zip(targets, refs, metas):
                moves = {
                    k: [float((a.to(b.device).float() - b.float()).abs()
                              .max()) for a, b in zip(
                        ref[k], T.leaves(mine(v, model.cfg, stacked, at)))]
                    for k, v in parts(alg, state).items()}
                got.setdefault("moves_by_way", []).append(moves)
                # the larger move of the two directions, leaf by leaf
                old = got.get("moves", moves)
                got["moves"] = {k: list(map(max, old[k], v))
                                for k, v in moves.items()}
            hist_moves = [{k: abs(a[k] - b[k]) for k in TP_METRICS
                           if k in a} for a, b in zip(hist, hist_up)]
            old = twin.get("hist_moves", hist_moves)
            twin["hist_moves"] = [{k: max(a[k], b[k]) for k in a}
                                  for a, b in zip(old, hist_moves)]
            del state
            alg = adjust(rebuild_algorithm(alg, args.workers))
            torch.cuda.empty_cache()
        twin["turn_s"] = time.perf_counter() - t_turn
        metas = [{**twin, **got, "shapes": {
            k: [(tuple(x.shape), x.dtype) for x in v] for k, v in r.items()}}
            for r, got in zip(refs, metas)]
        # what this rank keeps on the card while the others take theirs
        _free_card()
        twin["held"] = torch.cuda.memory_reserved()
        if not shared:
            rec.update(metas[0], held=twin["held"])
            ref = refs.pop()
        dist.barrier()
    if shared:
        box = [None]
        dist.scatter_object_list(box, metas if me == 0 else None, src=0)
        rec.update(box[0], held=0)
        if me == 0:
            for r in range(1, world):
                for x in (x for v in refs[r].values() for x in v):
                    dist.send(x, r)
            ref = refs[0]
        else:
            ref = {k: [torch.empty(s, dtype=d) for s, d in v]
                   for k, v in rec["shapes"].items()}
            for x in (x for v in ref.values() for x in v):
                dist.recv(x, 0)
            model, alg, state, batch_fn = build()
            del state
            alg = adjust(rebuild_algorithm(alg, args.workers))
            _free_card()
    del refs
    rec.pop("shapes")
    params = model.init(torch.Generator(device="cuda")
                        .manual_seed(args.seed))
    # a wire cell's initial weights, this rank's slices: the params'
    # flips count moves from them
    w0 = T.map(lambda x: x.cpu(), mine(params, model.cfg, False)) \
        if tag in TP_WIRE_TAGS else None
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        engine = Engine(model, alg, mesh=mesh)
        state = engine.init_state(params)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        state, hist, digests = run(engine, state, batch_fn)
        torch.cuda.synchronize()
        rec["fit_s"] = time.perf_counter() - t0
        rec["launches"] = _read_counts()
        rec["peak"] = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
    rec["fused"] = bool(args.use_kernels)
    rec["n_buckets"] = alg._plan(state.params).n_buckets \
        if getattr(alg, "buckets", 0) else 0
    # the fused tail's launches a step: one a local bucket, or a leaf
    rec["n_units"] = rec["n_buckets"] or len(T.leaves(state.params))
    # the reducer's whole buckets over 'model' (B3's launches a step)
    wire = alg._whole_wire(state.params) \
        if hasattr(alg, "_whole_wire") else None
    rec["whole_sizes"] = list(wire.sizes) if wire is not None else []
    rec["hist"] = [{k: h[k] for k in TP_METRICS if k in h} for h in hist]
    rec["admit"] = [h.get("ssp_admit") for h in hist]
    rec["digests"] = digests
    rec["model_index"], rec["worker_index"] = M.model_index(mesh), \
        M.worker_index(mesh)
    rec["diff"], rec["flips"], rec["counted"] = {}, {}, {}
    for part, tree in parts(alg, state).items():
        rec["diff"][part] = []
        rec["flips"][part] = rec["counted"][part] = 0
        bases = T.leaves(w0) if part == "params" and w0 is not None \
            else None
        for j, ((p, x), r) in enumerate(zip(shd.leaves_with_path(tree),
                                            T.leaves(ref[part]))):
            r = r.to(x.device).float()
            d, scale = (x.float() - r).abs(), float(r.abs().max())
            rec["diff"][part].append(("/".join(map(str, p)),
                                      float(d.max()), scale))
            if w0 is not None:
                # the flip count: the twin's move from the initial
                # weights sets a param leaf's scale (at least one ulp of
                # its largest weight), its own values any other leaf's
                floor, move = 0.0, scale
                if bases is not None:
                    b = bases[j].to(x.device).float()
                    move = float((r - b).abs().max())
                    floor = float(np.spacing(np.float32(
                        float(b.abs().max()))))
                    del b
                tol = max(TP_WIRE_TOL * move, floor)
                rec["flips"][part] += int((d > tol).sum())
                rec["counted"][part] += d.numel()
            del d, r
    lead = 1 if getattr(alg, "worker_stacked", False) else 0
    rec["n_params_local"] = sum(x[0].numel() if lead else x.numel()
                                for x in T.leaves(state.params))
    del state, engine, ref
    # the next cell's first one-process turn starts once every rank has
    # let go of this cell's state
    _free_card()
    rec["cell_s"] = time.perf_counter() - t_cell
    dist.barrier()
    return rec


# DC-S3GD's metrics, and DC-ASGD's staleness distance in place of the
# last two
TP_METRICS = ("loss", "lambda", "distance_norm", "delta_norm",
              "staleness_dist")


def _tp_whole_sizes() -> tuple:
    """The whole plan's bucket sizes of the `TP_WIRES` cells' qwen3 x2
    (f32 params, ``N_BUCKETS``), which their wires reduce."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.buckets import plan_buckets
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2)
    return plan_buckets(S.abstract_params(Model(cfg)), N_BUCKETS) \
        .bucket_sizes


def _bits_sums(xs) -> torch.Tensor:
    """Two int64 sums of the int32 bit patterns of the f32 tensors
    ``xs`` (their values and their squares, wrapping): a digest taken on
    the card, which any changed bit of a one-off element moves."""
    acc = torch.zeros(2, dtype=torch.int64, device=xs[0].device)
    for x in xs:
        bits = x.detach().float().contiguous().view(-1).view(torch.int32)
        for c in bits.split(1 << 24):
            c = c.to(torch.int64)
            acc[0] += c.sum()
            acc[1] += (c * c).sum()
    return acc


def _free_card() -> None:
    """Collect garbage (tensors held in reference cycles), then return
    the allocator's free blocks to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _tp_rank(rank: int, store: str, out: str, world: int, shape,
             cells) -> None:
    """One spawned rank of phase 18 (`_start_pair`'s): a gloo process
    group (NCCL refuses two ranks on one device), a ('data', 'model') mesh
    of ``shape`` on the card, then `_tp_cell` of each of ``cells``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as M
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = M.make_debug_mesh(*shape, device_type="cuda")
        torch.save({tag: _tp_cell(mesh, tag, argv, compute)
                    for tag, argv, compute in cells}, out)
    finally:
        dist.destroy_process_group()


def _tp_spawn(shape, cells) -> list:
    """Run the ranks of a phase-18 mesh of ``shape``: their records."""
    world = shape[0] * shape[1]
    res, codes = _join_pair(_start_pair(_tp_rank, world,
                                        (world, shape, cells)),
                            TP_RANKS_LIMIT_S)
    check(res is not None, f"[tp] gloo ranks {shape} exited {codes}")
    return res


def _tp_verdict(smi: str, tag: str, shape, res: list, problems: list
                ) -> dict:
    """Print one cell from every rank's record, appending to ``problems``
    what fails its checks."""
    recs = [r[tag] for r in res]
    bf16_cell = dict((t, c) for t, _, c in TP_PAIR + TP_FOUR)[tag] \
        == "bfloat16"
    worst, worst_bf16, top, moves = {}, 0.0, {}, []
    ways = [0.0] * len(TP_NUDGES)
    for part in recs[0]["diff"]:
        rows = []
        for i, (path, *_) in enumerate(recs[0]["diff"][part]):
            diff = max(r["diff"][part][i][1] for r in recs)
            scale = max(r["diff"][part][i][2] for r in recs)
            if not scale:
                continue
            rel = diff / scale
            bf16 = bf16_cell and path.endswith(TP_BF16_LEAVES)
            tol = TP_TOL_BF16 if bf16 else TP_TOL_BF16_UPDATE \
                if bf16_cell and part != "params" else TP_TOL
            if tag in TP_ILL:
                move = max(r["moves"][part][i] for r in recs)
                moves.append((move / scale, path))
                ways = [max(max(r["moves_by_way"][w][part][i] for r in recs)
                            / scale, ways[w]) for w in range(len(TP_NUDGES))]
                if move > TP_NUDGE_CAP * scale:
                    problems.append(f"({tag}) {part} {path} moves "
                                    f"{move / scale:.3g} of scale under "
                                    f"the nudge")
                tol = max(tol, 2 * move / scale)
            if rel > tol and tag not in TP_WIRE_TAGS:
                problems.append(f"({tag}) {part} {path} {rel:.3g} of scale "
                                f"from mesh=None")
            if bf16:
                worst_bf16 = max(worst_bf16, rel)
            else:
                rows.append((rel, path))
        worst[part] = max(rows)[0] if rows else 0.0
        top[part] = [f"{p} {r:.3g}" for r, p in sorted(rows)[-2:][::-1]]
    hist_none = recs[0]["hist_none"]
    m_err = max(abs(a[k] - b[k]) / abs(b[k]) for r in recs
                for a, b in zip(r["hist"], hist_none) for k in b if b[k])
    hist_moves = recs[0].get("hist_moves") or [{} for _ in hist_none]
    off = [(k, abs(a[k] - b[k])) for r in recs
           for a, b, hm in zip(r["hist"], hist_none, hist_moves) for k in b
           if abs(a[k] - b[k]) > max(TP_TOL * abs(b[k]), 2 * hm.get(k, 0.0))]
    if off:
        problems.append(f"({tag}) metrics {m_err:.3g} from mesh=None "
                        f"({off[:3]})")
    if tag == "dynamic_ssp" and not all(
            r["admit"] == r["admit_none"] == TP_REVOKED for r in recs):
        problems.append(f"({tag}) admits {[r['admit'] for r in recs]}, "
                        f"mesh=None {recs[0]['admit_none']}, expected "
                        f"{TP_REVOKED}")
    if not all(r["hist"] == recs[0]["hist"] for r in recs):
        problems.append(f"({tag}) ranks report different metrics")
    by_worker = {}
    for r in recs:
        by_worker.setdefault(r["worker_index"], []).append(r["digests"])
    if not all(len(set(map(tuple, d))) == 1 for d in by_worker.values()):
        problems.append(f"({tag}) replicated leaves differ across the "
                        f"model ranks")
    for r in recs:
        for name, n in r["launches"].items():
            want = TP_STEPS * r["n_units"] if r["fused"] and name in (
                "dc_norms", "dc_fused_update") else 0
            if name == "select_ef_mean" and r["fused"] \
                    and tag in ("topk", "topk_exact"):
                # B3 once a whole bucket and step on every model rank
                want = TP_STEPS * len(r["whole_sizes"])
            if n != want:
                problems.append(f"({tag}) rank: {name} launched {n} times,"
                                f" expected {want}")
    flips = None
    if tag in TP_WIRE_TAGS:
        # the flip-count rule, per rank and part
        flips = {part: [r["flips"][part] for r in recs]
                 for part in recs[0]["flips"]}
        for r in recs:
            for part, n in r["flips"].items():
                if n > TP_WIRE_FLIPS[tag] * r["counted"][part]:
                    problems.append(
                        f"({tag}) {part}: {n} of {r['counted'][part]} "
                        f"coordinates flipped (bound "
                        f"{TP_WIRE_FLIPS[tag] * r['counted'][part]:.0f})")
        if len({tuple(r["whole_sizes"]) for r in recs}) != 1 \
                or not recs[0]["whole_sizes"]:
            problems.append(f"({tag}) whole buckets "
                            f"{[r['whole_sizes'] for r in recs]}")
        print(f"[tp] ({tag}) the wire over the whole buckets (leaves) "
              f"{recs[0]['whole_sizes']}: flipped coordinates a rank "
              f"{flips} of {[r['counted'] for r in recs]} (bound "
              f"{TP_WIRE_FLIPS[tag]:.3g} of a part's; the worst leaf "
              f"{ {p: float(f'{v:.3g}') for p, v in worst.items()} } of "
              f"scale), B3 {[r['launches']['select_ef_mean'] for r in recs]}"
              f" a rank [{smi}]")
    peaks = [r["peak"] for r in recs]
    peak_none = max(r["peak_none"] for r in recs)
    emb = f"; {', '.join(TP_BF16_LEAVES)} {worst_bf16:.3g}" \
        if bf16_cell else ""
    worst_move = max(moves) if moves else (0.0, "")
    if moves:
        emb += (f"; held to twice the larger one-ulp nudge's move, up to "
                f"{worst_move[0]:.3g} of scale ({worst_move[1]}; one ulp up "
                f"/ down at worst {ways[0]:.3g} / {ways[1]:.3g})")
    print(f"[tp] ({tag}) mesh {shape} of gloo ranks on one card, "
          f"{TP_STEPS} steps: params / momentum / deltas within "
          f"{worst['params']:.3g} / {worst['m']:.3g} / "
          f"{worst.get('delta', 0.0):.3g} "
          f"of each leaf's scale from mesh=None at "
          f"{'bf16' if bf16_cell else 'f32'} compute (largest: {top}"
          f"{emb}), metrics within "
          f"{m_err:.3g}; replicated leaves compared across the model ranks "
          f"after every step; A1 / A2 "
          f"{[r['launches']['dc_norms'] for r in recs]} / "
          f"{[r['launches']['dc_fused_update'] for r in recs]} a rank "
          f"({recs[0]['n_buckets']} local buckets); params a rank "
          f"{[r['n_params_local'] for r in recs]}; peak a rank "
          f"{[round(p / 2**30, 3) for p in peaks]} GiB vs mesh=None "
          f"{peak_none / 2**30:.3f} GiB (reserved "
          f"{[round(r['reserved_none'] / 2**30, 3) for r in recs]}; the card "
          f"free at each one-process turn's start "
          f"{[round(r['free_at_turn'] / 2**30, 3) for r in recs]} GiB, each "
          f"rank keeping {[round(r['held'] / 2**30, 3) for r in recs]} GiB "
          f"through the others' turns); fit "
          f"{[round(r['fit_s'], 2) for r in recs]} s, the one-process turn "
          f"{[round(r['turn_s'], 2) for r in recs]} s"
          f"{' (one, on rank 0, its slices sent)' if tag in TP_SHARED else ''}"
          f", the cell "
          f"{[round(r['cell_s'], 2) for r in recs]} s [{smi}]")
    return {"worst": worst, "worst_bf16": worst_bf16, "top": top,
            "compute": "bfloat16" if bf16_cell else "float32",
            "metrics_err": m_err, "worst_move": worst_move[0],
            "worst_move_up_down": ways,
            "peaks": peaks,
            "peak_none": peak_none, "launches": [r["launches"] for r in recs],
            "reserved_none": [r["reserved_none"] for r in recs],
            "free_at_turn": [r["free_at_turn"] for r in recs],
            "held": [r["held"] for r in recs],
            "n_buckets": recs[0]["n_buckets"],
            "whole_sizes": recs[0]["whole_sizes"], "flips": flips,
            "losses": [h["loss"] for h in recs[0]["hist"]],
            "fit_s": [r["fit_s"] for r in recs],
            "turn_s": [r["turn_s"] for r in recs],
            "cell_s": [r["cell_s"] for r in recs],
            "n_params_local": [r["n_params_local"] for r in recs]}


def phase_tensor_parallel(smi: str) -> dict:
    """Phase 18: (a) qwen3-0.6b at its published widths, depth 28 -> 4,
    W = 2, on a (1, 2) mesh of two gloo ranks sharing the card, 3 steps;
    (c) olmoe-1b-7b, depth 1, W = 2, 32 experts a rank, on the same two
    ranks, then the other families (`TP_FAMILIES`), the training
    pieces on qwen3 x2 (`TP_PIECES`) and the compressed and quantized
    wires on qwen3 x2 (`TP_WIRES`: over the whole buckets, each held to
    its twin by the flip-count rule, B3 once a whole bucket and step
    under topk / topk_exact, after B3's cross-rank modes are held to its
    plain version at those buckets' sizes) there; (b) qwen3 at depth 2,
    computing in f32, on a (2, 2) mesh of four ranks.  Each
    against ``mesh=None`` from the same weights (params, momentum and
    deltas within ``TP_TOL`` of each leaf's scale, the metrics within
    ``TP_TOL`` relative; at bf16 compute the momentum and deltas within
    ``TP_TOL_BF16_UPDATE`` and ``TP_BF16_LEAVES`` within ``TP_TOL_BF16``;
    the `TP_ILL` cells each leaf and metric within the larger of
    ``TP_TOL`` and twice its one-process move from weights one ulp up or
    down;
    (b) at f32 compute), the replicated leaves bitwise equal across the
    model ranks after every step, A1 / A2 once per local bucket and step
    on every rank.  The ranks copy through the host: the walls are no
    speed figure."""
    _free_card()
    free, total = torch.cuda.mem_get_info()
    print(f"[tp] before the ranks start: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card "
          f"({torch.cuda.memory_reserved() / 2**30:.3f} reserved), "
          f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free [{smi}]")
    rec, t0, problems = {}, time.perf_counter(), []
    whole = _tp_whole_sizes()
    # B3's cross-rank modes at the whole sizes the main cell's check
    # (phase 3, the same W) did not hold
    b3 = phase_select_modes([n for n in whole if n not in EXPECTED_BUCKETS],
                            W, smi, "tp")
    pair = _tp_spawn((1, 2), TP_PAIR)
    for tag, _, _ in TP_PAIR:
        rec[tag] = _tp_verdict(smi, tag, (1, 2), pair, problems)
        rec[tag]["fit_mean_s"] = sum(rec[tag]["fit_s"]) / 2
    for tag in TP_WIRE_TAGS:
        if tag != "fp8" and tuple(rec[tag]["whole_sizes"]) != whole:
            problems.append(f"({tag}) whole buckets "
                            f"{rec[tag]['whole_sizes']}, the plan's {whole}")
    gib = 2 ** 30
    print(f"[tp] peak a rank over (1, 2), qwen3 x2 f32: the dense wire "
          f"{[round(p / gib, 3) for p in rec['dense']['peaks']]} GiB "
          f"(mesh=None {rec['dense']['peak_none'] / gib:.3f}); "
          + "; ".join(f"{t} {[round(p / gib, 3) for p in rec[t]['peaks']]}"
                      f" ({rec[t]['peak_none'] / gib:.3f})"
                      for t in TP_WIRE_TAGS) + f" [{smi}]")
    # the wire cells' share of the phase: the slowest rank's cells
    wires = {"whole_sizes": list(whole), "b3_modes": b3,
             "cells_s": sum(max(rec[t]["cell_s"]) for t, _, _ in TP_WIRES)}
    print(f"[lap] phase 18's wire cells ({len(TP_WIRES)}, the dense one "
          f"included): {wires['cells_s']:.1f} s [{smi}]")
    four = _tp_spawn((2, 2), TP_FOUR)
    rec["b"] = _tp_verdict(smi, "b", (2, 2), four, problems)
    # the card's room left at a one-process turn's peak
    rec["headroom"] = min(
        (f - r, tag) for tag in rec for f, r in zip(
            rec[tag]["free_at_turn"], rec[tag]["reserved_none"]))
    print(f"[tp] headroom: the card had at least "
          f"{rec['headroom'][0] / 2**30:.3f} GiB left at a one-process "
          f"turn's peak ({rec['headroom'][1]}) [{smi}]")
    rec["wires"] = wires
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[tp] phase 18 took {rec['phase_s']:.1f} s with the ranks' "
          f"starts [{smi}]")
    check(not problems, "[tp] " + "; ".join(problems))
    return rec


# ---------------------------------------------------------------------------
# phase 19: the paper's worker axis across ranks for every reducer,
# dynamic_ssp, DC-ASGD and elastic resize
# ---------------------------------------------------------------------------

WA_STEPS = 3
WA_SKEW = (3.0, 1.0)     # worker 0 three times slower than the rest
# (a) the main cell on an NCCL mesh of one rank, each bitwise mesh=None
WA_MAIN = (("gossip", ["--reducer", "gossip"]),
           ("hierarchical", ["--reducer", "hierarchical"]),
           ("topk", COMPRESSED),
           ("topk_exact", ["--reducer", "topk_exact"]),
           ("randk", ["--reducer", "randk"]),
           ("powersgd", ["--reducer", "powersgd"]),
           ("dynamic_ssp", ["--staleness", "dynamic_ssp",
                            "--ssp-threshold", "1"]),
           ("dc_asgd", ["--algo", "dc_asgd"]))
WA_ELASTIC = [{"step": s, "kind": "leave", "worker": w}
              for s, w in ((1, "w1"), (1, "w5"), (2, "w2"), (2, "w6"))]
# (b) the CNN on two gloo ranks: tag -> (algo, registry keywords, reducer
# knobs, config overrides, fit options, held bitwise?)
WA_CNN = (
    ("gossip", "dc_s3gd", {"reducer": "gossip"}, None, {}, {}, True),
    ("hierarchical g1", "dc_s3gd", {"reducer": "hierarchical"},
     {"groups": 1}, {}, {}, True),
    ("hierarchical g2", "dc_s3gd", {"reducer": "hierarchical"},
     {"groups": 2}, {}, {}, True),
    ("hierarchical g4", "dc_s3gd", {"reducer": "hierarchical"},
     {"groups": 4}, {}, {}, True),
    ("topk_exact", "dc_s3gd", {"reducer": "topk_exact"}, None, {}, {},
     False),
    ("powersgd", "dc_s3gd", {"reducer": "powersgd"}, None, {}, {}, False),
    ("dynamic_ssp", "dc_s3gd", {"staleness": "dynamic_ssp"}, None,
     {"ssp_threshold": 1}, {"skew": True}, False),
    ("dc_asgd", "dc_asgd", {}, None, {}, {}, True),
    # stale (λ0 = 0): after a resize to 6, D is the rounding noise of a
    # mean of 6 equal rows, which dc_s3gd's λ scales to λ0‖g‖ (PERF.md)
    ("elastic 8-6-4", "stale", {}, None, {}, {"elastic": True}, False),
    # 3 hierarchical groups of 2 over 2 ranks of 3 rows: group 1 is rank
    # 0's row 2 and rank 1's row 0
    ("hierarchical G3 W6", "dc_s3gd", {"reducer": "hierarchical"},
     {"groups": 3}, {}, {"W": 6}, True),
    # each membership on the mesh launch.mesh.mesh_for_spec lays it on: 8
    # (4 rows a rank), 6 (3), 3 on rank 0 alone (rank 1 idle), 4 (2 a
    # rank, rank 1 rejoined from the consensus); stale, as above;
    # `WA_RELAYOUT_PER` steps a membership
    ("elastic 8-6-3-4", "stale", {}, None, {}, {"relayout": True}, False),
)
# one step a membership: at two (8 steps) the card's run drifted 2.0e-5
# of a part's scale from one process.  scripts/mesh_drift.py shows the
# resizes add no drift (the state right after each is as close as before
# it) and W = 8 on the fixed (2, 1) mesh, no resize, drifts 1.8e-3 by its
# 8th step: two ranks leave one process within 5-8 steps at ResNet-18 and
# the recipe's lr (PERF.md §6, §7)
WA_RELAYOUT_PER = 1
WA_RELAYOUT = (
    [{"step": WA_RELAYOUT_PER, "kind": "leave", "worker": w}
     for w in ("w1", "w5")]
    + [{"step": 2 * WA_RELAYOUT_PER, "kind": "leave", "worker": w}
       for w in ("w2", "w4", "w6")]
    + [{"step": 3 * WA_RELAYOUT_PER, "kind": "join", "count": 1}])
WA_RELAYOUT_STEPS = 4 * WA_RELAYOUT_PER


def _skew_probe(n_workers: int):
    return lambda it, dt: [WA_SKEW[0]] + [WA_SKEW[1]] * (n_workers - 1)


def _rel_err(a, b, scales=None) -> float:
    """The largest over leaves of max|a - b| / max(max|b|, scale), in f32
    on ``a``'s device (``b``'s leaf moved there)."""
    import numpy as np
    from repro_torch import tree as T
    worst = 0.0
    lb = T.leaves(b)
    for x, y, s in zip(T.leaves(a), lb, scales or [0.0] * len(lb)):
        if isinstance(x, torch.Tensor):
            y = y.to(x.device)
            scale = max(float(y.abs().max()) if y.numel() else 0.0, s)
            d = float((x.float() - y.float()).abs().max()) \
                if y.numel() else 0.0
        else:
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            scale = max(float(np.abs(y).max()) if y.size else 0.0, s)
            d = float(np.abs(x - y).max()) if y.size else 0.0
        if scale:
            worst = max(worst, d / scale)
    return worst


def _state_err(a, b, whole: bool = False) -> dict:
    """Per part of two gathered states, `_rel_err`; an error-feedback
    residual at its bucket's payload scale (the carried delta's): its own
    largest value is about the selection threshold.  ``whole``: every
    leaf at its part's largest magnitude instead of its own."""
    from repro_torch import tree as T

    def err(x, y):
        if not whole:
            return _rel_err(x, y)
        top = max((float(v.abs().max()) for v in T.leaves(y)
                   if isinstance(v, torch.Tensor) and v.numel()),
                  default=0.0)
        return _rel_err(x, y, [top] * len(T.leaves(y)))
    out = {"params": err(a.params, b.params), "opt": err(a.opt, b.opt)}
    comm = {k: v for k, v in b.comm.items() if k not in ("pipeline",
                                                          "reducer")}
    out["comm"] = err({k: a.comm[k] for k in comm}, comm)
    if "reducer" in b.comm:
        res = b.comm["reducer"]
        scales = [float(d.abs().max()) for d in b.comm["delta_prev"]] \
            if "delta_prev" in b.comm else None
        out["comm"] = max(out["comm"], _rel_err(
            a.comm["reducer"]["residual"], res["residual"], scales),
            _rel_err({k: a.comm["reducer"][k] for k in res
                      if k != "residual"},
                     {k: v for k, v in res.items() if k != "residual"}))
    return out


def _wa_main_run(mesh, extra) -> dict:
    """The main cell (``MAIN_ARGS``, fused tail) + ``extra`` for
    ``WA_STEPS`` steps through ``Engine(model, alg, mesh=mesh)`` under
    deterministic algorithms, counts zeroed just before and read just
    after; a ``dynamic_ssp`` run measures skew with `_skew_probe`."""
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    args = train.build_argparser().parse_args(
        MAIN_ARGS + ["--steps", str(WA_STEPS), "--use-kernels"] + extra)
    model, alg, state, batch_fn = train.build(args)
    engine = Engine(model, alg, mesh=mesh)
    if mesh is not None:
        del state
        state = engine.init_state(model.init(
            torch.Generator(device="cuda").manual_seed(args.seed)))
    kw = {} if args.staleness == "fixed" else dict(
        measure_skew=True, skew_probe=_skew_probe(W))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _zero_counts()
        state, hist, _ = engine.fit(state, batch_fn, steps=WA_STEPS,
                                    log_every=1, **kw)
        torch.cuda.synchronize()
        launches = _read_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    if hasattr(engine.alg, "drain"):
        engine.alg.drain()
    return {"state": state, "launches": launches,
            "hist": [{k: v for k, v in h.items() if k != "wall_s"}
                     for h in hist],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before": before}


def phase_wa_nccl(smi: str) -> dict:
    """(a) The main cell on an NCCL mesh of one rank under each reducer
    that runs across ranks since this slice, then dynamic_ssp (a scripted
    straggler revokes step 2) and dc_asgd: ``mesh=None`` and the mesh in
    turn (two runs do not fit together), each bitwise in params, opt,
    comm and the metrics; B3 12 launches a topk / topk_exact run, A1 /
    A2 12 each a DC-S3GD run."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    rec = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        M.init_process_group(device_type="cuda",
                             init_method=f"file://{tmp}/store", rank=0,
                             world_size=1)
        try:
            mesh = M.make_debug_mesh(1, 1, device_type="cuda")
            for tag, extra in WA_MAIN:
                t0 = time.perf_counter()
                ref = _wa_main_run(None, extra)
                got = _wa_main_run(mesh, extra)
                for what in ("params", "opt", "comm"):
                    check(_bitwise(getattr(got["state"], what),
                                   getattr(ref["state"], what)),
                          f"[wa] NCCL 1 rank {tag}: {what} differs from "
                          f"mesh=None")
                check(got["hist"] == ref["hist"],
                      f"[wa] NCCL 1 rank {tag}: metrics differ")
                fused = tag != "dc_asgd"
                for r, which in ((ref, "mesh=None"), (got, "mesh")):
                    for name, n in r["launches"].items():
                        want = WA_STEPS * N_BUCKETS if (
                            name in ("dc_norms", "dc_fused_update") and fused
                            or name == "select_ef_mean"
                            and tag in ("topk", "topk_exact")) else 0
                        check(n == want, f"[wa] {tag} {which}: {name} "
                              f"launched {n} times, expected {want}")
                admits = [h.get("ssp_admit") for h in got["hist"]]
                if tag == "dynamic_ssp":
                    check(admits == [1.0, 1.0, 0.0],
                          f"[wa] dynamic_ssp admits {admits}")
                del ref["state"], got["state"]
                torch.cuda.empty_cache()
                # the mesh run's peak counts the kept mesh=None state: the
                # run's own share is the peak above what it found allocated
                rise = {k: r["peak_bytes"] - r["allocated_before"]
                        for k, r in (("mesh", got), ("none", ref))}
                rec[tag] = {"launches": got["launches"],
                            "peak_bytes": got["peak_bytes"],
                            "none_peak_bytes": ref["peak_bytes"],
                            "peak_rise_bytes": rise,
                            "losses": [h["loss"] for h in got["hist"]],
                            "admits": admits,
                            "s": time.perf_counter() - t0}
                print(f"[wa] (a) NCCL mesh (1, 1) {tag}: bitwise mesh=None "
                      f"in params, opt, comm and metrics over {WA_STEPS} "
                      f"steps; A1 / A2 / B3 {got['launches']['dc_norms']} / "
                      f"{got['launches']['dc_fused_update']} / "
                      f"{got['launches']['select_ef_mean']}"
                      + (f"; admits {admits}" if tag == "dynamic_ssp"
                         else "")
                      + f"; peak above what each run found allocated "
                      f"{rise['mesh'] / 2**30:.3f} GiB vs mesh=None "
                      f"{rise['none'] / 2**30:.3f}; {rec[tag]['s']:.1f} s "
                      f"both runs [{smi}]")
        finally:
            dist.destroy_process_group()
    return rec


def _wa_cnn_build(algo, make, opts, cfg_kw, W=CNN_W, steps=WA_STEPS):
    """The example twin's build of the (b) case on ResNet-18's layout."""
    from repro_torch.core import registry
    from repro_torch.examples import cnn_paper_repro as twin
    cfg = dataclasses.replace(twin.recipe(W, steps), **cfg_kw)
    make = dict(make)
    if opts is not None:
        make["reducer"] = registry.make_reducer(make["reducer"], cfg, **opts)
    return twin.build(algo, cfg, W, steps, net=RESNET18,
                      image_size=CNN_IMAGE, per_worker=CNN_PER_WORKER,
                      use_kernels=True, buckets=N_BUCKETS, **make)


def _in_order(batch_fn):
    """``batch_fn`` for a rank that may skip steps (outside a sub-mesh):
    the steps it skips are drawn and dropped, so the twin's prefetch stays
    in step order."""
    nxt = [0]

    def get(it, n=None):
        while nxt[0] < it:
            batch_fn(nxt[0])
            nxt[0] += 1
        nxt[0] = it + 1
        return batch_fn(it, n)
    return get


def _wa_relayout(model, alg, state, batch_fn, membership) -> tuple:
    """The (b) elastic case across meshes, on both ranks: ``Engine.fit``
    to each transition, then `Membership.sync`, ``poll``, ``preview``,
    the mesh ``launch.mesh.mesh_for_spec`` lays the new membership on,
    ``apply`` onto its worker seam, a new Engine over it.  Returns the
    last (state, Engine), the metrics and per membership this rank's
    ``{W, steps, launches, holds}`` (counts zeroed before its ``fit``)."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    mesh = M.mesh_for_spec(membership.spec, device_type="cuda")
    engine = Engine(model, alg, mesh=mesh)
    hist, segs, t = [], [], 0
    for b in sorted({e["step"] for e in WA_RELAYOUT}) + [WA_RELAYOUT_STEPS]:
        _zero_counts()
        state, h, _ = engine.fit(state, batch_fn, steps=b, start=t,
                                 log_every=1, membership=membership)
        torch.cuda.synchronize()
        segs.append({"W": membership.n_workers, "steps": len(h),
                     "launches": _read_counts(),
                     "holds": M.holds_rows(mesh)})
        hist += h
        if b == WA_RELAYOUT_STEPS:
            break
        membership.sync()
        events = membership.poll(b)
        mesh = M.mesh_for_spec(membership.preview(events),
                               device_type="cuda")
        state, _ = membership.apply(events, state, step=b,
                                    workers=M.make_workers(mesh))
        engine = Engine(model, membership.alg, mesh=mesh)
        t = b
    return state, engine, hist, segs


def _wa_cnn_case(case, mesh=None) -> dict:
    """One (b) case through ``Engine.fit``: the gathered state on the
    host, the metrics, the elastic pins (``eval_params`` bitwise across
    each resize) and the launch counts."""
    from repro_torch import tree as T
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch.engine import Engine
    from repro_torch.models.cnn import init_resnet
    tag, algo, make, opts, cfg_kw, fit, _ = case
    relayout = fit.get("relayout", False)
    steps = WA_RELAYOUT_STEPS if relayout else WA_STEPS
    W = fit.get("W", CNN_W)
    model, alg, state, batch_fn, _ = _wa_cnn_build(algo, make, opts, cfg_kw,
                                                   W, steps)
    engine = Engine(model, alg, mesh=mesh)
    if mesh is not None:
        del state
        state = init_resnet(torch.Generator(device="cuda").manual_seed(0),
                            **RESNET18)
        if relayout:
            from repro_torch.launch import mesh as M
            engine = Engine(model, alg, mesh=M.mesh_for_spec(
                Membership(alg).spec, device_type="cuda"))
        state = engine.init_state(state)
    kw, pins = {}, []
    if fit.get("skew"):
        kw = dict(measure_skew=True, skew_probe=_skew_probe(W))
    if fit.get("elastic") or relayout:
        class Pinned(Membership):
            def apply(self, events, st, *, step, workers=None):
                old = self.alg
                before = None if st is None else old.eval_params(st)
                st, changed = super().apply(events, st, step=step,
                                            workers=workers)
                after = None if st is None else old.eval_params(st)
                if changed and before is not None and after is not None:
                    pins.append(_bitwise(before, after))
                return st, changed
        kw["membership"] = Pinned(alg, faults=FaultSchedule.from_json(
            {"seed": 0, "events": WA_RELAYOUT if relayout
             else WA_ELASTIC}))
    segs = None
    if relayout and mesh is not None:
        state, engine, hist, segs = _wa_relayout(
            model, alg, state, _in_order(batch_fn), kw["membership"])
        launches = {k: sum(s["launches"][k] for s in segs)
                    for k in segs[0]["launches"]}
    else:
        _zero_counts()
        state, hist, _ = engine.fit(state, batch_fn, steps=steps,
                                    log_every=1, **kw)
        torch.cuda.synchronize()
        launches = _read_counts()
    full = engine.gather_state(state)
    host = T.map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                 full)
    return {"state": host._replace(comm={
                k: v for k, v in host.comm.items() if k != "pipeline"}),
            "hist": [{k: v for k, v in h.items() if k != "wall_s"}
                     for h in hist],
            "launches": launches, "pins": pins, "segments": segs,
            "log": kw["membership"].log if "membership" in kw else None}


def _wa_cnn_verdict(case, got, one) -> dict:
    """A (b) case's mesh run against its one-process run: the state's
    parts (`_state_err`, bitwise or not), the metrics where one process's
    are not rounding noise, the pins, the transition log and the admits;
    ``problems`` lists what fails."""
    tag, bitwise, fit = case[0], case[-1], case[5]
    problems = []
    err = _state_err(got["state"], one["state"])
    # the elastic run: each leaf at its part's scale, since the resizes'
    # consensus rounding reaches leaves whose own scale is only the few
    # steps' updates (a zero-initialised bias's momentum: 2.5e-5 of the
    # part's 0.06, 8e-10 apart, 3.2e-5 of itself; PERF.md PR 26)
    held = _state_err(got["state"], one["state"], whole=True) \
        if fit.get("elastic") or fit.get("relayout") else err
    same = {p: _bitwise(getattr(got["state"], p), getattr(one["state"], p))
            for p in ("params", "opt", "comm")}
    if bitwise and not all(same.values()):
        problems.append(f"{tag}: not bitwise one process {same}, {err}")
    if max(held.values()) > MESH_TOL:
        problems.append(f"{tag}: {held} of scale from one process")
    # across meshes every step but the first follows a resize, where D is
    # the rounding noise of a mean of equal rows (another sum order on
    # the ranks, another noise): its norm is held at 1e-6 of the step's
    # delta_norm, the scale of the deltas whose mean it rounds
    live = [h.get("n_workers") for h in one["hist"]]
    noise = {t for t in range(1, len(live)) if live[t] != live[t - 1]} \
        if fit.get("relayout") else set()
    m_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for t, (a, b) in enumerate(zip(got["hist"], one["hist"]))
                for k in ("loss", "distance_norm") if k in b
                and not (k == "distance_norm" and t in noise)
                and abs(b[k]) > 1e-6 * max(abs(h[k]) for h in one["hist"]))
    d_err = max([abs(a["distance_norm"] - b["distance_norm"])
                 / max(b["delta_norm"], 1e-30)
                 for t, (a, b) in enumerate(zip(got["hist"], one["hist"]))
                 if t in noise] or [0.0])
    if m_err > MESH_TOL or d_err > 1e-6:
        problems.append(f"{tag}: metrics {m_err:.3g} apart (D's norm after "
                        f"a resize {d_err:.3g} of delta_norm)")
    moves = len({e["step"] for e in (WA_RELAYOUT if fit.get("relayout")
                                     else WA_ELASTIC)})
    if (fit.get("elastic") or fit.get("relayout")) and (
            got["pins"] != [True] * moves or got["log"] != one["log"]):
        problems.append(f"{tag}: pins {got['pins']}, log {got['log']} vs "
                        f"{one['log']}")
    adm = [h.get("ssp_admit") for h in got["hist"]]
    if fit.get("skew") and adm != [1.0, 1.0, 0.0]:
        problems.append(f"{tag}: admits {adm}")
    return {"err": err, "held": held, "bitwise": same, "metrics_err": m_err,
            "problems": problems}


def _wa_cnn_rank(rank: int, store: str, out: str) -> None:
    """One spawned rank of (b): a gloo group of 2 on the card.  Each rank
    first runs every other `WA_CNN` case in one process (rank r the cases
    i with i % 2 == r), keeping the states on the host; then both run each
    case on the mesh, and the rank that kept a case's one-process state
    holds the gathered state to it (only the verdicts travel back).
    Gated (`_await_gate`)."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.examples import cnn_paper_repro  # noqa: F401
    from repro_torch.launch import engine, mesh as M  # noqa: F401
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _await_gate(store)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=MESH_RANKS)
    try:
        mesh = M.make_debug_mesh(MESH_RANKS, 1, device_type="cuda")
        res = {}
        with _cudnn_deterministic():
            ones = {case[0]: _wa_cnn_case(case)
                    for i, case in enumerate(WA_CNN)
                    if i % MESH_RANKS == rank}
            torch.cuda.empty_cache()
            dist.barrier()
            for case in WA_CNN:
                torch.cuda.reset_peak_memory_stats()
                got = _wa_cnn_case(case, mesh)
                r = {k: got[k] for k in ("hist", "launches", "pins",
                                         "segments")}
                r["peak_bytes"] = torch.cuda.max_memory_allocated()
                if case[0] in ones:
                    r.update(_wa_cnn_verdict(case, got, ones.pop(case[0])))
                res[case[0]] = r
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _wa_relayout_verdict(tag: str, ranks: list, smi: str) -> list:
    """Per membership of the elastic case across meshes: a rank inside
    the mesh takes its `WA_RELAYOUT_PER` steps and launches A1 and A2
    once a bucket a step, a rank outside takes none and launches
    neither."""
    problems = []
    for j, seg in enumerate(ranks[0]["segments"]):
        row = [r["segments"][j] for r in ranks]
        for rank, sg in enumerate(row):
            steps = WA_RELAYOUT_PER if sg["holds"] else 0
            want = steps * len(CNN_BUCKETS)
            got = (sg["launches"]["dc_norms"],
                   sg["launches"]["dc_fused_update"])
            if sg["steps"] != steps or \
                    got != (want, want):
                problems.append(f"{tag}: W={sg['W']} rank {rank} holds "
                                f"{sg['holds']}, {sg['steps']} steps, A1 / "
                                f"A2 {got}")
        print(f"[wa] (b) {tag}: W={seg['W']} rows a rank "
              f"{[seg['W'] // sum(x['holds'] for x in row) if x['holds'] else 0 for x in row]}"
              f", steps {[x['steps'] for x in row]}, A1 / A2 "
              f"{[(x['launches']['dc_norms'], x['launches']['dc_fused_update']) for x in row]}"
              f" a rank [{smi}]")
    return problems


def phase_wa_gloo(smi: str, res: list) -> dict:
    """(b) Two gloo ranks sharing the card (``res``: their results), the
    CNN at ResNet-18's layout, W = 8 (4 rows a rank; "hierarchical G3 W6"
    at W = 6), ``WA_STEPS`` steps of each `WA_CNN` case ("elastic
    8-6-3-4": `WA_RELAYOUT_STEPS` over the meshes ``mesh_for_spec`` lays,
    `_wa_relayout_verdict`): the gathered state within ``MESH_TOL`` of
    the one-process run (bitwise where the case says so), the metrics
    within ``MESH_TOL`` and the same on every rank that took the step,
    the elastic pins and transition log, each case's peak a rank.  The
    ranks copy through the host: no wall is a speed figure."""
    rec, problems = {}, []
    for i, case in enumerate(WA_CNN):
        tag = case[0]
        got = res[i % MESH_RANKS][tag]
        problems += got["problems"]
        # every rank logs the steps it took (a rank outside a sub-mesh
        # takes none of its steps)
        if any(r[tag]["hist"] != [h for h in got["hist"] if h["step"] in {
                m["step"] for m in r[tag]["hist"]}] for r in res):
            problems.append(f"{tag}: the ranks' metrics differ")
        if case[5].get("relayout"):
            problems += _wa_relayout_verdict(tag, [r[tag] for r in res],
                                             smi)
        err = got["err"]
        rec[tag] = {k: got[k] for k in ("err", "held", "bitwise",
                                        "metrics_err", "pins")}
        rec[tag]["segments"] = [r[tag]["segments"] for r in res]
        rec[tag]["launches"] = [r[tag]["launches"] for r in res]
        rec[tag]["peak_bytes"] = [r[tag]["peak_bytes"] for r in res]
        print(f"[wa] (b) gloo x2 ResNet-18 layout W={CNN_W} {tag}: "
              f"params / opt / comm {err['params']:.3g} / {err['opt']:.3g}"
              f" / {err['comm']:.3g} of scale (bitwise "
              f"{all(got['bitwise'].values())}), metrics "
              f"{got['metrics_err']:.3g}; A1 / A2 "
              f"{[r[tag]['launches']['dc_norms'] for r in res]}"
              + (f"; pins {got['pins']}; at each part's scale "
                 f"{max(got['held'].values()):.3g}" if got["pins"] else "")
              + f"; peak a rank "
              f"{[round(r[tag]['peak_bytes'] / 2**30, 3) for r in res]} GiB"
              f" [{smi}]")
    check(not problems, "[wa] (b) " + "; ".join(problems))
    return rec


def _wa_qwen3_rank(rank: int, store: str, out: str) -> None:
    """One spawned rank of (c): topk_exact on the main cell over two gloo
    ranks (one worker row each).  First rank 0 makes the ``mesh=None``
    run (rank 1 waits: two such runs do not fit the card) and keeps each
    row of its state on the host; then the mesh run, counts zeroed just
    before and read just after; then rank 0 sends rank r its row r, and
    each rank holds its rows to the kept row.  Gated (`_await_gate`)."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import tree as T
    from repro_torch.launch import engine, mesh as M, train  # noqa: F401
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _await_gate(store)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=MESH_RANKS)
    extra = ["--reducer", "topk_exact"]

    def tensors(state):
        return [x for x in T.leaves(state) if isinstance(x, torch.Tensor)]
    try:
        mesh = M.make_debug_mesh(MESH_RANKS, 1, device_type="cuda")
        t0 = time.perf_counter()
        rows = []
        if rank == 0:
            s = _wa_main_run(None, extra)["state"]
            rows = [T.map(lambda x: x[r:r + 1].cpu()
                          if isinstance(x, torch.Tensor) and x.dim() else x,
                          s) for r in range(MESH_RANKS)]
            del s
            torch.cuda.empty_cache()
        dist.barrier()
        t1 = time.perf_counter()
        got = _wa_main_run(mesh, extra)
        t2 = time.perf_counter()
        s = got.pop("state")
        if rank == 0:
            kept = rows[0]
            for r in range(1, MESH_RANKS):
                for x in tensors(rows[r]):
                    dist.send(x.contiguous(), dst=r)
        else:
            # this rank's state has its row's structure and shapes
            kept = T.map(lambda x: torch.empty(x.shape, dtype=x.dtype)
                         if isinstance(x, torch.Tensor) else x, s)
            for x in tensors(kept):
                dist.recv(x, src=0)
        del rows
        got["err"] = _state_err(s, kept)
        got["rows"] = T.leaves(s.params)[0].shape[0]
        got["one_s"], got["mesh_s"] = t1 - t0, t2 - t1
        del s
        torch.save(got, out)
    finally:
        dist.destroy_process_group()


def phase_wa_qwen3(smi: str, res: list) -> dict:
    """(c) topk_exact on the main cell (qwen3-0.6b x4, W = 2) over two
    gloo ranks (``res``: their results), one worker row a rank: B3 with
    the cross-rank union mask at the main cell's bucket sizes, 12
    launches a rank; each rank's rows within ``MESH_TOL`` of the
    one-process run's; each rank's peak."""
    problems = []
    for r in res:
        if r["launches"]["select_ef_mean"] != WA_STEPS * N_BUCKETS:
            problems.append(f"B3 launched {r['launches']['select_ef_mean']}")
        if max(r["err"].values()) > MESH_TOL:
            problems.append(f"rows {r['err']} of scale from one process")
    if res[0]["hist"] != res[1]["hist"]:
        problems.append("the ranks' metrics differ")
    print(f"[wa] (c) topk_exact qwen3-0.6b x4 W={W} on 2 gloo ranks (1 row "
          f"a rank): state {[r['err'] for r in res]} of scale from one "
          f"process; B3 {[r['launches']['select_ef_mean'] for r in res]}, "
          f"A1 / A2 {[r['launches']['dc_norms'] for r in res]} a rank; "
          f"peak a rank {[round(r['peak_bytes'] / 2**30, 3) for r in res]}"
          f" GiB; {res[0]['one_s']:.1f} s the one-process run, "
          f"{res[0]['mesh_s']:.1f} s the mesh run (no speed figure) "
          f"[{smi}]")
    check(not problems, "[wa] (c) " + "; ".join(problems))
    return {"ranks": [{k: r[k] for k in ("err", "launches", "peak_bytes",
                                         "rows")} for r in res],
            "losses": [h["loss"] for h in res[0]["hist"]]}


def phase_worker_axis(smi: str) -> dict:
    """Phase 19: (a) `phase_wa_nccl`, (b) `phase_wa_gloo`, (c)
    `phase_wa_qwen3`."""
    t0 = time.perf_counter()
    # (b) and (c) at once: two pairs of gloo ranks, each its own group,
    # together under 80 GB ((c)'s one-process run peaks at ~59 GiB); they
    # start here and wait at their gates while (a) runs
    b = _start_pair(_wa_cnn_rank, gated=True)
    c = _start_pair(_wa_qwen3_rank, gated=True)
    rec = {"nccl": phase_wa_nccl(smi)}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _open_gate(b)
    _open_gate(c)
    (res_c, codes_c), (res_b, codes_b) = _join_pair(c), _join_pair(b)
    wall = time.perf_counter() - t1
    check(res_b is not None and res_c is not None,
          f"[wa] gloo ranks exited (b) {codes_b}, (c) {codes_c}")
    rec["gloo"] = phase_wa_gloo(smi, res_b)
    rec["qwen3"] = phase_wa_qwen3(smi, res_c)
    rec["gloo_wall_s"] = wall
    print(f"[wa] (b) and (c) together, 4 gloo ranks: {wall:.1f} s wall "
          f"from their gates (no speed figure) [{smi}]")
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[wa] phase 19 took {rec['phase_s']:.1f} s with the ranks' "
          f"starts [{smi}]")
    return rec


# ---------------------------------------------------------------------------
# phase 20: serving over the mesh
# ---------------------------------------------------------------------------

SV_TOL = 1e-5            # of each step's largest logit, f32 compute
# The published configs compute in bf16 from f32 weights: the embedding's
# rows enter the first block in bf16, whose attention output is rounded
# to bf16 before `wo`.  A rank's column-parallel q, k, v agree with one
# process's product only to the last f32 bits (another GEMM over a
# column slice), and where that lands an output element on the other
# side of a bf16 rounding boundary the two runs part by one bf16 ulp
# (2^-8 of the element) from the first block on.  The bound stated for
# that cell is half an ulp of each step's largest logit, 2^-9 of it
# (measured 2.6e-4 = 2^-11.9 on an H100).  A logit off by at
# most that much on each side cannot change an argmax whose top-2 margin
# in the twin exceeds twice it: the cell's greedy tokens are compared up
# to the first position whose twin margin is below 2 * SV_BF16_TOL *
# scale (printed with the least margin), and, the loop being
# teacher-forced, its argmax at every later (row, position) whose twin
# margin clears that too.
SV_BF16_TOL = 2.0 ** -9
SV_RANKS_LIMIT_S = 600
# cell -> (arch, layers (0: all), batch, prompt tokens, generated tokens,
# compute dtype).  (a) qwen3-0.6b at its widths over (1, 2), f32 and the
# served bf16, cut to 8 of 28 layers since slice 19 (its host-bound
# loops took 37.4 / 17.0 s at 28, and phase 18's wire cells ~115 s); (c)
# each family at the smallest depth that holds its block kinds, f32,
# over (1, 2); (b) qwen3 over (2, 2), four ranks, one pair of rows a data
# rank, f32, cut to 4 of 28 layers (at 28 the cell took 30 s of a 153 s
# phase on an H100, the script 1,029 s)
SV_MAIN = {"a": ("qwen3-0.6b", 8, 4, 512, 64, "float32"),
           "a_bf16": ("qwen3-0.6b", 8, 4, 512, 64, "bfloat16")}
SV_FAMILIES = {
    "granite": ("granite-20b", 1, 2, 128, 16, "float32"),
    "mamba": ("falcon-mamba-7b", 1, 2, 128, 16, "float32"),
    "rgemma": ("recurrentgemma-9b", 3, 2, 128, 16, "float32"),
    "mla": ("minicpm3-4b", 1, 2, 128, 16, "float32"),
    "olmoe": ("olmoe-1b-7b", 1, 2, 128, 16, "float32"),
    "whisper": ("whisper-large-v3", 1, 2, 64, 16, "float32"),
    "vlm": ("qwen2-vl-7b", 1, 2, 128, 16, "float32")}
SV_FOUR = {"b": ("qwen3-0.6b", 4, 4, 512, 32, "float32")}
SV_PAIR = {**SV_MAIN, **SV_FAMILIES}


def _sv_config(cell):
    """The cell's config: the published one, cut to ``layers`` (whisper's
    encoder too), computing in ``compute``."""
    from repro_torch.configs import get_config
    arch, layers, _, _, _, compute = cell
    cfg = dataclasses.replace(get_config(arch), compute_dtype=compute)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, n_layers=layers))
    return cfg


def _sv_inputs(cfg, cell) -> dict:
    """The cell's whole batch on the card, from seed 1: token ids and what
    the prompt carries besides (`serve.stub_inputs`)."""
    from repro_torch.launch import serve
    _, _, B, P, _, _ = cell
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    return {"tokens": tokens, **serve.stub_inputs(cfg, B, P, gen)}


def _sv_cache_len(cfg, cell, model_size: int = 2) -> int:
    """The cell's cache length: the one-shot loop's (prompt, patches, the
    generated tokens and one), rounded up to a multiple of the 'model'
    axis as `OneShotGenerator` rounds it."""
    _, _, _, P, gen, _ = cell
    n = cfg.vlm.n_patches if cfg.vlm is not None else 0
    return -(-(P + n + gen + 1) // model_size) * model_size


def _sv_loop(model, params, batch: dict, cache_len: int, gen: int,
             forced=None):
    """The one-shot loop (`OneShotGenerator`'s prefill, then ``gen - 1``
    decode steps), teacher-forced on ``forced`` (B, gen) when given, so
    that every step's logits are comparable whatever the argmax: (the
    prefill's and each step's logits (B, vocab) f32 on the host, this
    run's own argmax at each position (B, gen), the cache's bytes, the
    cache)."""
    vlm = model.cfg.vlm is not None
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    out, own = [logits[:, :model.cfg.vocab_size].cpu()], [logits.argmax(-1)]
    pos = torch.full((), batch["tokens"].shape[1]
                     + (batch["patches"].shape[1] if vlm else 0),
                     dtype=torch.long, device="cuda")
    for t in range(gen - 1):
        tok = own[-1] if forced is None else forced[:, t]
        step = {"tokens": tok[:, None], "pos": pos}
        if vlm:
            step["mrope_positions"] = pos.expand(3, 1)
        logits, cache = model.decode_step(params, cache, step)
        out.append(logits[:, :model.cfg.vocab_size].cpu())
        own.append(logits.argmax(-1))
        pos = pos + 1
    from repro_torch import tree as T
    nbytes = sum(x.numel() * x.element_size() for x in T.leaves(cache))
    return out, torch.stack(own, dim=1), nbytes, cache


def _sv_gathered(cfg, cache, model_size: int) -> int:
    """Bytes a rank receives per layer and decode step from the caches
    the specs shard by position (`ModelAxis.gather_positions`): the
    other ranks' blocks of one layer's k / v (or latents), (M − 1) / M of
    the whole ``cache``'s layer; 0 where they shard by head or
    channel."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.sharding import _attn_shardable
    kv_ok = _attn_shardable(cfg.eff_n_kv_heads, model_size)
    per_layer = {}
    for path, x in shd.leaves_with_path(cache):
        name = str(path[-1])
        if name in ("ckv", "k_rope") or (name in ("k", "v", "xk", "xv")
                                         and not kv_ok):
            layer = x[0]
            per_layer[path[:-1]] = per_layer.get(path[:-1], 0) + \
                layer.numel() * layer.element_size() * (model_size - 1) \
                // model_size
    return max(per_layer.values(), default=0)


def _sv_twin(smi: str, tag: str, cell) -> dict:
    """One process's run of a cell (this process, before the ranks):
    its logits and greedy tokens, its peak, and the bytes a rank's cache
    must hold under `cache_specs` on (1, 2) (and (2, 2) for qwen3)."""
    from repro_torch.models.transformer import Model
    from repro_torch.parallel import sharding as shd
    cfg = _sv_config(cell)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = _sv_inputs(cfg, cell)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, tokens, nbytes, cache = _sv_loop(
            model, params, batch, _sv_cache_len(cfg, cell), cell[4])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    B = cell[2]
    want = {}
    for shape in ((1, 2),) + (((2, 2),) if cfg.name.startswith("qwen3")
                              else ()):
        da = ("data",) if B % shape[0] == 0 else None
        specs = shd.cache_specs(cfg, cache, model_size=shape[1],
                                data_axes=da)
        want[shape] = shd.shard_bytes(cache, specs, {"data": shape[0],
                                                     "model": shape[1]})
    gathered = _sv_gathered(cfg, cache, 2)
    top2 = [lg.topk(2, dim=-1).values for lg in logits]
    rows = torch.stack([v[:, 0] - v[:, 1] for v in top2], dim=1)
    rec = {"logits": logits, "tokens": tokens.cpu(), "peak": peak,
           "cache_bytes": nbytes, "shard_bytes": want,
           "gathered_per_layer": gathered, "margin_rows": rows,
           "margins": [float(m) for m in rows.min(dim=0).values],
           "scales": [float(lg.abs().max()) for lg in logits],
           "s": time.perf_counter() - t0}
    print(f"[sv] twin ({tag}) {cfg.name} x{cfg.n_layers} {cell[5]}: "
          f"{B} x {cell[3]} prompt tokens, {cell[4]} generated, cache "
          f"{nbytes} B, a (1, 2) rank's shard {want[(1, 2)]} B, gathered "
          f"per layer and step {gathered} B a rank; peak "
          f"{peak / 2**30:.3f} GiB; {rec['s']:.1f} s [{smi}]")
    del model, params, batch, cache
    _free_card()
    return rec


def _sv_cell(mesh, tag: str, cell, forced) -> dict:
    """One rank's share of a phase-20 cell: the cell's weights from seed
    0 built whole one rank at a time and cut to the rank's serve shards
    (`Engine.serve_params`), then, counts zeroed just before and read
    just after, the one-shot loop over the rank's rows teacher-forced on
    the twin's tokens (its logits, its own argmax) and, at f32,
    `Engine.generate` of the whole batch (its greedy tokens, every
    rank's alike; at bf16 the greedy stream leaves the twin's at the
    first position of low twin margin, so the cell is read from the
    teacher-forced loop alone)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    t_cell = time.perf_counter()
    cfg = _sv_config(cell)
    engine = Engine(Model(cfg), mesh=mesh)
    me, world = dist.get_rank(), dist.get_world_size()
    for turn in range(world):
        if turn == me:
            params = Model(cfg).init(torch.Generator(device="cuda")
                                     .manual_seed(0))
            local = engine.serve_params(params)
            del params
            _free_card()
        dist.barrier()
    batch = _sv_inputs(cfg, cell)
    rows = engine.serve_batch(batch)
    forced = engine.serve_batch({"tokens": forced.cuda()})["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, own, nbytes, cache = _sv_loop(
            engine.model, local, rows, _sv_cache_len(cfg, cell), cell[4],
            forced)
        del cache
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        generated = None if cell[5] == "bfloat16" else engine.generate(
            local, batch["tokens"], gen=cell[4],
            extra_batch=extra or None).cpu()
    torch.cuda.synchronize()
    launches = _read_counts()
    first = M.model_index(mesh) == 0
    rec = {"logits": logits if first else None, "own": own.cpu(),
           "generated": generated, "cache_bytes": nbytes,
           "launches": launches, "peak": torch.cuda.max_memory_allocated(),
           "loop_s": loop_s, "model_index": M.model_index(mesh),
           "worker_index": M.worker_index(mesh),
           "rows": rows["tokens"].shape[0]}
    del local, batch, rows, engine
    _free_card()
    rec["cell_s"] = time.perf_counter() - t_cell
    dist.barrier()
    return rec


def _sv_rank(rank: int, store: str, out: str, world: int, shape, cells,
             twins: str) -> None:
    """One spawned rank of phase 20 (`_start_pair`'s, gated): a gloo
    process group on the card (NCCL refuses two ranks on one device), a
    ('data', 'model') mesh of ``shape``, then `_sv_cell` of each of
    ``cells`` against the twins' tokens in the file ``twins``."""
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import engine, mesh as M  # noqa: F401
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forced = torch.load(twins)
    _await_gate(store)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = M.make_debug_mesh(*shape, device_type="cuda")
        torch.save({tag: _sv_cell(mesh, tag, cell, forced[tag])
                    for tag, cell in cells.items()}, out)
    finally:
        dist.destroy_process_group()


def _sv_start(shape, cells, twins: dict):
    """Start the gated ranks of a phase-20 mesh of ``shape`` (they reach
    the card, then wait for `_open_gate`), the twins' tokens in a file
    of their directory."""
    import tempfile
    path = f"{tempfile.mkdtemp()}/twins.pt"
    torch.save({t: twins[t]["tokens"][:, :cells[t][4]] for t in cells}, path)
    world = shape[0] * shape[1]
    return _start_pair(_sv_rank, world, (world, shape, cells, path),
                       gated=True), path


def _sv_join(shape, started) -> list:
    """Open a `_sv_start`'s gate, wait for its ranks: their records."""
    import shutil
    started, path = started
    _open_gate(started)
    try:
        res, codes = _join_pair(started, SV_RANKS_LIMIT_S)
    finally:
        shutil.rmtree(Path(path).parent, ignore_errors=True)
    check(res is not None, f"[sv] gloo ranks {shape} exited {codes}")
    return res


# the flash-attention (B5) and selective-scan (B6) launches a prefill
# makes on a rank, per cell (the dense decode reads its cache without a
# kernel): one per attention block, whisper's encoder and cross blocks
# too; one scan per Mamba block
def _sv_want(cfg) -> dict:
    from repro_torch.models.transformer import stage_plan
    kinds = [k for st in stage_plan(cfg) for k in st.kinds * st.repeats]
    b5 = sum(k in ("attention", "attention_local") for k in kinds) \
        + 2 * kinds.count("cross") \
        + (cfg.encoder.n_layers if cfg.encoder is not None else 0)
    return {"flash_attention": b5, "ssm_scan": kinds.count("mamba")}


def _sv_verdict(smi: str, tag: str, cell, shape, res: list, twin: dict,
                problems: list) -> dict:
    """Hold one cell's ranks to its twin, print it, append what fails to
    ``problems``."""
    cfg = _sv_config(cell)
    recs = [r[tag] for r in res]
    bf16 = cell[5] == "bfloat16"
    tol = SV_BF16_TOL if bf16 else SV_TOL
    gen, B = cell[4], cell[2]
    # the positions held to the twin's tokens: all at f32; at bf16 up to
    # the first whose twin margin is within twice the bound
    upto = gen
    if bf16:
        upto = next((t for t in range(gen) if twin["margins"][t]
                     <= 2 * tol * twin["scales"][t]), gen)
    # teacher-forced: each (row, position) whose twin margin clears twice
    # the bound is held to the twin's token on its own
    clear = twin["margin_rows"][:, :gen] > 2 * tol * torch.tensor(
        twin["scales"][:gen])
    clear[:, :upto] = True
    worst, at = 0.0, 0
    for r in recs:
        n = r["rows"]
        lo = r["worker_index"] * n if n < B else 0
        mask = clear[lo:lo + n]
        if not torch.equal(r["own"][mask],
                           twin["tokens"][lo:lo + n, :gen][mask]):
            problems.append(f"({tag}) rank {r['model_index']}/"
                            f"{r['worker_index']}: greedy tokens differ "
                            f"from the twin's before position {upto} or "
                            f"where its margin clears twice the bound")
        for t, lg in enumerate(r["logits"] or ()):
            want = twin["logits"][t][lo:lo + n]
            rel = float((lg - want).abs().max()) / twin["scales"][t]
            if rel > worst:
                worst, at = rel, t
    if worst > tol:
        problems.append(f"({tag}) logits {worst:.3g} of scale from the "
                        f"twin at step {at} (bound {tol:g})")
    gen_same = None if bf16 else all(
        torch.equal(r["generated"], twin["tokens"][:, :gen]) for r in recs)
    if gen_same is False:
        problems.append(f"({tag}) Engine.generate's tokens differ from the "
                        f"twin's")
    shard = twin["shard_bytes"][shape]
    if any(r["cache_bytes"] != shard for r in recs):
        problems.append(f"({tag}) cache bytes a rank "
                        f"{[r['cache_bytes'] for r in recs]} != shard_bytes "
                        f"{shard}")
    prefills = 1 if bf16 else 2
    want = {k: prefills * v for k, v in _sv_want(cfg).items()}
    for r in recs:
        for name in ("flash_attention", "ssm_scan"):
            if r["launches"][name] != want[name]:
                problems.append(f"({tag}) {name} launched "
                                f"{r['launches'][name]} times on a rank, "
                                f"expected {want[name]} ({prefills} "
                                f"prefills)")
        others = {k: n for k, n in r["launches"].items()
                  if k not in want and n}
        if others:
            problems.append(f"({tag}) launched {others}")
    note = f"the ranks' greedy tokens equal the twin's up to position " \
        f"{upto} of {gen} (the first whose twin top-2 margin is within " \
        f"2 x {tol:g} of scale; the least margin " \
        f"{min(twin['margins'][:gen]):.4g}, at scale " \
        f"{max(twin['scales'][:gen]):.4g}), and the loop's argmax at " \
        f"{int(clear.sum())} of {clear.numel()} (row, position) pairs " \
        f"whose twin margin clears twice the bound" if bf16 \
        else f"the ranks' greedy tokens and Engine.generate's equal the " \
        f"twin's at all {gen} positions"
    print(f"[sv] ({tag}) {cfg.name} x{cfg.n_layers} {cell[5]} over {shape}"
          f" of gloo ranks on one card, {B} x {cell[3]} tokens: {note}; "
          f"logits within {worst:.3g} of each step's scale (step {at}; "
          f"bound {tol:g}); cache bytes a rank "
          f"{[r['cache_bytes'] for r in recs]} (shard_bytes {shard}); "
          f"gathered per layer and step {twin['gathered_per_layer']} B a "
          f"rank; B5 / B6 launches a rank "
          f"{[r['launches']['flash_attention'] for r in recs]} / "
          f"{[r['launches']['ssm_scan'] for r in recs]} ({prefills} "
          f"prefills); "
          f"peak a rank {[round(r['peak'] / 2**30, 3) for r in recs]} GiB "
          f"vs the twin's {twin['peak'] / 2**30:.3f} GiB; loop "
          f"{[round(r['loop_s'], 2) for r in recs]} s, the cell "
          f"{[round(r['cell_s'], 2) for r in recs]} s [{smi}]")
    return {"worst": worst, "worst_step": at, "tol": tol,
            "tokens_upto": upto, "tokens_clear": int(clear.sum()),
            "generate_equal": gen_same,
            "cache_bytes": [r["cache_bytes"] for r in recs],
            "shard_bytes": shard,
            "gathered_per_layer": twin["gathered_per_layer"],
            "launches": [r["launches"] for r in recs],
            "peaks": [r["peak"] for r in recs], "peak_twin": twin["peak"],
            "loop_s": [r["loop_s"] for r in recs],
            "cell_s": [r["cell_s"] for r in recs],
            "twin_s": twin["s"], "min_margin": min(twin["margins"])}


def phase_sv_kernels(smi: str) -> dict:
    """B5 and B6 at the local shapes the served path gives them over a
    'model' axis of 2, against their plain versions, timed beside bound,
    plain version and SDPA (`_flash_case`; B6 as `phase_ssm_kernel`):
    qwen3's prefill (4 of 8 KV heads, G 2, 4 x 512), granite's (its one
    KV head, G 24, 2 x 128), whisper's encoder (10 of 20 heads, 2 x
    1,500 frames, bidirectional) and cross-attention (2 x 64 queries over
    1,500 frames); falcon-mamba's scan on 4,096 of 8,192 channels (2 x
    128)."""
    from repro_torch.kernels.ref import ssm_scan_plain
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_cost
    gen = torch.Generator(device="cuda").manual_seed(20)
    f32 = torch.float32
    rec = {}
    for name, KV, G, hd, B, sq, sk, causal in (
            ("qwen3 local", 4, 2, 128, 4, 512, 512, True),
            ("granite local G 24", 1, 24, 128, 2, 128, 128, True),
            ("whisper encoder local", 10, 1, 64, 2, 1500, 1500, False),
            ("whisper cross local", 10, 1, 64, 2, 64, 1500, False)):
        rec[name] = _flash_case(smi, gen, name, KV, G, hd, 1, sq, sk, 0,
                                f32, "sv-kernels", batch=B, causal=causal,
                                plain_reps=3)
    args = _ssm_case(gen, 2, 128, SSM_E // 2)
    y, h = ssm_scan(*args)
    yr, hr = ssm_scan_plain(*args)
    torch.cuda.synchronize()
    err = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
    check(err <= 1e-4, f"ssm_scan local: max abs err {err} > 1e-4")
    ms = median_ms(lambda: ssm_scan(*args))
    plain_ms = median_ms(lambda: ssm_scan_plain(*args), reps=3)
    bound, by, nbytes, flops = _bound(ssm_scan_cost(*args))
    print(f"[sv-kernels] ssm_scan falcon-mamba local: B=2 S=128 E="
          f"{SSM_E // 2} N={SSM_N}: {ms:.4f} ms/launch; plain "
          f"{plain_ms:.4f} ms; bound {bound:.4f} ms by {by} ({nbytes} B, "
          f"{flops} flops); max abs err {err:.3g} [{smi}]")
    rec["falcon-mamba local"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound, "bound_by": by,
                                 "err": err, "library_ms": None}
    del args, y, h, yr, hr
    torch.cuda.empty_cache()
    return rec


def phase_serve_mesh(smi: str) -> dict:
    """Phase 20: serving over the mesh.  Each cell's one-process twin
    runs first in this process (its logits, tokens, peak; freed before
    the ranks start), then two gloo ranks sharing the card serve (a)
    qwen3-0.6b at its widths and 8 of 28 layers over (1, 2), 4 prompts
    of 512
    tokens and 64 generated, at f32 and at the served bf16 compute, and
    each family at the smallest depth that holds its block kinds
    (`SV_FAMILIES`), f32; then four ranks serve (b) qwen3 at 4 of 28
    layers over (2, 2), a pair of rows a data rank.  Every rank: its
    logits within ``SV_TOL`` (bf16: ``SV_BF16_TOL``) of each step's scale
    from the twin's, its greedy tokens and `Engine.generate`'s (f32)
    equal to the twin's (bf16: the loop's argmax up to the first position
    of low twin margin and wherever the margin clears twice the bound),
    its cache bytes equal to `shard_bytes` under `cache_specs`, B5 / B6
    once per attention / Mamba block and prefill; peak a rank beside the
    twin's.  The ranks copy through the host: the walls are no speed
    figure."""
    t0 = time.perf_counter()
    kern = phase_sv_kernels(smi)
    twins = {tag: _sv_twin(smi, tag, cell)
             for tag, cell in {**SV_PAIR, **SV_FOUR}.items()}
    problems, rec = [], {"kernels": kern}
    # the four ranks of (b) reach the card while the pair serves
    started = {shape: _sv_start(shape, cells, twins) for shape, cells in (
        ((1, 2), SV_PAIR), ((2, 2), SV_FOUR))}
    pair = _sv_join((1, 2), started[(1, 2)])
    for tag, cell in SV_PAIR.items():
        rec[tag] = _sv_verdict(smi, tag, cell, (1, 2), pair, twins[tag],
                               problems)
    four = _sv_join((2, 2), started[(2, 2)])
    rec["b"] = _sv_verdict(smi, "b", SV_FOUR["b"], (2, 2), four,
                           twins["b"], problems)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[sv] phase 20 took {rec['phase_s']:.1f} s with the ranks' "
          f"starts [{smi}]")
    check(not problems, "[sv] " + "; ".join(problems))
    return rec


# ---------------------------------------------------------------------------
# phase 21: the example twins
# ---------------------------------------------------------------------------

LM100M_STEPS = 20


def _example(fn):
    """(fn's result, its seconds, its peak device bytes, the kernels'
    launches in it): counts zeroed and the peak reset just before."""
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t, torch.cuda.max_memory_allocated(),
            _read_counts())


def phase_examples(smi: str) -> dict:
    """Phase 21: the three example twins on the card as a user runs them:
    quickstart (the reduced qwen3, W = 4, 60 steps, Eq. 8's averaged
    weights evaluated), serve_batched (the six reduced archs' greedy
    tokens, then 6 staggered requests over 2 slots) and train_lm_100m at
    its full 12 layers (~100 M params, W = 4 x 4 x 256 tokens,
    ``LM100M_STEPS`` steps, its one checkpoint read back and held to
    ``eval_params`` bitwise); each one's losses or tokens, seconds and
    peak."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.examples import quickstart, serve_batched, \
        train_lm_100m
    problems, rec = [], {}
    q, sec, peak, n = _example(lambda: quickstart.run(device="cuda"))
    losses = [h["loss"] for h in q["history"]]
    if not (all(math.isfinite(x) for x in losses + [q["eval_loss"]])
            and losses[-1] < losses[0]):
        problems.append(f"quickstart: losses {losses}, eval "
                        f"{q['eval_loss']}")
    rec["quickstart"] = {"losses": losses, "eval_loss": q["eval_loss"],
                         "s": sec, "peak_bytes": peak, "launches": n}
    print(f"[examples] quickstart: losses {[round(x, 4) for x in losses]}, "
          f"averaged-weight eval loss {q['eval_loss']:.4f}; {sec:.1f} s, "
          f"peak {peak / 2**30:.3f} GiB [{smi}]")
    del q
    sv, sec, peak, n = _example(lambda: serve_batched.main([]))
    for arch, ids in sv["ids"].items():
        if tuple(ids.shape) != (serve_batched.BATCH, 8):
            problems.append(f"serve_batched {arch}: ids {tuple(ids.shape)}")
    lens = [len(r.out) for r in sorted(sv["done"], key=lambda r: r.rid)]
    if lens != [3 + 3 * i for i in range(6)]:
        problems.append(f"serve_batched: stream lengths {lens}")
    rec["serve_batched"] = {
        "first_tokens": {a: ids[0, :6].tolist()
                         for a, ids in sv["ids"].items()},
        "stream_tokens": lens, "s": sec, "peak_bytes": peak,
        "launches": n}
    print(f"[examples] serve_batched: {len(sv['ids'])} archs x (4, 8) "
          f"greedy tokens, the stream's {lens} tokens; {sec:.1f} s, peak "
          f"{peak / 2**30:.3f} GiB [{smi}]")
    del sv
    with _scratch_dir(2 * 10**9) as tmp:
        tr, sec, peak, n = _example(lambda: train_lm_100m.main(
            ["--steps", str(LM100M_STEPS), "--out", str(tmp)]))
        ev = tr["alg"].eval_params(tr["state"])
        n_params = sum(x.numel() for x in T.leaves(ev))
        if [p.name for p in tr["ckpts"]] != ["final.npz"]:
            problems.append(f"train_lm_100m: checkpoints {tr['ckpts']}")
        back = restore_pytree(tr["ckpts"][-1], ev)
        same = _bitwise(T.map(lambda x: x.cpu(), back),
                        T.map(lambda x: x.cpu(), ev))
    losses = [h["loss"] for h in tr["history"]]
    if not same or not all(math.isfinite(x) for x in losses):
        problems.append(f"train_lm_100m: checkpoint bitwise {same}, "
                        f"losses {losses}")
    rec["train_lm_100m"] = {"params": n_params, "losses": losses,
                            "checkpoint_bitwise": same, "s": sec,
                            "train_s": tr["wall_s"], "peak_bytes": peak,
                            "launches": n}
    print(f"[examples] train_lm_100m x12 ({n_params} params), "
          f"{LM100M_STEPS} steps: losses {[round(x, 4) for x in losses]}, "
          f"checkpoint read back bitwise {same}; {sec:.1f} s "
          f"({tr['wall_s']:.1f} s of steps), peak {peak / 2**30:.3f} GiB "
          f"[{smi}]")
    del tr, ev, back
    check(not problems, "[examples] " + "; ".join(problems))
    return rec


# ---------------------------------------------------------------------------
# phase 22: long-sequence training, the Model's memory knobs
# ---------------------------------------------------------------------------

LONG_SEQ = 4096        # train_4k's sequence length
LONG_STEPS = 3
# of the card's memory the largest batch's tensors may reach: the caching
# allocator needs the rest (at 10 sequences, 92 %, it held 11.4 GiB
# reserved but unallocated when the 11.6 GiB loss chunk asked for more)
LONG_CAP = 0.80


def _long_build(remat: bool, per_worker: int, kernels: bool = True):
    """(engine, state, batch_fn) of the long cell: the main cell (qwen3-0.6b
    x4, W = 2, 4 buckets, TF32 off, the fused tail unless ``kernels`` is
    off) at ``per_worker`` sequences of `LONG_SEQ` tokens a worker, its
    Model built as the reference's defaults build it (attention in blocks
    of 512 queries x 1,024 keys, loss chunks of 2,048), with ``remat``."""
    from repro_torch.launch import train
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    argv = list(MAIN_ARGS)
    argv[argv.index("--seq") + 1] = str(LONG_SEQ)
    argv[argv.index("--batch-per-worker") + 1] = str(per_worker)
    argv += ["--steps", str(LONG_STEPS)] + (["--use-kernels"] if kernels
                                            else [])
    model, alg, state, batch_fn = train.build(
        train.build_argparser().parse_args(argv))
    return Engine(Model(model.cfg, remat=remat), alg), state, batch_fn


def _long_run(remat: bool, per_worker: int, steps: int = LONG_STEPS) -> dict:
    """``steps`` steps of the long cell through ``Engine.fit`` under
    deterministic algorithms, counts zeroed just before and read just
    after: the final state, the losses, the median host-clock seconds of
    steps 2-3, the peak after a reset and what was allocated before it
    (the state), the launches."""
    engine, state, batch_fn = _long_build(remat, per_worker)
    _free_card()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, hist, _ = engine.fit(state, batch_fn, steps=steps,
                                    log_every=1)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    walls = [h["wall_s"] for h in hist]
    laps = [b - a for a, b in zip(walls, walls[1:])]
    return {"state": state, "losses": [h["loss"] for h in hist],
            "step_s": statistics.median(laps) if laps else None,
            "peak": torch.cuda.max_memory_allocated(), "before": before,
            "launches": _read_counts()}


def _long_fake_peak() -> dict:
    """The dry-run's fake-mode ``traced_peak`` of (iii)'s step: the long
    cell's Model with remat, W = 2, 4 buckets, the plain tail, one
    sequence of `LONG_SEQ` tokens a worker, through
    ``Engine.trace_train_step`` on fake tensors (nothing on the card;
    `_start_dryrun` runs it in a subprocess, `main_long_fake_peak`)."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.core.types import DCS3GDConfig
    from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
    from repro_torch.launch import specs as S
    from repro_torch.launch.dryrun import traced_peak
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    model = Model(cfg, remat=True)
    dc = DCS3GDConfig(warmup_steps=1, total_steps=LONG_STEPS)
    alg = registry.make("dc_s3gd", dc, n_workers=W, use_kernels=False,
                        buckets=N_BUCKETS)
    engine = Engine(model, alg)
    real = worker_batches(SyntheticLMDataset(cfg.vocab_size, LONG_SEQ,
                                             seed=0), 0, W, 1, device="cpu")
    t0 = time.perf_counter()
    with S.fake_mode():
        state = S.abstract_train_state(model, W, dc, alg)
        batch = {k: torch.empty(v.shape, dtype=v.dtype)
                 for k, v in real.items()}
        _, peak = traced_peak(lambda: engine.trace_train_step(state, batch),
                              (state, batch))
    return {"fake_peak": peak, "trace_s": time.perf_counter() - t0}


def main_long_fake_peak() -> None:
    """`_long_fake_peak` as a subprocess's JSON line (torch on the CPU)."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    print(json.dumps(_long_fake_peak()))


def _long_traced_peaks(fake: dict) -> dict:
    """(iii) The (i) step on the plain tail with remat, one step through
    ``Engine.trace_train_step`` (what the dry-run traces): on the card
    the inputs' bytes plus the peak above what was allocated before it
    (``max_memory_allocated`` after a reset), beside ``fake``, the
    dry-run's fake-mode ``traced_peak`` of the same config, batch and
    route (`_long_fake_peak`)."""
    from repro_torch import tree as T
    engine, state, batch_fn = _long_build(True, 1, kernels=False)
    batch = batch_fn(0)
    inputs = sum(x.numel() * x.element_size()
                 for x in T.leaves((state, batch))
                 if isinstance(x, torch.Tensor))
    _free_card()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = engine.trace_train_step(state, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - before + inputs
    del out, state
    _free_card()
    return {"card_peak": card_peak, "inputs": inputs, **fake}


def _long_grad_peaks(params, remat: bool, counts=(1, 2)) -> dict:
    """One worker's loss and gradients (what ``_vgrads`` holds for each
    worker in turn) at each of ``counts`` sequences of `LONG_SEQ` tokens:
    the peak above what was allocated before it, after a reset."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    model = Model(dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4),
                  remat=remat)
    leaves = [x.detach().requires_grad_() for x in T.leaves(params)]
    tree = T.unflatten(T.flatten(params)[1], leaves)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for n in counts:
        tokens = torch.randint(0, model.cfg.vocab_size, (n, LONG_SEQ),
                               generator=gen, device="cuda")
        _free_card()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(
            model.loss(tree, {"tokens": tokens, "labels": tokens}), leaves)
        torch.cuda.synchronize()
        out[n] = torch.cuda.max_memory_allocated() - before
        del grads, tokens
    return out


def _one_block_ab(smi: str) -> dict:
    """The plain core where one key block holds every key, the two ways
    `blocked_attention` can take it: the online softmax over the one
    block (``ordered=False``) and the plain softmax that ``ordered``
    takes (`causal_attention`), the same function.  Forward and backward
    at qwen3's heads (8 KV x 2, hd 128), f32, causal, medians of 10: at
    phase 5's 4 x 256 tokens and at 1 x 1,024 (the Model's own
    ``kv_chunk``)."""
    from repro_torch.models.attention import blocked_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {}
    for B, S in ((4, 256), (1, 1024)):
        q, k, v, g = (torch.randn(shape, device="cuda", generator=gen)
                      for shape in ((B, S, 8, 2, 128), (B, S, 8, 128),
                                    (B, S, 8, 128), (B, S, 8, 2, 128)))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        pos = torch.arange(S, device="cuda")

        def core(ordered):
            return blocked_attention(q, k, v, pos, pos, causal=True,
                                     window=0, q_chunk=S, kv_chunk=S,
                                     ordered=ordered)
        ms = {o: median_ms(lambda o=o: torch.autograd.grad(
            core(o), (q, k, v), g)) for o in (True, False)}
        with torch.no_grad():
            err = float((core(True) - core(False)).abs().max())
        rec[f"{B}x{S}"] = {"softmax_ms": ms[True], "online_ms": ms[False],
                           "max_abs_err": err}
        print(f"[long] one key block, {B} x {S} tokens, forward and "
              f"backward: the plain softmax {ms[True]:.3f} ms, the online "
              f"softmax {ms[False]:.3f} ms, {err:.3g} apart [{smi}]")
    return rec


def phase_long_seq(smi: str, dry: tuple) -> dict:
    """Phase 22: the main cell at train_4k's 4,096-token sequences.  (i)
    one sequence a worker, ``remat`` off then on, `LONG_STEPS` steps each
    on the fused tail: bitwise the same state (params, opt, comm), each
    run's peak, step time and A1 / A2 launches a step; and one worker's
    gradient pass alone at one and two sequences (`_long_grad_peaks`),
    whose peak the activations set (the step's own peak at one sequence
    is the fused tail's, the same with remat or without).  (ii) the
    largest per-worker batch ``remat`` fits by arithmetic: the step's
    state, ``_vgrads``'s gradient buffer (W x the params) and the
    gradient pass at that batch (its peak linear in the sequences) within
    `LONG_CAP` of the card's memory; whether ``remat`` off fits it, by the
    same arithmetic; then a step at it.  (iii) the plain tail's traced
    step on the card beside the dry-run's fake-mode peak of the same
    config, batch and route (`_long_traced_peaks`), within 10 %."""
    from repro_torch import tree as T
    problems, rec = [], {}
    runs = {}
    for remat in (False, True):
        r = _long_run(remat, 1)
        runs[remat] = r
        tag = "on" if remat else "off"
        steps = len(r["losses"])
        rec[f"remat_{tag}"] = {
            "losses": r["losses"], "step_ms": r["step_s"] * 1e3,
            "peak_bytes": r["peak"], "before_bytes": r["before"],
            "launches": r["launches"],
            "launches_per_step": {k: n / steps for k, n in
                                  r["launches"].items() if n}}
        if not all(map(math.isfinite, r["losses"])) or any(
                r["launches"][k] != steps * N_BUCKETS
                for k in ("dc_norms", "dc_fused_update")):
            problems.append(f"remat {tag}: losses {r['losses']}, "
                            f"launches {r['launches']}")
        print(f"[long] qwen3-0.6b x4, W={W}, 1 x {LONG_SEQ} tokens a "
              f"worker, remat {tag}: losses "
              f"{[round(x, 6) for x in r['losses']]}; step "
              f"{r['step_s'] * 1e3:.1f} ms (median of steps 2-3); peak "
              f"{r['peak'] / 2**30:.3f} GiB ({r['peak']} B; "
              f"{r['before'] / 2**30:.3f} GiB held before); A1 / A2 "
              f"{r['launches']['dc_norms']} / "
              f"{r['launches']['dc_fused_update']} [{smi}]")
        if not remat:
            # on the host, so that the next run's peak is its own
            r["state"] = T.map(lambda x: x.cpu() if isinstance(
                x, torch.Tensor) else x, r["state"])
            _free_card()
    on = T.map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
               runs[True]["state"])
    same = {p: _bitwise(getattr(on, p), getattr(runs[False]["state"], p))
            for p in ("params", "opt", "comm")}
    del on
    rec["bitwise"] = same
    if not all(same.values()):
        problems.append(f"remat on != off: {same}")
    print(f"[long] remat on == off after {LONG_STEPS} steps, bitwise: "
          f"{same} [{smi}]")
    params = T.map(lambda x: x[0].clone(), runs[True]["state"].params)
    buffer = sum(x.numel() * 4 for x in T.leaves(runs[True]["state"]
                                                    .params))
    for r in runs.values():
        del r["state"]
    _free_card()
    # (ii) the gradient pass's peak per sequence, with and without remat
    grad = {remat: _long_grad_peaks(params, remat) for remat in (False,
                                                                  True)}
    del params
    _free_card()
    slope = {m: g[2] - g[1] for m, g in grad.items()}
    base = {m: g[1] - slope[m] for m, g in grad.items()}
    before = runs[False]["before"]
    cap = LONG_CAP * torch.cuda.mem_get_info()[1]

    def need(m, n):
        return before + buffer + base[m] + n * slope[m]
    most = int((cap - before - buffer - base[True]) // slope[True])
    off_most = int((cap - before - buffer - base[False]) // slope[False])
    rec["grad_pass"] = {f"remat_{'on' if m else 'off'}": {
        "peak_1_bytes": g[1], "peak_2_bytes": g[2],
        "slope_bytes": slope[m]} for m, g in grad.items()}
    rec["batch"] = {"cap_bytes": cap, "buffer_bytes": buffer,
                    "per_worker": most, "off_most": off_most,
                    "predicted_peak": max(runs[True]["peak"],
                                          need(True, most)),
                    "off_need": need(False, most),
                    "off_fits": need(False, most) <= cap}
    for m in (False, True):
        print(f"[long] one worker's gradient pass, remat "
              f"{'on' if m else 'off'}: {grad[m][1] / 2**30:.3f} GiB at 1 "
              f"sequence, {grad[m][2] / 2**30:.3f} GiB at 2 "
              f"({slope[m] / 2**30:.3f} GiB a sequence) [{smi}]")
    print(f"[long] within {cap / 2**30:.1f} GiB: remat fits {most} x "
          f"{LONG_SEQ} tokens a worker, remat off {off_most}; at {most} "
          f"remat off would need {need(False, most) / 2**30:.1f} GiB "
          f"[{smi}]")
    if most < 1:
        problems.append(f"remat fits {most} sequences")
    else:
        big = _long_run(True, most, steps=1)
        del big["state"]
        _free_card()
        rec["batch"].update(losses=big["losses"], peak_bytes=big["peak"],
                            launches=big["launches"])
        if big["peak"] > cap or not all(map(math.isfinite, big["losses"])):
            problems.append(f"{most} sequences: peak {big['peak']}, losses "
                            f"{big['losses']}")
        print(f"[long] remat at {most} x {LONG_SEQ} tokens a worker, one "
              f"step: loss {big['losses']}; peak "
              f"{big['peak'] / 2**30:.3f} GiB (predicted "
              f"{rec['batch']['predicted_peak'] / 2**30:.3f}) [{smi}]")
    # (iii) the dry-run's fake-mode peak (traced in a subprocess since the
    # script's start) against the card's
    thread, box = dry
    thread.join()
    fake = box.get("long_fake")
    check(fake is not None and fake["r"].returncode == 0,
          f"[long] the fake-mode trace: {fake and fake['r'].stderr[-2000:]}")
    tp = _long_traced_peaks(json.loads(
        fake["r"].stdout.strip().splitlines()[-1]))
    gap = (tp["card_peak"] - tp["fake_peak"]) / tp["card_peak"]
    rec["traced"] = {**tp, "gap": gap}
    if abs(gap) > 0.10:
        problems.append(f"fake-mode peak {tp['fake_peak']} vs the card's "
                        f"{tp['card_peak']}: {gap:.3g}")
    print(f"[long] plain tail, remat on, 1 x {LONG_SEQ} tokens a worker, "
          f"one traced step: the card's peak {tp['card_peak']} B "
          f"({tp['card_peak'] / 2**30:.3f} GiB, inputs {tp['inputs']} B), "
          f"the dry-run's fake-mode peak {tp['fake_peak']} B: the card "
          f"{gap * 100:+.2f} % ({tp['trace_s']:.1f} s to trace) [{smi}]")
    rec["one_block"] = _one_block_ab(smi)
    check(not problems, "[long] " + "; ".join(problems))
    return rec


def _lap_phases(t0: float) -> None:
    """Wrap every ``phase_*`` function of this module so that each call
    prints its own wall time and the time since ``t0`` (the script must
    end within 1,200 s; these lines say where the time went).  Phases
    that call phases print nested laps."""
    import functools
    g = globals()
    for name, fn in list(g.items()):
        if not (name.startswith("phase_") and callable(fn)):
            continue

        def lapped(*a, __fn=fn, __name=name, **kw):
            t = time.perf_counter()
            try:
                return __fn(*a, **kw)
            finally:
                now = time.perf_counter()
                print(f"[lap] {__name}: {now - t:.1f} s, {now - t0:.1f} s "
                      f"since the start", flush=True)
        g[name] = functools.wraps(fn)(lapped)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    _lap_phases(t_start)
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
    dry = _start_dryrun()

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
    b3_modes = {"qwen3": phase_select_modes(plan.bucket_sizes, W, smi)}
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
    b3_modes["cnn"] = phase_select_modes(cnn_plan.bucket_sizes, CNN_W, smi,
                                         "kernels-cnn")
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
    del model, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix = phase_serve_prefix(smi)
    prefix["phase_s"] = time.perf_counter() - t0
    print(f"[prefix] the prefix-cache phase took {prefix['phase_s']:.1f} s "
          f"[{smi}]")
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s14 = {"nccl": phase_mesh_nccl(smi)}
    s14["gloo"] = phase_mesh_gloo(smi)
    s14["dryrun"] = phase_dryrun(smi, dry)
    s14["phase_s"] = time.perf_counter() - t0
    print(f"[mesh] the NCCL mesh, two gloo ranks and dry-run phases took "
          f"{s14['phase_s']:.1f} s [{smi}]")
    torch.cuda.empty_cache()
    s15 = phase_tensor_parallel(smi)
    torch.cuda.empty_cache()
    s19 = phase_worker_axis(smi)
    torch.cuda.empty_cache()
    s20 = phase_serve_mesh(smi)
    torch.cuda.empty_cache()
    ex = phase_examples(smi)
    torch.cuda.empty_cache()
    long = phase_long_seq(smi, dry)
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
          f"{hs['launches']['flash_attention']} launches = {RG_SERVE_LOCAL} x "
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
    for key, what in (("olmoe", f"olmoe-1b-7b x{OLMOE_SERVE_LAYERS}"),
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
    for key, what in (("vlm", f"qwen2-vl-7b x{VLM_SERVE_LAYERS}"),
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
    for tag in ("inline", "overlap"):
        r = s14["nccl"][tag]
        print(f"[times] main cell on an NCCL mesh (1, 1), {tag}: step "
              f"{r['mesh']['step_ms']:.3f} ms vs mesh=None "
              f"{r['none']['step_ms']:.3f} ms (median of {MESH_TIMED}), "
              f"peak {r['mesh']['peak_bytes'] / 2**30:.3f} GiB vs "
              f"{r['none']['peak_bytes'] / 2**30:.3f} GiB, host syncs "
              f"{r['mesh']['host_syncs']} [{smi}]")
    print(f"[times] serve falcon-mamba-7b x{FM_LAYERS}, 16 slots: "
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
             f"serve olmoe-1b-7b x{OLMOE_SERVE_LAYERS}":
                 moe["serve"]["olmoe"]["launches"],
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
    mla_paths = {f"serve minicpm3-4b x{MINICPM_LAYERS}":
                 moe["mla"]["whole"]["launches"],
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
    # slice 14: A1 / A2 on the worker axis over process groups (counts
    # zeroed before each run and read after): the main cell on the NCCL
    # mesh of one rank, inline and overlapped, and each gloo rank's CNN
    for entry in kernels:
        name = entry["name"]
        entry["mesh"] = {
            "launches_nccl_inline": s14["nccl"]["inline"]["mesh"][
                "launches"][name],
            "launches_nccl_overlap": s14["nccl"]["overlap"]["mesh"][
                "launches"][name],
            "launches_gloo_ranks": [r[name] for r in s14["gloo"]["launches"]]}
    # slice 16: the worker axis across ranks for every reducer (counts
    # zeroed before each run and read after): (a) the main cell on the
    # NCCL mesh of one rank per reducer / policy / algorithm, (b) each gloo
    # rank's CNN cases, (c) each gloo rank's topk_exact on the main cell
    for entry in kernels:
        name = entry["name"]
        entry["worker_axis"] = {
            "launches_nccl": {t: r["launches"][name]
                              for t, r in s19["nccl"].items()},
            "launches_gloo_cnn": {t: [n[name] for n in r["launches"]]
                                  for t, r in s19["gloo"].items()
                                  if isinstance(r, dict)},
            "launches_gloo_qwen3_topk_exact": [
                r["launches"][name] for r in s19["qwen3"]["ranks"]],
            # the elastic case across meshes: per membership, each rank's
            "launches_gloo_cnn_relayout": [
                {"W": seg[0]["W"], "ranks": [x["launches"][name]
                                             for x in seg]}
                for seg in zip(*s19["gloo"]["elastic 8-6-3-4"]
                               ["segments"])],
            "launches_examples": {k: v["launches"][name]
                                  for k, v in ex.items()}}
        if name == "select_ef_mean":
            entry["modes_checked"] = b3_modes
    # slice 19: each kernel's launches a rank in phase 18's wire cells
    # (counts zeroed before each cell's mesh run, read after); B3's at the
    # whole buckets, whose cross-rank modes were held to its plain version
    for entry in kernels:
        name = entry["name"]
        entry["tp_wires"] = {"launches_by_cell": {
            t: [n[name] for n in s15[t]["launches"]] for t, _, _ in TP_WIRES}}
        if name == "select_ef_mean":
            entry["tp_wires"]["whole_sizes"] = s15["wires"]["whole_sizes"]
    # slice 18: B5 and B6 on the served path over the mesh (counts zeroed
    # before each cell's loop and generate, read after, per rank) and at
    # the local shapes, each beside its bound, plain version and SDPA
    for entry in kernels:
        name = entry["name"]
        entry["serve_mesh"] = {
            "launches_by_cell": {t: [n[name] for n in r["launches"]]
                                 for t, r in s20.items()
                                 if isinstance(r, dict) and "launches" in r}}
        if name in ("flash_attention", "ssm_scan"):
            entry["serve_mesh"]["local_shapes"] = {
                c: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "err")}
                for c, r in s20["kernels"].items()
                if (c == "falcon-mamba local") == (name == "ssm_scan")}
    # slice 21: A1 and A2 on the long-sequence path (counts zeroed before
    # each run, read after; the main cell's bucket sizes, held to their
    # plain versions in phase 2)
    for entry in kernels:
        entry["long_seq"] = {"launches": {
            f"remat {t}": long[f"remat_{t}"]["launches"][entry["name"]]
            for t in ("off", "on")}}
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
              "vlm_encdec": mm, "analysis": s13, "multi_device": s14,
              "tensor_parallel": s15, "worker_axis": s19,
              "serve_mesh": s20, "examples": ex, "long_seq": long,
              "select_modes": b3_modes,
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

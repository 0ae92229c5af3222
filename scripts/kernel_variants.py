#!/usr/bin/env python3
"""Time design variants of the paged-attention (B4) and selective-scan (B6)
CUDA kernels on one GPU, each against the committed design in one process.

    python3 scripts/kernel_variants.py

Each variant is the committed source under ``src/repro_torch/kernels/csrc``
with one constant or template argument replaced, built by the same ``nvcc``
flags into ``build/probe/`` (git-ignored) and timed through
``chip_smoke.py``'s own phases (``phase_paged_kernel``,
``phase_ssm_kernel``: cold per-layer pools for B4, 8 queued launches for B6,
median of 10 samples), the committed build first and last:

- B4: tiles of 16 tokens with 3 stages, 16 with 2, 32 with 2 (committed);
  16, 8 and 32 pass-1 CTAs per SM (``splits_for``'s target);
- B6: the exact step (expf, separate roundings) in every pass against the
  SFU ex2 + fma step past one chunk (committed); chunk targets of 2, 4
  (committed) and 8 CTAs per SM (``chunk_length``).

Prints one line per run with the card's name and power limit; needs a CUDA
device and imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _variant(name: str, tag: str, replace):
    """The committed ``csrc/<name>.cu`` with ``replace`` = [(old, new)]
    applied, built and loaded as library ``name``."""
    from repro_torch.kernels import build
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in replace:
        if old not in src:
            raise RuntimeError(f"{name}.cu no longer holds {old!r}")
        src = src.replace(old, new)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}_{tag}.cu", out / f"{name}_{tag}.so"
    cu.write_text(src)
    run = subprocess.run([build._nvcc(), *build.FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{run.stderr}")
    return build._open(name, so, 0.0)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card()
    cs.phase_build(smi)

    tile = "constexpr int kTile = 32; "
    stages = "constexpr int kStages = 2;"
    paged = {"tile 32, 2 stages (committed)": build._LOADED[
        "paged_attention"]}
    paged["tile 16, 3 stages"] = _variant(
        "paged_attention", "t16s3",
        [(tile, "constexpr int kTile = 16; "),
         (stages, "constexpr int kStages = 3;")])
    paged["tile 16, 2 stages"] = _variant(
        "paged_attention", "t16s2", [(tile, "constexpr int kTile = 16; ")])
    committed_splits = pa._CTAS_PER_SM
    runs = [(k, committed_splits) for k in paged] + [
        ("tile 32, 2 stages (committed)", 8),
        ("tile 32, 2 stages (committed)", 32),
        ("tile 32, 2 stages (committed)", committed_splits)]
    for tag, per_sm in runs:
        build._LOADED["paged_attention"] = paged[tag]
        pa._CTAS_PER_SM = per_sm
        rec = cs.phase_paged_kernel(smi)
        print(f"[variants] B4 {tag}, {per_sm} pass-1 CTAs per SM "
              f"({rec['split_k']['splits']} splits): bf16 "
              f"{rec['bfloat16']['ms']:.4f} ms, f32 "
              f"{rec['float32']['ms']:.4f}, int8 {rec['int8']['ms']:.4f}, "
              f"fp8 {rec['fp8']['ms']:.4f} [{smi}]", flush=True)
    build._LOADED["paged_attention"] = paged["tile 32, 2 stages (committed)"]
    pa._CTAS_PER_SM = committed_splits

    scans = {"ex2 + fma past one chunk (committed)": build._LOADED[
        "ssm_scan"]}
    scans["exact step in every pass"] = _variant(
        "ssm_scan", "exact",
        [("launch_pass<N, false, false>", "launch_pass<N, false, true>"),
         ("launch_pass<N, true, false>", "launch_pass<N, true, true>")])
    committed_chunks = ss._CTAS_PER_SM
    runs = [(k, committed_chunks) for k in scans] + [
        ("ex2 + fma past one chunk (committed)", 2),
        ("ex2 + fma past one chunk (committed)", 8),
        ("ex2 + fma past one chunk (committed)", committed_chunks)]
    for tag, per_sm in runs:
        build._LOADED["ssm_scan"] = scans[tag]
        ss._CTAS_PER_SM = per_sm
        rec = cs.phase_ssm_kernel(smi)
        times = ", ".join(f"{name} {r['ms']:.4f} ms (L={r['chunk']}, "
                          f"err {r['err']:.2g})" for name, r in rec.items())
        print(f"[variants] B6 {tag}, chunk target {per_sm} CTAs per SM: "
              f"{times} [{smi}]", flush=True)
    build._LOADED["ssm_scan"] = scans["ex2 + fma past one chunk (committed)"]
    ss._CTAS_PER_SM = committed_chunks
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time design variants of the paged-attention (B4) and selective-scan (B6)
CUDA kernels on one GPU, each against the committed design in one process.

    python3 scripts/kernel_variants.py [B4] [B5] [B6]    (default: all three)

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
  (committed) and 8 CTAs per SM (``chunk_length``);
- B5: three warpgroups splitting the key tiles for bf16 and two for f32
  (committed) against one and two for both; the TF32 split in integer
  instructions (committed) against ``cvt.rna`` for hi and lo; the
  shared-memory limit raised once per device (committed) against on every
  launch; and the earlier CUDA-core design (scalar fmaf products, one
  query head per CTA), built from
  ``build/parent/src/repro_torch/kernels/csrc/flash_attention.cu`` where
  that file is there (``git archive`` of a commit that holds it, unpacked
  into the git-ignored ``build/parent/``).  Each timed at the qwen3-0.6b
  prefill's shapes (B 1, 8 kv heads, G 2, hd 128, causal, S 128 to 512,
  and 16 for the floor of one launch; f32 and bf16; 28 queued launches
  per sample) and checked against the plain version.

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


def _variant(name: str, tag: str, replace, source=None):
    """The committed ``csrc/<name>.cu`` (or ``source``) with ``replace`` =
    [(old, new)] applied, built and loaded as library ``name``."""
    from repro_torch.kernels import build
    src = (source or build.CSRC / f"{name}.cu").read_text()
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
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.card()
    cs.phase_build(smi)

    which = set(sys.argv[1:]) or {"B4", "B5", "B6"}
    if "B4" in which:
        _paged_variants(smi)
    if "B6" in which:
        _scan_variants(smi)
    if "B5" in which:
        _flash_variants(smi)
    return 0


def _paged_variants(smi: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
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



def _scan_variants(smi: str) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import ssm_scan as ss
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


def _flash_variants(smi: str) -> None:
    from repro_torch.kernels import build
    split = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
             "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
    cvt = ("  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(hi) : \"f\"(x));\n"
           "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(lo) : "
           "\"f\"(x - __uint_as_float(hi)));\n")
    committed = "committed (f32 2 warpgroups, bf16 3; integer split)"
    wgs = "return std::is_same<T, float>::value || HD == 256 ? 2 : 3;"
    flashes = {committed: build._LOADED["flash_attention"]}
    flashes["1 warpgroup"] = _variant("flash_attention", "wg1",
                                      [(wgs, "return 1;")])
    flashes["2 warpgroups"] = _variant("flash_attention", "wg2",
                                       [(wgs, "return 2;")])
    flashes["cvt.rna split"] = _variant("flash_attention", "cvt",
                                        [(split, cvt)])
    flashes["smem limit raised on every launch"] = _variant(
        "flash_attention", "attr",
        [("smem > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])",
          "smem > 48 * 1024")])
    parent = ROOT / "build" / "parent" / "src" / "repro_torch" / "kernels" \
        / "csrc" / "flash_attention.cu"
    if parent.exists():
        flashes["CUDA-core design"] = _variant("flash_attention", "cores", [],
                                           source=parent)
    order = list(flashes) + [committed]
    for tag in order:
        build._LOADED["flash_attention"] = flashes[tag]
        times = ", ".join(f"{name} {ms:.4f} ms (err {err:.2g})"
                          for name, (ms, err) in _flash_times().items())
        print(f"[variants] B5 {tag}: {times} [{smi}]", flush=True)
    build._LOADED["flash_attention"] = flashes[order[-1]]


def _flash_times() -> dict:
    """flash_attention at the qwen3-0.6b prefill's shapes: {case: (ms per
    launch, max abs err against the plain version)}."""
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(3)
    KV, G, hd = cs.FLASH_SHAPE
    out = {}
    for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        for S in (16,) + cs.PROMPT_LENS:    # 16: one tile, the launch floor
            q = torch.randn((1, S, KV, G, hd), generator=gen,
                            device="cuda").to(dt)
            k, v = (torch.randn((1, S, KV, hd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            err = float((flash_attention(q, k, v).float()
                         - flash_attention_plain(q, k, v).float()
                         ).abs().max())
            cs.check(err <= atol, f"flash_attention S={S} {dt}: max abs "
                     f"err {err} > {atol}")
            ms = cs.median_ms(lambda: flash_attention(q, k, v),
                              batch=cs.PREFILL_LAYERS)
            out[f"S={S} {str(dt)[6:]}"] = (ms, err)
    return out


if __name__ == "__main__":
    sys.exit(main())

"""Build and load the CUDA kernels (plain C interface, bound with ctypes).

Every source in ``csrc/`` (``dc_update.cu``, ``compress.cu``,
``paged_attention.cu``, ``flash_attention.cu``, ``ssm_scan.cu``) is compiled
by its own ``nvcc`` call into its own shared library under
``<repo>/build/kernels/`` (git-ignored), at first use; each library's name
carries a hash of its source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  `load_all` starts the missing
builds together and waits for all of them.  Nothing is compiled at import
time: this module imports on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c = ctypes
_P, _I64, _I32, _F32 = _c.c_void_p, _c.c_int64, _c.c_int, _c.c_float
_UPDATE = [_P, _P, _P, _P, _P, _F32, _F32, _F32, _I64, _I64, _I32, _I32, _P,
           _P, _P, _P]
_PAGED = [_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
          _F32, _I32, _I32, _P, _P, _P]
_FLASH = [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
          _F32, _P]
# source stem -> argtypes of each of its C entry points
SIGNATURES = {
    "dc_update": {
        "dc_norms_f32": [_P, _P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P],
        "dc_fused_update_f32w": _UPDATE,
        "dc_fused_update_bf16w": _UPDATE,
    },
    "compress": {
        "select_ef_mean_f32": [_P, _P, _I64, _I64, _I32, _I32, _F32, _I32,
                               _I32, _P, _P, _P],
    },
    "paged_attention": {
        f"paged_attention_{pool}": _PAGED
        for pool in ("f32", "bf16", "f16", "i8", "fp8")
    },
    "flash_attention": {
        "flash_attention_f32": _FLASH,
        "flash_attention_bf16": _FLASH,
    },
    "ssm_scan": {
        "ssm_scan_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                         _I32, _I32, _P],
    },
}


@dataclasses.dataclass
class Built:
    """One loaded library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # 0.0 when an existing build was loaded
    ptxas: List[str]        # the -Xptxas -v lines (registers, smem, spills)


_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _open(name: str, out: Path, seconds: float) -> Built:
    log = out.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "ptxas info" in ln] if log.exists() else []
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Built(lib=lib, path=out, seconds=seconds, ptxas=ptxas)


def load_all(names=tuple(SIGNATURES)) -> Dict[str, Built]:
    """Build (once, one ``nvcc`` per source, all started together) and load
    the named libraries; cached."""
    t0 = time.perf_counter()
    running = {}
    for name in names:
        if name in _LOADED:
            continue
        out = _target(name)
        if out.exists():
            _LOADED[name] = _open(name, out, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running[name] = (proc, out, tmp)
    failed = []
    for name, (proc, out, tmp) in running.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
        _LOADED[name] = _open(name, out, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _LOADED:
        load_all((name,))
    return _LOADED[name].lib

"""Build and load the CUDA kernels (plain C interface, bound with ctypes).

``csrc/dc_update.cu`` is compiled by one ``nvcc`` call into a shared
library under ``<repo>/build/kernels/`` (git-ignored), at first use; the
library name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing is
compiled at import time: this module imports on a machine with no CUDA
toolkit.
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
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCE = CSRC / "dc_update.cu"

_c = ctypes
_P, _I64, _I32, _F32 = _c.c_void_p, _c.c_int64, _c.c_int, _c.c_float
_UPDATE = [_P, _P, _P, _P, _P, _F32, _F32, _F32, _I64, _I64, _I32, _I32, _P,
           _P, _P, _P]
# argtypes of every C entry point of dc_update.cu
SIGNATURES = {
    "dc_norms_f32": [_P, _P, _I64, _I64, _I32, _I32, _I32, _P, _P, _P],
    "dc_fused_update_f32w": _UPDATE,
    "dc_fused_update_bf16w": _UPDATE,
}


@dataclasses.dataclass
class Built:
    """The loaded library and what its build reported."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # 0.0 when an existing build was loaded
    ptxas: List[str]        # the -Xptxas -v lines (registers, smem, spills)


_LOADED: Optional[Built] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _build() -> Built:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{SOURCE.stem}-{digest}.so"
    log = out.with_suffix(".log")
    t0 = time.perf_counter()
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "ptxas info" in ln] if log.exists() else []
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Built(lib=lib, path=out, seconds=seconds, ptxas=ptxas)


def load() -> Built:
    """Build (once) and load the kernel library; cached."""
    global _LOADED
    if _LOADED is None:
        _LOADED = _build()
    return _LOADED


def library() -> ctypes.CDLL:
    """The loaded library built from ``csrc/dc_update.cu``."""
    return load().lib

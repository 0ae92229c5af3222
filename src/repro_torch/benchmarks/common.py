"""Shared benchmark output helpers (copies of the repository's
``benchmarks/common.py`` ``emit`` and ``requested_algos``)."""
from __future__ import annotations


def emit(name: str, us_per_call, derived: str = ""):
    print(f"{name},{us_per_call:.1f},{derived}")


def requested_algos(args, default=("ssgd", "stale", "dc_s3gd")):
    """The ``algos`` an argument namespace asks for, else ``default``."""
    algos = getattr(args, "algos", None)
    return tuple(algos) if algos else tuple(default)

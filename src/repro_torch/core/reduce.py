"""Cross-worker reducers (`repro_torch.core.api.Reducer`).

Input trees carry a leading worker axis W on every leaf.
``mean_allreduce`` is the paper's MPI_Iallreduce mean: (1, ...) leaves,
cast to ``comm_dtype`` on the simulated wire, f32 out.  The W workers
live in one process, so the "all-reduce" is a mean over the leading axis.

The mean adds the worker rows one after another in worker order: the
result of every element then depends only on that element's W values,
never on the leaf's shape, which is what makes the bucketed wire bitwise
the per-leaf one within the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.core import registry

Tree = Any

_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis in row order, keepdims."""
    acc = x[:1].clone()
    for i in range(1, x.shape[0]):
        acc += x[i:i + 1]
    return acc


@registry.register(registry.REDUCER, "mean_allreduce")
class MeanAllReduce:
    """Global mean over the worker axis, on a ``comm_dtype`` wire.

    ``reduces_weights = False``: DC-S3GD reduces the carried *deltas*,
    valid because a global mean keeps the post-Eq. 12 base ``w_i − Δw_i``
    identical on every worker."""

    name = "mean_allreduce"
    reduces_weights = False

    def __init__(self, cfg=None, *, comm_dtype: str | None = None):
        self.comm_dtype = comm_dtype if comm_dtype is not None else \
            (cfg.comm_dtype if cfg is not None else "float32")
        if self.comm_dtype not in _WIRE_DTYPES:
            raise NotImplementedError(
                f"comm_dtype={self.comm_dtype!r}: only float32/bfloat16 "
                "wires are ported (quantized wires: ROADMAP A8)")

    def __call__(self, tree: Tree) -> Tree:
        dt = _WIRE_DTYPES[self.comm_dtype]

        def red(d):
            # jnp.mean of a bf16 array sums in f32 and rounds the mean
            # back to bf16; of an f32 array it stays f32
            s = _row_sum(d.to(dt).float()) / d.shape[0]
            return s.to(dt).float()

        return T.map(red, tree)


def collapse_worker_axis(tree: Tree) -> Tree:
    """A reducer's output at canonical (unstacked) shapes: the mean over
    whatever worker dim remains (exact for the keepdims mean)."""
    return T.map(lambda x: _row_sum(x.float())[0] / x.shape[0], tree)


def consensus_mean(tree: Tree) -> Tree:
    """Anchor-form mean over the leading worker axis,
    ``w̄ = w_0 + mean_i(w_i − w_0)``, f32 out: bitwise ``w_0`` when every
    row is identical, for any W (the plain mean of W identical rows is not
    exact unless W is a power of two)."""
    def red(p):
        x = p.float()
        return x[0] + _row_sum(x - x[:1])[0] / x.shape[0]
    return T.map(red, tree)

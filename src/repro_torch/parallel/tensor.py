"""Tensor parallelism over the mesh's 'model' axis: the collectives GSPMD
inserts into the reference's sharded program, written out (the reference
has no module for them).

A `ModelAxis` is the explicit context a tensor-parallel model and
algorithm carry: the process group of the ranks that share this rank's
'data' coordinates, this rank's index on 'model' and the axis size
(`repro_torch.launch.mesh.model_axis` builds it from a mesh).  Its three
autograd functions are Megatron's edges:

* `ModelAxis.copy` (``copy_to_model``): identity forward, all-reduce
  backward.  It marks where a replicated tensor enters computation
  sharded over 'model' (a column-parallel product's input, a replicated
  weight applied to local heads or experts): each rank's backward sees
  only its shard's share of the gradient, and the all-reduce adds the
  shares once;
* `ModelAxis.reduce` (``reduce_from_model``): all-reduce forward,
  identity backward: the sum of a row-parallel product's partials (or of
  any per-shard partial), replicated after it;
* `ModelAxis.gather` (``gather_from_model``): all-gather forward along a
  dim, the rank's slice backward.

Only all-reduce and all-gather are used (gloo, which the CPU and the
card's shared-card ranks run, has no reduce-scatter), and every
collective runs under ``scope("tp")``, so an op trace counts them apart
from the worker-axis wire.  `sum_parts` is the one helper every norm of
a step goes through: the partial sums over model-sharded parts are
all-reduced over the group, the replicated parts counted once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.instrument import scope

# the ROADMAP item every refusal of a tensor-parallel layout names
TP_ITEM = ("ROADMAP queue A item 6.7: what tensor parallelism over "
           "'model' leaves")


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The 'model' axis as one rank sees it: ``group`` (a process group of
    ``size`` ranks), this rank's index ``rank`` on it."""

    group: Any
    rank: int
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``copy_to_model``: identity forward, all-reduce backward."""
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``reduce_from_model``: the sum over the axis (forward),
        identity backward."""
        return _ReduceFromModel.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``gather_from_model``: every rank's ``x`` concatenated along
        ``dim`` in rank order (forward); the rank's slice backward."""
        return _GatherFromModel.apply(x, self, dim)

    def row_matmul(self, x: torch.Tensor, w: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
        """A row-parallel product: this rank's partial ``x @ w`` in f32,
        summed over the axis in f32 and cast once to ``out_dtype``, so a
        bf16 product rounds once, as the one-process matmul does."""
        return self.reduce(x.float() @ w.float()).to(out_dtype)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the axis (no gradient)."""
        import torch.distributed as dist
        out = x.detach().clone()
        with scope("tp"):
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def shard_start(self, n_local: int) -> int:
        """The first index of this rank's block of a dim sharded in
        ``n_local``-long blocks."""
        return self.rank * n_local


def _all_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    with scope("tp"):
        dist.all_reduce(out, group=axis.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        import torch.distributed as dist
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        with scope("tp"):
            dist.all_gather(parts, src, group=axis.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


def sum_parts(parts: Sequence[Tuple[torch.Tensor, ...]],
              sharded: Optional[Sequence[bool]] = None,
              axis: Optional[ModelAxis] = None) -> Tuple[torch.Tensor, ...]:
    """Per-part sums (each part a tuple of (W,) vectors, e.g. one
    bucket's ‖g‖² and ‖g²D‖²) added up over the parts, in part order.

    Without a model axis (or at size 1) that is the whole sum.  Across
    the axis each rank holds a shard of the model-sharded parts
    (``sharded[i]``) and the whole of the replicated ones: the sharded
    parts' sum is all-reduced over the group (one collective for every
    quantity, issued whether or not this rank has such a part, so the
    ranks issue the same collectives) and the replicated parts' sum is
    added once."""
    k = len(parts[0])
    if axis is None or axis.size == 1:
        acc: List[Any] = [0.0] * k
        for p in parts:
            acc = [a + x for a, x in zip(acc, p)]
        return tuple(acc)
    like = parts[0][0]
    sh = [torch.zeros_like(like, dtype=torch.float32) for _ in range(k)]
    rep = [torch.zeros_like(like, dtype=torch.float32) for _ in range(k)]
    for p, s in zip(parts, sharded):
        tgt = sh if s else rep
        for j, x in enumerate(p):
            tgt[j] = tgt[j] + x
    summed = _all_reduce(torch.stack(sh), axis)
    return tuple(summed[j] + rep[j] for j in range(k))

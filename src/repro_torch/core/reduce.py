"""Cross-worker reducers (`repro_torch.core.api.Reducer`).

Input trees carry a leading worker axis W on every leaf.

* ``mean_allreduce`` is the paper's MPI_Iallreduce mean: (1, ...) leaves,
  cast to ``comm_dtype`` on the simulated wire, f32 out.  The W workers
  live in one process, so the "all-reduce" is a mean over the leading
  axis.
* ``gossip`` is ring-neighbourhood averaging (each worker with its
  ``neighbors`` left and right ring neighbours) and ``hierarchical`` an
  exact mean inside each of ``groups`` groups followed by ring gossip
  between the group means; both give (W, ...) leaves and mix the weights
  (``reduces_weights``).  A ring hop is ``torch.roll`` over axis 0, as
  ``jnp.roll`` is in the reference.

A quantized wire (int8/fp8, `repro_torch.core.quant`) carries each row as
values plus one f32 scale (the rolls move both), and the sums run on the
dequantized f32 payload.

The mean adds the worker rows one after another in worker order: the
result of every element then depends only on that element's W values,
never on the leaf's shape, which is what makes the bucketed wire bitwise
the per-leaf one within the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.core import quant as Q
from repro_torch.core import registry

Tree = Any


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis in row order, keepdims."""
    acc = x[:1].clone()
    for i in range(1, x.shape[0]):
        acc += x[i:i + 1]
    return acc


def wire_mean(d: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The mean over the leading (worker) axis on a ``dt`` float wire,
    keepdims, f32 out.  jnp.mean of a bf16/f16 array sums in f32 and
    rounds the mean back to bf16/f16; of an f32 array it stays f32."""
    return (_row_sum(d.to(dt).float()) / d.shape[0]).to(dt).float()


def quantized_mean(d: torch.Tensor, comm_dtype: str) -> torch.Tensor:
    """The mean over the leading axis of what a quantized wire delivers:
    each row quantized with its own scale, dequantized, summed in f32."""
    qv, s = Q.quantize(d, comm_dtype)
    return _row_sum(Q.dequantize(qv, s)) / d.shape[0]


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
        if not Q.is_quantized(self.comm_dtype):
            Q.float_wire(self.comm_dtype)   # raises on an unknown name

    @property
    def hparams(self) -> dict:
        """Constructor knobs a checkpoint must round-trip."""
        return {"comm_dtype": self.comm_dtype}

    def wire_bytes(self, sizes) -> int:
        """Per-worker wire payload per step for leaves/buckets of ``sizes``
        elements; a quantized wire adds one f32 scale per leaf/bucket."""
        sizes = list(sizes)
        it = Q.wire_itemsize(self.comm_dtype)
        if Q.is_quantized(self.comm_dtype):
            return sum(sizes) * it + Q.SCALE_BYTES * len(sizes)
        return sum(sizes) * it

    def __call__(self, tree: Tree) -> Tree:
        if Q.is_quantized(self.comm_dtype):
            return T.map(lambda d: quantized_mean(d, self.comm_dtype), tree)
        dt = Q.float_wire(self.comm_dtype)
        return T.map(lambda d: wire_mean(d, dt), tree)


def _ring_offsets(n: int, k: int):
    """The distinct ring offsets ``{-k..k} mod n``: with 2k + 1 > n the
    ±s rolls alias (n = 2, k = 1: left == right), and summing both would
    count one neighbour twice while dividing by 2k + 1."""
    return sorted({s % n for s in range(-k, k + 1)})


def _ring_mix(x: torch.Tensor, k: int, comm_dtype: str) -> torch.Tensor:
    """Mean of each row with its ring neighbours over axis 0, f32 out.
    Only the neighbour terms cross the wire in ``comm_dtype``; a row's
    own term stays f32."""
    offs = _ring_offsets(x.shape[0], k)
    acc = x.float()
    if Q.is_quantized(comm_dtype):
        qv, sc = Q.quantize(x, comm_dtype)
        for off in offs:
            if off:
                acc = acc + Q.dequantize(torch.roll(qv, off, 0),
                                         torch.roll(sc, off, 0))
    else:
        wire = x.to(Q.float_wire(comm_dtype))
        for off in offs:
            if off:
                acc = acc + torch.roll(wire, off, 0).float()
    return acc / float(len(offs))


def _hop_bytes(sizes, comm_dtype: str) -> int:
    """One ring hop's payload: every element once, plus one f32 scale per
    leaf/bucket on a quantized wire."""
    sizes = list(sizes)
    per_hop = sum(sizes) * Q.wire_itemsize(comm_dtype)
    if Q.is_quantized(comm_dtype):
        per_hop += Q.SCALE_BYTES * len(sizes)
    return per_hop


@registry.register(registry.REDUCER, "gossip")
class GossipReduce:
    """Ring-neighbourhood mean: worker i averages workers {i-k, ..., i+k}
    (mod W, offsets deduplicated).  ``reduces_weights = True``: a
    neighbourhood mean of the deltas alone would let the per-worker bases
    drift apart, so DC-S3GD mixes the carried weights (D-PSGD)."""

    name = "gossip"
    reduces_weights = True

    def __init__(self, cfg=None, *, comm_dtype: str | None = None,
                 neighbors: int | None = None):
        self.comm_dtype = comm_dtype if comm_dtype is not None else \
            (cfg.comm_dtype if cfg is not None else "float32")
        self.neighbors = neighbors if neighbors is not None else \
            (cfg.gossip_neighbors if cfg is not None else 1)
        if not Q.is_quantized(self.comm_dtype):
            Q.float_wire(self.comm_dtype)   # raises on an unknown name

    @property
    def hparams(self) -> dict:
        return {"comm_dtype": self.comm_dtype, "neighbors": self.neighbors}

    def wire_bytes(self, sizes) -> int:
        """2k ring hops (the full-ring upper bound: W is not known here)."""
        return 2 * self.neighbors * _hop_bytes(sizes, self.comm_dtype)

    def __call__(self, tree: Tree) -> Tree:
        return T.map(lambda d: _ring_mix(d, self.neighbors, self.comm_dtype),
                     tree)


@registry.register(registry.REDUCER, "hierarchical")
class HierarchicalReduce:
    """Layered reduction (Layered SGD, Yu et al. 2019): an exact mean inside
    each group of ``W // groups`` consecutive workers (the fast wire), then
    ring gossip between the group means (the slow wire; only they cross it
    in ``comm_dtype``).  ``reduces_weights = True``, as for gossip."""

    name = "hierarchical"
    reduces_weights = True

    def __init__(self, cfg=None, *, comm_dtype: str | None = None,
                 groups: int | None = None, neighbors: int | None = None):
        self.comm_dtype = comm_dtype if comm_dtype is not None else \
            (cfg.comm_dtype if cfg is not None else "float32")
        self.groups = groups if groups is not None else \
            (cfg.hier_groups if cfg is not None else 2)
        self.neighbors = neighbors if neighbors is not None else \
            (cfg.gossip_neighbors if cfg is not None else 1)
        if not Q.is_quantized(self.comm_dtype):
            Q.float_wire(self.comm_dtype)   # raises on an unknown name

    @property
    def hparams(self) -> dict:
        return {"comm_dtype": self.comm_dtype, "groups": self.groups,
                "neighbors": self.neighbors}

    def wire_bytes(self, sizes) -> int:
        """One intra-group hop plus 2k inter-group hops."""
        return (1 + 2 * self.neighbors) * _hop_bytes(sizes, self.comm_dtype)

    def __call__(self, tree: Tree) -> Tree:
        G = self.groups

        def red(d):
            W = d.shape[0]
            if W % G:
                raise ValueError(f"hierarchical: {W} workers do not split "
                                 f"into {G} groups")
            x = d.float().reshape((G, W // G) + d.shape[1:])
            # exact intra-group mean, members added in order (keepdims)
            intra = x[:, :1].clone()
            for j in range(1, W // G):
                intra += x[:, j:j + 1]
            intra = intra / (W // G)
            mixed = _ring_mix(intra, self.neighbors, self.comm_dtype)
            return mixed.expand(x.shape).reshape(d.shape)

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

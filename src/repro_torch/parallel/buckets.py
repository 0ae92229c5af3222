"""Flat-buffer bucketing of parameter trees (the port of
``repro.parallel.buckets``).

A `BucketPlan` is built once per model and packs the leaves into a few
contiguous flat buckets:

* leaves are grouped by ``(dtype, weight-decay class)`` — a bucket is
  dtype-homogeneous (pack/unpack never casts) and decay-homogeneous (the
  fused update applies one wd scalar per bucket);
* inside a group, leaves fill buckets up to ``ceil(total/n_buckets)``
  elements in tree-flatten (sorted-key) order, and each bucket is padded
  to a multiple of ``block`` (default ``BLOCK = 256·128``, the
  reference's alignment, so slot offsets and padding equal its own);
* the zero padding is inert: it adds nothing to the Eq. 17 norms and the
  fused update maps pad zeros to pad zeros;
* under tensor parallelism (``sharded``: per leaf, whether the rank holds
  a shard of it over the mesh's 'model' axis) the plan is built over the
  rank's local shards and the sharded flag joins the group key, so that
  a bucket's norms are known to be partial (summed over the axis) or
  whole (``bucket_sharded``); a reducer whose result depends on the
  bucket it reduces takes the whole tree's plan instead
  (`repro_torch.parallel.tensor.WholeWire`).

``pack``/``unpack`` accept leaves with extra *leading* axes (the worker
axis W): a plan built from per-worker shapes packs a (W, ...) tree into
(W, bucket) buffers.  ``unpack`` returns views into the buckets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T

Tree = Any

BLOCK = 256 * 128   # the reference's (ROWS x LANES) kernel tile


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one tree leaf lives inside the flat buckets."""

    bucket: int
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static packing layout: leaf slots + per-bucket size/dtype/decay.

    ``bucket_sizes`` are padded element counts (multiples of ``block``);
    ``bucket_decay[b]`` is True when the bucket holds rank>1 leaves;
    ``bucket_sharded[b]`` when it holds shards over 'model' (empty for a
    plan built without the flags: nothing is sharded)."""

    treedef: Any
    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Tuple[int, ...]
    bucket_dtypes: Tuple[torch.dtype, ...]
    bucket_decay: Tuple[bool, ...]
    block: int
    bucket_sharded: Tuple[bool, ...] = ()

    @property
    def sharded(self) -> Tuple[bool, ...]:
        """Per bucket, whether it holds shards over 'model'."""
        return self.bucket_sharded or (False,) * self.n_buckets

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    def _lead(self, leaves: Sequence[torch.Tensor]) -> Tuple[int, ...]:
        lead = tuple(leaves[0].shape[: leaves[0].dim()
                                     - len(self.slots[0].shape)])
        for leaf, slot in zip(leaves, self.slots):
            if tuple(leaf.shape) != lead + slot.shape:
                raise ValueError(f"leaf {tuple(leaf.shape)} does not fit "
                                 f"slot {lead} + {slot.shape}")
        return lead

    def pack(self, tree: Tree) -> List[torch.Tensor]:
        """Tree -> list of flat buckets ``lead + (bucket_size,)``; one
        concatenation per bucket, never a cast."""
        leaves = T.leaves(tree)
        if len(leaves) != len(self.slots):
            raise ValueError(f"{len(leaves)} leaves for {len(self.slots)} "
                             "slots")
        lead = self._lead(leaves)
        parts: List[List[torch.Tensor]] = [[] for _ in self.bucket_sizes]
        fill = [0] * self.n_buckets
        for leaf, slot in zip(leaves, self.slots):
            parts[slot.bucket].append(leaf.reshape(lead + (slot.size,)))
            fill[slot.bucket] += slot.size
        out = []
        for b, ps in enumerate(parts):
            pad = self.bucket_sizes[b] - fill[b]
            if pad:
                ps = ps + [ps[0].new_zeros(lead + (pad,))]
            out.append(torch.cat(ps, dim=-1))
        return out

    def unpack(self, buckets: Sequence[torch.Tensor]) -> Tree:
        """List of flat buckets -> tree with the plan's shapes (views into
        the buckets; leading axes kept, padding dropped)."""
        if len(buckets) != self.n_buckets:
            raise ValueError(f"{len(buckets)} buckets for a plan of "
                             f"{self.n_buckets}")
        lead = tuple(buckets[0].shape[:-1])
        leaves = [buckets[s.bucket][..., s.offset:s.offset + s.size]
                  .reshape(lead + s.shape) for s in self.slots]
        return T.unflatten(self.treedef, leaves)

    def zeros(self, dtype, lead: Tuple[int, ...] = (), *,
              device=None) -> List[torch.Tensor]:
        """Zero-initialized buckets (e.g. the carried ``delta_prev``)."""
        return [torch.zeros(lead + (n,), dtype=dtype, device=device)
                for n in self.bucket_sizes]

    def specs(self, worker_spec=None) -> list:
        """Specs for worker-stacked buckets: the worker axes on the
        leading dim, the flat dim replicated (contiguous buffers never
        split mid-leaf)."""
        if worker_spec is None:
            return [(None,) for _ in self.bucket_sizes]
        return [(worker_spec, None) for _ in self.bucket_sizes]


@dataclasses.dataclass(frozen=True)
class BucketSizes:
    """The padded sizes of a list of (..., n) bucket buffers, all of a
    `BucketPlan` that a spec builder reads (``bucket_sizes``): specs of
    a state's own buckets, whichever plan laid them out."""

    bucket_sizes: Tuple[int, ...]

    @classmethod
    def of(cls, buckets: Sequence[torch.Tensor]) -> "BucketSizes":
        return cls(tuple(int(b.shape[-1]) for b in buckets))


def cached_plan(cache: dict, tree: Tree, n_buckets: int, *,
                block: Optional[int] = None,
                strip_leading_axis: bool = False,
                wire_dtype: Optional[str] = None,
                sharded: Optional[Sequence[bool]] = None) -> BucketPlan:
    """Memoized `plan_buckets`, keyed on the tree's (shape, dtype) layout,
    the bucket count, ``block`` and ``wire_dtype`` (the reducer's
    ``comm_dtype``), as the reference keys it: plans of two alignments
    differ in their padded sizes and must never alias, and neither may a
    quantized and a dense wire's, should an alignment ever depend on the
    wire."""
    key = (tuple((tuple(x.shape), x.dtype) for x in T.leaves(tree)),
           n_buckets, block, strip_leading_axis,
           None if wire_dtype is None else str(wire_dtype),
           None if sharded is None else tuple(sharded))
    if key not in cache:
        cache[key] = plan_buckets(tree, n_buckets, block=block,
                                  strip_leading_axis=strip_leading_axis,
                                  sharded=sharded)
    return cache[key]


def plan_buckets(tree: Tree, n_buckets: int, *, block: Optional[int] = None,
                 strip_leading_axis: bool = False,
                 sharded: Optional[Sequence[bool]] = None) -> BucketPlan:
    """Build the static packing layout for ``tree`` (only shapes and
    dtypes are read, so meta tensors work).

    ``n_buckets`` is a target: leaves group by (dtype, decay class) first
    — a group never shares a bucket — then split so no bucket exceeds
    ``ceil(total / n_buckets)`` elements (an oversized leaf gets its own
    bucket).  ``strip_leading_axis`` plans from ``shape[1:]``.
    ``sharded`` (per leaf) adds the 'model'-sharded flag to the group
    key."""
    if n_buckets <= 0:
        raise ValueError("use the per-leaf path for buckets=0")
    block = BLOCK if block is None else block
    leaves, treedef = T.flatten(tree)
    if not leaves:
        raise ValueError("plan_buckets: cannot bucket an empty tree")
    shapes = [tuple(x.shape[1:] if strip_leading_axis else x.shape)
              for x in leaves]
    sizes_of = [math.prod(s) for s in shapes]
    cap = max(-(-sum(sizes_of) // n_buckets), 1)

    # stable grouping: first-seen order of (dtype, decay) keys
    keys = [(x.dtype, len(s) > 1) for x, s in zip(leaves, shapes)]
    if sharded is not None:
        keys = [k + (bool(f),) for k, f in zip(keys, sharded)]
    order = list(dict.fromkeys(keys))

    slots: List[Optional[LeafSlot]] = [None] * len(leaves)
    sizes: List[int] = []
    dtypes: List[torch.dtype] = []
    decay: List[bool] = []
    flags: List[bool] = []
    for key in order:
        cur, fill = -1, 0
        for i, k in enumerate(keys):
            if k != key:
                continue
            if cur < 0 or (fill and fill + sizes_of[i] > cap):
                sizes.append(0)
                dtypes.append(key[0])
                decay.append(key[1])
                flags.append(bool(key[2]) if sharded is not None else False)
                cur, fill = len(sizes) - 1, 0
            slots[i] = LeafSlot(bucket=cur, offset=fill, size=sizes_of[i],
                                shape=shapes[i], dtype=key[0])
            fill += sizes_of[i]
            sizes[cur] = fill
    padded = [-(-n // block) * block for n in sizes]
    return BucketPlan(treedef=treedef, slots=tuple(slots),
                      bucket_sizes=tuple(padded), bucket_dtypes=tuple(dtypes),
                      bucket_decay=tuple(decay), block=block,
                      bucket_sharded=tuple(flags) if sharded is not None
                      else ())

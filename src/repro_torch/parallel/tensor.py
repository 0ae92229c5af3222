"""Tensor parallelism over the mesh's 'model' axis: the collectives GSPMD
inserts into the reference's sharded program, written out (the reference
has no module for them).

A `ModelAxis` is the explicit context a tensor-parallel model and
algorithm carry: the process group of the ranks that share this rank's
'data' coordinates, this rank's index on 'model' and the axis size
(`repro_torch.launch.mesh.model_axis` builds it from a mesh).  Its
autograd edges are Megatron's three and one more:

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
  dim, the rank's slice backward.  The narrow backward is right only
  where every rank consumes the gathered tensor alike (a replicated
  consumer: a column-parallel output joining the replicated residual
  stream, as ``vision_proj``'s does), so each rank's gradient of it is
  already the whole one;
* `ModelAxis.seq_cut` / `ModelAxis.seq_gather`: the sequence-parallel
  pair (the reference's ``_seq_constrain``).  ``seq_cut`` keeps this
  rank's block of S / M positions of a replicated stream (forward) and
  all-gathers the blocks' gradients backward; ``seq_gather`` all-gathers
  the blocks whole (forward) and cuts the rank's rows of the gradient
  backward (`gather` along the sequence dim: the gathered stream's
  consumers are replicated, so each rank's gradient of it is already
  the whole one).  Between them a remat unit's input is the rank's rows
  only;
* `ModelAxis.gather_reduce`: all-gather forward, and backward the
  all-reduce of the gathered tensor's gradient before the rank's slice
  is taken (``copy`` after ``gather``).  It is the edge where the ranks
  consume different slices of the gathered tensor, or the same tensor
  through different shards of a weight: the Mamba block's ``x @ w_in``
  (the reference's contiguous column shards put the x branch on the
  first ranks and z on the last, so every rank gathers both and keeps
  its channels of each) and the RG-LRU gates (the whole post-conv x
  through the local columns of ``w_a`` / ``w_i``).  Each rank's
  gradient of the gathered tensor is then a partial, and only their sum
  is the gradient.

Only all-reduce and all-gather are used (gloo, which the CPU and the
card's shared-card ranks run, has no reduce-scatter), and every
collective runs under ``scope("tp")``, so an op trace counts them apart
from the worker-axis wire.  `sum_parts` is the one helper every norm of
a step goes through: the partial sums over model-sharded parts are
all-reduced over the group, the replicated parts counted once;
`sum_each` is its per-part twin for the per-leaf norms, and
`norm_helpers` binds both to an algorithm's axis and tree.

A reducer whose result depends on the bucket or leaf it reduces (an
error-feedback compressor's threshold, ``k``, index draw and matrix
shape; a quantized wire's row scale) reduces the reference's whole
buckets on every rank of the axis, as GSPMD does with their flat dim
replicated over 'model': a `WholeWire` gathers them from the rank's
wire (`gather_leaves` under ``scope("tp")``, outside the ``wire``
scope, so an op trace prices the gather apart from the worker-axis
wire) and cuts the reducer's result back to the rank's shards
(`shard_leaves`, static slices).  `repro_torch.launch.engine.Engine`
gathers a checkpointed state through `gather_leaves` too.

Serving over the axis keeps a cache that the partition rules shard by
sequence position (the KV cache of a model whose KV heads do not divide
the axis, MLA's latents, a windowed kind's ring over one KV head) as
each rank's block of positions: `write_owned` writes a new token's entry
on the rank that owns its position only, and `gather_positions` gathers
a layer's blocks into the whole row for one attend, which then runs over
the same row as in one process (the gathered copy is freed with the
attend's locals).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.instrument import scope

# what the refusals of a tensor-parallel layout name: the reference's
# own limits
PAGED_ONE_PROCESS = ("the reference serves its paged layouts, chunked "
                     "prefill and its scheduler in one process only "
                     "(repro.launch.serve builds Engine(model) without a "
                     "mesh); over a mesh it serves the dense layout")
UNEVEN_LIMIT = ("the reference's GSPMD refuses the same sharding: a "
                "sharded dim must divide the 'model' axis")


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
        ``dim`` in rank order (forward); the rank's slice of the gradient
        backward.  Right only for a replicated consumer, which leaves
        every rank the whole gradient; where the ranks consume different
        slices (or different weight shards) use `gather_reduce`."""
        return _GatherFromModel.apply(x, self, dim)

    def seq_cut(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of ``dim`` (which the axis divides) of a
        replicated ``x`` (forward); the blocks' gradients all-gathered in
        rank order (backward): each gradient summed exactly once."""
        return _CutToModel.apply(x, self, dim)

    def seq_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The ranks' blocks of ``dim`` gathered whole in rank order
        (forward); the rank's block of the gradient (backward): `gather`
        along the sequence dim, the inverse of `seq_cut`."""
        return self.gather(x, dim)

    def gather_reduce(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """`gather` whose backward first sums the gathered gradient over
        the axis (``copy`` after ``gather``), then takes the rank's
        slice: the edge for ranks that consume different parts of the
        gathered tensor."""
        return self.copy(self.gather(x, dim))

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

    def gather_positions(self, *xs: torch.Tensor, dim: int = 1
                         ) -> Tuple[torch.Tensor, ...]:
        """Each of ``xs`` (one dtype, equal but in the last dim; e.g. a
        layer's k and v cache blocks (B, C / M, KV, hd), or MLA's ckv and
        k_rope (B, C / M, r)) gathered along the sequence dim ``dim`` in
        rank order: one all-gather of the tensors joined on their last
        dim.  Forward only (serving).  Each rank receives (M − 1) / M of
        the whole rows' bytes."""
        import torch.distributed as dist
        widths = [x.shape[-1] for x in xs]
        src = torch.cat(xs, dim=-1).contiguous() if len(xs) > 1 \
            else xs[0].contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        with torch.no_grad(), scope("tp"):
            dist.all_gather(parts, src, group=self.group)
        whole = torch.cat(parts, dim=dim)
        return tuple(whole.split(widths, dim=-1)) if len(xs) > 1 \
            else (whole,)


def write_owned(buf: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
                value: torch.Tensor, axis: Optional[ModelAxis]) -> None:
    """``buf[rows, slot] = value`` in place, for ``buf`` (B, n, ...) a
    cache whose dim 1 is this rank's block of ``n`` positions of a
    sequence sharded over ``axis`` (the whole sequence without one):
    only the rank that owns ``slot`` (B,) writes; the others write back
    what they hold (no host sync on ``slot``)."""
    value = value.to(buf.dtype)
    if axis is None:
        buf[rows, slot] = value
        return
    n = buf.shape[1]
    local = slot - axis.shard_start(n)
    mine = (local >= 0) & (local < n)
    at = local.clamp(0, n - 1)
    mine = mine.reshape(mine.shape + (1,) * (value.dim() - 1))
    buf[rows, at] = torch.where(mine, value, buf[rows, at])


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


def _all_gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    with scope("tp"):
        dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


class _CutToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


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


def sum_each(parts: Sequence[torch.Tensor],
             sharded: Optional[Sequence[bool]] = None,
             axis: Optional[ModelAxis] = None) -> List[torch.Tensor]:
    """Each part's own sum over the axis, not added across parts: the
    per-leaf norms of LARS and of per-tensor λ.  A model-sharded part
    (``sharded[i]``) is a partial sum, all-reduced over the group; the
    sharded parts travel flattened in one collective (the ranks hold the
    same parts, so they issue the same one), and the replicated parts
    come back as they are.  Without an axis (or at size 1) the parts
    are returned unchanged."""
    out = list(parts)
    if axis is None or axis.size == 1 or sharded is None:
        return out
    idx = [i for i, s in zip(range(len(out)), sharded) if s]
    if not idx:
        return out
    flat = _all_reduce(torch.cat([out[i].float().reshape(-1) for i in idx]),
                       axis)
    for i, x in zip(idx, flat.split([out[i].numel() for i in idx])):
        out[i] = x.reshape(out[i].shape)
    return out


def leaf_flags(axis: Optional[ModelAxis], model_cfg,
               tree) -> Optional[Tuple[bool, ...]]:
    """Per leaf of a param-shaped ``tree`` (a leading worker axis
    allowed), whether this rank holds a shard of it over ``axis``: the
    partition rules for ``model_cfg`` shard it over 'model'.  None
    without an axis."""
    if axis is None:
        return None
    from repro_torch.parallel import sharding as shd
    return shd.sharded_over_model(model_cfg, tree, model_size=axis.size)


def norm_helpers(axis: Optional[ModelAxis], model_cfg, tree):
    """A step's two norm helpers over the leaves of ``tree``
    (`leaf_flags`): ``sum_sq(parts)``, `sum_parts` of per-leaf parts (a
    global norm), and ``leaf_sums(parts)``, `sum_each` of them (per-leaf
    norms).  Without an axis they are the ordered fold and the
    identity."""
    flags = leaf_flags(axis, model_cfg, tree)
    return (lambda parts: sum_parts(parts, flags, axis),
            lambda parts: sum_each(parts, flags, axis))


def model_dims(axis: ModelAxis, model_cfg, tree) -> Tuple[Optional[int], ...]:
    """Per leaf of a param-shaped ``tree`` (flatten order; any leading
    dims), the dim of the leaf as it is that the partition rules for
    ``model_cfg`` shard over ``axis``, or None where it is whole."""
    from repro_torch.parallel import sharding as shd
    specs = shd.param_specs(model_cfg, tree, model_size=axis.size)
    return tuple(shd.model_dim(s) for _, s in shd.flat_specs(specs, tree))


def gather_leaves(axis: ModelAxis, leaves: Sequence[torch.Tensor],
                  dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """Each of ``leaves`` whose ``dims`` entry is not None all-gathered
    over ``axis`` along that dim, the ranks' blocks in rank order (one
    collective a leaf, under ``scope("tp")``); the others as they are."""
    import torch.distributed as dist
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        with scope("tp"):
            dist.all_gather(parts, src, group=axis.group)
        out.append(torch.cat(parts, dim=d))
    return out


def shard_leaves(axis: ModelAxis, leaves: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """The inverse of `gather_leaves`: this rank's block of each leaf
    along its ``dims`` entry (a static slice, so bitwise), the others as
    they are."""
    out = []
    for x, d in zip(leaves, dims):
        if d is None:
            out.append(x)
            continue
        n = x.shape[d] // axis.size
        out.append(x.narrow(d, axis.shard_start(n), n))
    return out


@dataclasses.dataclass(frozen=True)
class WholeWire:
    """A reducer's wire over the whole buckets (or leaves) on every rank of
    the 'model' axis: what the reference's GSPMD step reduces.

    `gather` assembles the whole wire from this rank's: the local buckets
    unpacked by the rank's plan ``local``, each sharded leaf all-gathered
    along its dim, the tree packed by the whole tree's plan ``whole`` (a
    per-leaf wire, ``local`` None, stays a tree); the reducer then runs
    on it unchanged and alike on every model rank, and `scatter` cuts
    its result back to the rank's shards and local plan.  ``dims`` /
    ``ndims``: per leaf, the dim of the per-worker leaf sharded over
    'model' (None where it is whole) and the per-worker leaf's rank; the
    wire's leaves may lead with the worker rows.  ``sizes``: the whole
    wire's per-worker element counts (the whole plan's padded bucket
    sizes, or the whole leaves'), what the reducer's accounting reads."""

    axis: ModelAxis
    dims: Tuple[Optional[int], ...]
    ndims: Tuple[int, ...]
    sizes: Tuple[int, ...]
    local: Any = None
    whole: Any = None

    def _at(self, leaves) -> List[Optional[int]]:
        return [None if d is None else d + x.dim() - n
                for x, d, n in zip(leaves, self.dims, self.ndims)]

    def gather(self, wire):
        """This rank's wire (bucket list or tree) -> the whole wire (its
        collectives under ``scope("whole_wire")`` too, so an op trace
        tells them from the model's)."""
        tree = wire if self.local is None else self.local.unpack(wire)
        leaves, treedef = T.flatten(tree)
        with scope("whole_wire"):
            tree = T.unflatten(treedef, gather_leaves(self.axis, leaves,
                                                      self._at(leaves)))
        return tree if self.whole is None else self.whole.pack(tree)

    def scatter(self, out):
        """The reducer's whole result -> this rank's layout."""
        tree = out if self.whole is None else self.whole.unpack(out)
        leaves, treedef = T.flatten(tree)
        tree = T.unflatten(treedef, shard_leaves(self.axis, leaves,
                                                 self._at(leaves)))
        return tree if self.local is None else self.local.pack(tree)


def whole_wire(axis: ModelAxis, model_cfg, params, *, lead: int,
               local=None, plan_of: Optional[Callable] = None
               ) -> WholeWire:
    """The `WholeWire` of a rank's param tree ``params`` (its shards over
    ``axis``; ``lead`` leading worker dims on every leaf): ``local`` is
    the rank's bucket plan of it (None: a per-leaf wire) and
    ``plan_of(tree)`` plans a whole tree alike (here one of meta tensors
    of the whole shapes)."""
    leaves, treedef = T.flatten(params)
    at = model_dims(axis, model_cfg, params)
    meta = []
    for x, d in zip(leaves, at):
        shape = list(x.shape)
        if d is not None:
            shape[d] *= axis.size
        meta.append(torch.empty(shape, dtype=x.dtype, device="meta"))
    whole = None
    if local is not None:
        whole = plan_of(T.unflatten(treedef, meta))
        sizes = tuple(int(n) for n in whole.bucket_sizes)
    else:
        sizes = tuple(math.prod(m.shape[lead:]) for m in meta)
    return WholeWire(axis=axis,
                     dims=tuple(None if d is None else d - lead for d in at),
                     ndims=tuple(x.dim() - lead for x in leaves),
                     sizes=sizes, local=local, whole=whole)

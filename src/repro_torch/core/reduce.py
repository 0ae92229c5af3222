"""Cross-worker reducers (`repro_torch.core.api.Reducer`).

Input trees carry a leading worker axis W on every leaf.

* ``mean_allreduce`` is the paper's MPI_Iallreduce mean: (1, ...) leaves,
  cast to ``comm_dtype`` on the wire, f32 out.  Every reduction over the
  worker axis goes through the `Workers` object the algorithm binds
  (``reducer.workers``): in one process (`LOCAL`) the W workers are the
  leading axis and the "all-reduce" is a sum over it; on a mesh
  (`ProcessWorkers`) each rank holds W / R rows, sums them, and one
  ``all_reduce(SUM)`` over the worker process group adds the ranks'
  sums.  The divisor is always the global W.  ``start`` / ``finish``
  split the mean around the collective, so that a step can issue it and
  compute under it (Algorithm 1's MPI_Iallreduce / wait).
* ``gossip`` is ring-neighbourhood averaging (each worker with its
  ``neighbors`` left and right ring neighbours) and ``hierarchical`` an
  exact mean inside each of ``groups`` groups followed by ring gossip
  between the group means; both give (W, ...) leaves and mix the weights
  (``reduces_weights``).  A ring hop is ``torch.roll`` over axis 0, as
  ``jnp.roll`` is in the reference; on a mesh it is `Workers.roll`, one
  ``batch_isend_irecv`` per ring offset that brings each rank the rows
  it needs from the (at most two) ranks that hold them, as the
  reference's rolls lower to collective-permutes.  No sum crosses rows,
  so both are bitwise the one-process result on any number of ranks.

A quantized wire (int8/fp8, `repro_torch.core.quant`) carries each row as
values plus one f32 scale (the rolls move both), and the sums run on the
dequantized f32 payload.  On a mesh each rank dequantizes its own rows
and the all-reduce carries f32 sums: the reference's compiled program
does the same (GSPMD's all-reduce carries the dequantized values).

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


def _as_bytes(tensors) -> torch.Tensor:
    """Tensors sharing a leading axis as one (rows, bytes) uint8 payload
    (one message a rank pair, whatever the dtypes)."""
    rows = tensors[0].shape[0]
    return torch.cat([t.contiguous().view(torch.uint8).reshape(rows, -1)
                      for t in tensors], dim=1)


def _from_bytes(payload: torch.Tensor, like) -> tuple:
    """`_as_bytes` undone into tensors of ``like``'s dtypes and trailing
    shapes, with ``payload``'s rows."""
    out, at = [], 0
    for t in like:
        width = t[:1].numel() * t.element_size()
        piece = payload[:, at:at + width].contiguous().view(t.dtype)
        out.append(piece.reshape((payload.shape[0],) + t.shape[1:]))
        at += width
    return tuple(out)


class Workers:
    """The worker axis as one process holds it (`LOCAL`): every one of
    the W rows is here, and no collective runs.  `ProcessWorkers` is the
    same seam over the ranks of a process group; an algorithm and its
    reducer hold one of the two and route every reduction over the
    worker axis through it."""

    size = 1            # ranks sharing the worker axis
    rank = 0            # this rank's index among them (pod-major)
    distributed = False
    holds = True        # this rank holds rows (not outside the mesh)
    span = 1            # ranks of the world the worker axis covers

    def rows(self, n_workers: int) -> int:
        """This rank's share of ``n_workers`` rows."""
        return int(n_workers) // self.size

    def count(self, x: torch.Tensor) -> int:
        """The global worker count W of a (W / R, ...) tensor."""
        return x.shape[0] * self.size

    def start_sum(self, x: torch.Tensor):
        """Begin the sum over the leading axis (keepdims): ``(acc,
        handle)``; ``acc`` holds the sum once `wait` has taken the
        handle."""
        return _row_sum(x), None

    def wait(self, handle) -> None:
        del handle

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        acc, h = self.start_sum(x)
        self.wait(h)
        return acc

    def means(self, rows: dict) -> dict:
        """Global means of per-row (W / R,) vectors, by name."""
        return {k: v.mean() for k, v in rows.items()}

    def anchor(self, x: torch.Tensor) -> torch.Tensor:
        """Worker 0's row, (1, ...), on every rank."""
        return x[:1]

    def any_rows(self, mask: torch.Tensor) -> torch.Tensor:
        """The OR over every worker row of a (W / R, n) bool mask: a
        (1, n) uint8 mask, the same on every rank."""
        return mask.any(dim=0, keepdim=True).to(torch.uint8)

    def roll(self, tensors, off: int, n: int, held=None) -> tuple:
        """This rank's rows of ``torch.roll(X, off, 0)`` for each tensor
        ``X`` of ``tensors``, whose global leading axis holds ``n`` items;
        ``held(q)`` gives the range ``[lo, hi)`` of them that rank ``q``
        holds (by default an even block a rank: `ProcessWorkers.roll`).
        Only moves values."""
        del n, held
        return tuple(torch.roll(t, off, 0) for t in tensors)

    def gather_groups(self, x: torch.Tensor, size: int) -> torch.Tensor:
        """The rows of every group of ``size`` consecutive workers that
        this rank's rows touch, in worker order (`group_span`): here
        every row."""
        del size
        return x


LOCAL = Workers()


def group_span(rank: int, rows: int, size: int) -> tuple:
    """``[first, last + 1)``: the groups of ``size`` consecutive workers
    that worker rank ``rank``'s ``rows`` rows touch.  Groups that nest in
    the ranks' blocks (or blocks in groups) give whole groups or one;
    otherwise a group can lie across two or more ranks' rows, and a rank
    can touch a group at either end of its block."""
    lo = rank * rows
    return lo // size, (lo + rows - 1) // size + 1


class ProcessWorkers(Workers):
    """The worker axis over the ranks of ``group`` (a process group of
    ``size`` ranks; this one is ``rank``, its coordinate on the worker
    mesh axes, pod-major): each rank holds W / R consecutive rows.

    A sum over the axis is the local row sum followed by one
    ``all_reduce(SUM)``, issued asynchronously (`start_sum`) so that the
    caller computes under it; `means` reduces a step's metric sums in one
    small all-reduce, so every rank reports the same global numbers and
    nothing waits on the host.  At one rank every result is bitwise the
    one-process one: the same row order, the same division by W.

    ``model`` / ``model_rank``: the mesh's 'model' axis and this rank's
    coordinate on it; the mesh spans ``span = size · model`` ranks, the
    first of the world (`repro_torch.launch.mesh.mesh_for_spec`).  On a
    rank outside the mesh ``holds`` is False: it holds no rows, belongs
    to no group and runs none of the seam's collectives; only
    `hand_over` (a resize onto a mesh that reaches it) involves it."""

    distributed = True

    def __init__(self, group, *, rank: int, size: int, model: int = 1,
                 model_rank: int = 0, holds: bool = True):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.model = int(model)
        self.model_rank = int(model_rank)
        self.holds = bool(holds)

    @property
    def span(self) -> int:
        """The ranks of the world the mesh covers (its first ones)."""
        return self.size * self.model

    def rows(self, n_workers: int) -> int:
        return int(n_workers) // self.size if self.holds else 0

    @property
    def host(self) -> bool:
        """gloo sends, receives and gathers host tensors only: a CUDA
        payload is staged through the host."""
        import torch.distributed as dist
        return dist.get_backend(self.group) == "gloo"

    def _ranks(self) -> list:
        """The global rank of each worker index of the group."""
        import torch.distributed as dist
        return dist.get_process_group_ranks(self.group)

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        # the host copy gloo's point-to-point ops and gathers need; no
        # step reads it on the host
        return x.cpu() if self.host else x  # lint: allow(host-pull-in-traced)

    def start_sum(self, x: torch.Tensor):
        import torch.distributed as dist
        acc = _row_sum(x)
        return acc, dist.all_reduce(acc, group=self.group, async_op=True)

    def wait(self, handle) -> None:
        if handle is not None:
            handle.wait()

    def means(self, rows: dict) -> dict:
        import torch.distributed as dist
        keys = list(rows)
        n = self.count(rows[keys[0]])
        sums = torch.stack([rows[k].float().sum() for k in keys])
        dist.all_reduce(sums, group=self.group)
        return dict(zip(keys, (sums / n).unbind()))

    def anchor(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        a = x[:1].clone()
        dist.broadcast(a, group_src=0, group=self.group)
        return a

    def any_rows(self, mask: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        m = super().any_rows(mask)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m

    def broadcast_from(self, tensors, owner: int) -> None:
        """Broadcast each of ``tensors`` in place from worker rank
        ``owner``."""
        import torch.distributed as dist
        for t in tensors:
            dist.broadcast(t, group_src=owner, group=self.group)

    def _exchange(self, payload: torch.Tensor, held, needs
                  ) -> torch.Tensor:
        """The items ``needs(self.rank)`` (global indices, in order) of a
        leading axis whose items ``[lo, hi) = held(q)`` lie on rank ``q``
        (``payload``: this rank's, as (items, bytes)).  An item comes from
        this rank's own where it holds it, else from one of its holders,
        the ``q mod h``-th of the ``h`` for rank ``q`` (so ranks that
        hold the same block fetch from different ones).  Every rank
        derives every rank's plan, so all post matching sends and
        receives in one ``batch_isend_irecv``, at most one message a rank
        pair."""
        import torch.distributed as dist
        R, me = self.size, self.rank
        spans = [held(q) for q in range(R)]

        def plan(q):
            # (source rank, its local index) of each item rank q needs
            out = []
            for i in needs(q):
                lo, hi = spans[q]
                if lo <= i < hi:
                    out.append((q, i - lo))
                    continue
                hs = [p for p in range(R) if spans[p][0] <= i < spans[p][1]]
                p = hs[q % len(hs)]
                out.append((p, i - spans[p][0]))
            return out

        mine = plan(me)
        ranks = self._ranks()
        ops, recvs = [], []
        for q in range(R):
            if q == me:
                continue
            want = [k for p, k in plan(q) if p == me]
            if want:
                idx = torch.tensor(want, device=payload.device)
                ops.append(dist.P2POp(dist.isend, self._staged(
                    payload.index_select(0, idx)), ranks[q],
                    group=self.group))
            got = [j for j, (p, _) in enumerate(mine) if p == q]
            if got:
                buf = torch.empty((len(got), payload.shape[1]),
                                  dtype=payload.dtype,
                                  device="cpu" if self.host
                                  else payload.device)
                recvs.append((got, buf))
                ops.append(dist.P2POp(dist.irecv, buf, ranks[q],
                                      group=self.group))
        out = payload.new_empty((len(mine), payload.shape[1]))
        local = [(j, k) for j, (p, k) in enumerate(mine) if p == me]
        if local:
            dst = torch.tensor([j for j, _ in local], device=out.device)
            src = torch.tensor([k for _, k in local], device=out.device)
            out.index_copy_(0, dst, payload.index_select(0, src))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for got, buf in recvs:
            out.index_copy_(0, torch.tensor(got, device=out.device),
                            buf.to(out.device))
        return out

    def roll(self, tensors, off: int, n: int, held=None) -> tuple:
        """Rank q holds items ``held(q) = [lo, hi)`` of the ``n`` (by
        default ``[q·n/R, (q+1)·n/R)``; ranges may overlap, as the group
        means of hierarchical groups that cross ranks do).  For the roll
        by ``off`` this rank needs items ``(lo + j − off) mod n``, j <
        hi − lo, from its own or from a holder (`_exchange`), the values
        and (quantized wire) the scales as one byte payload."""
        if self.size == 1:
            return super().roll(tensors, off, n)
        R = self.size
        if held is None:
            def held(q):
                return q * n // R, (q + 1) * n // R

        def needs(q):
            lo, hi = held(q)
            return [(lo + j - off) % n for j in range(hi - lo)]
        out = self._exchange(_as_bytes(tensors), held, needs)
        return _from_bytes(out, tensors)

    def gather_groups(self, x: torch.Tensor, size: int) -> torch.Tensor:
        """The rows of the groups of ``size`` workers that this rank's
        ``c`` rows touch (`group_span`), in worker order: each from the
        one rank that holds it (`_exchange`), in shares of whatever size
        the layout gives, so a sum over a group can add its rows in the
        one-process order.  A rank that holds only whole groups moves
        nothing."""
        c = x.shape[0]
        g0, g1 = group_span(self.rank, c, size)
        if g0 * size == self.rank * c and g1 * size == (self.rank + 1) * c:
            return x

        def needs(q):
            a, b = group_span(q, c, size)
            return range(a * size, b * size)
        out = self._exchange(_as_bytes((x.contiguous(),)),
                             lambda q: (q * c, (q + 1) * c), needs)
        return _from_bytes(out, (x,))[0]


def layout_bound(reducer) -> bool:
    """Whether ``reducer``'s result depends on the bucket or leaf it
    reduces, not on each element's W values alone: an error-feedback
    compressor (its threshold, ``k``, index draw or matrix shape) and a
    quantized wire (each row's scale).  Over a 'model' axis such a wire
    reduces the whole buckets (`repro_torch.parallel.tensor.WholeWire`);
    any other is elementwise and reduces each rank's own."""
    return not getattr(reducer, "stateless", True) or Q.is_quantized(
        getattr(reducer, "comm_dtype", "float32"))


def wire_mean(d: torch.Tensor, dt: torch.dtype,
              workers: Workers = LOCAL) -> torch.Tensor:
    """The mean over the leading (worker) axis on a ``dt`` float wire,
    keepdims, f32 out.  jnp.mean of a bf16/f16 array sums in f32 and
    rounds the mean back to bf16/f16; of an f32 array it stays f32.  On a
    mesh the sum runs over every rank's rows and the divisor is the
    global W."""
    return (workers.sum_rows(d.to(dt).float()) / workers.count(d)) \
        .to(dt).float()


def quantized_mean(d: torch.Tensor, comm_dtype: str,
                   workers: Workers = LOCAL) -> torch.Tensor:
    """The mean over the leading axis of what a quantized wire delivers:
    each row quantized with its own scale, dequantized, summed in f32."""
    qv, s = Q.quantize(d, comm_dtype)
    return workers.sum_rows(Q.dequantize(qv, s)) / workers.count(d)


@registry.register(registry.REDUCER, "mean_allreduce")
class MeanAllReduce:
    """Global mean over the worker axis, on a ``comm_dtype`` wire.

    ``reduces_weights = False``: DC-S3GD reduces the carried *deltas*,
    valid because a global mean keeps the post-Eq. 12 base ``w_i − Δw_i``
    identical on every worker."""

    name = "mean_allreduce"
    reduces_weights = False
    # the worker-axis seam; the algorithm binds a process group's
    workers: Workers = LOCAL

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

    def wire_model(self, sizes, n_workers: int) -> dict:
        """The wire's two accountings, which `repro_torch.analysis.lint`'s
        wire-accounting pass holds against each other and the op trace.

        ``cast_bytes``: the bytes of the down-casts **to** ``comm_dtype``
        one call performs (what the trace sees in the ``wire`` scope): the
        (W, n) payload cast plus the (1, n) mean's cast back to the wire
        dtype (`wire_mean`).  A quantized wire casts the (W, n) payload
        only: the mean runs on the dequantized f32 values.
        ``accounted_bytes``: the per-worker payload, written apart from
        ``wire_bytes`` so that an edit of one without the other shows."""
        sizes = list(sizes)
        it = Q.wire_itemsize(self.comm_dtype)
        n = sum(sizes)
        if Q.is_quantized(self.comm_dtype):
            return {"cast_bytes": n_workers * n * it,
                    "accounted_bytes": n * it + Q.SCALE_BYTES * len(sizes)}
        return {"cast_bytes": (n_workers + 1) * n * it,
                "accounted_bytes": n * it}

    def __call__(self, tree: Tree) -> Tree:
        return self.finish(self.start(tree))

    def start(self, tree: Tree) -> "PendingMean":
        """Put ``tree`` on the wire: cast (or quantize and dequantize)
        each row, begin the sums over the worker axis.  `finish` waits
        and divides; in one process the pair runs `wire_mean` /
        `quantized_mean`'s ops in their order."""
        leaves, treedef = T.flatten(tree)
        if Q.is_quantized(self.comm_dtype):
            def payload(d):
                return Q.dequantize(*Q.quantize(d, self.comm_dtype))
            dt = None
        else:
            dt = Q.float_wire(self.comm_dtype)

            def payload(d):
                return d.to(dt).float()
        parts = [self.workers.start_sum(payload(d)) for d in leaves]
        return PendingMean(self.workers, treedef, parts,
                           [self.workers.count(d) for d in leaves], dt)

    def finish(self, pending: "PendingMean", out=None) -> Tree:
        return pending.wait(out)


class PendingMean:
    """A mean on the wire: the per-leaf sums and their collective
    handles.  ``wait(out)`` returns the reduced tree; with ``out`` (a list
    of f32 buffers of the leaves' (1, ...) shapes) it writes the means
    there, which is how the overlap pipeline's landed buffers are filled
    (`repro_torch.parallel.pipeline.issue_async`)."""

    def __init__(self, workers: Workers, treedef, parts, counts, dt):
        self.workers = workers
        self.treedef = treedef
        self.parts = parts
        self.counts = counts
        self.dt = dt
        self.done = None

    def buffers(self) -> list:
        """Empty f32 buffers of the result leaves' shapes."""
        return [torch.empty_like(acc, dtype=torch.float32)
                for acc, _ in self.parts]

    def wait(self, out=None) -> Tree:
        if self.done is None:
            res = []
            for (acc, h), n in zip(self.parts, self.counts):
                self.workers.wait(h)
                m = acc / n
                res.append(m if self.dt is None else m.to(self.dt).float())
            self.parts = None
            self.done = T.unflatten(self.treedef, res)
        if out is None:
            return self.done
        for o, r in zip(out, T.leaves(self.done)):
            o.copy_(r)
        return T.unflatten(self.treedef, list(out))


def _ring_offsets(n: int, k: int):
    """The distinct ring offsets ``{-k..k} mod n``: with 2k + 1 > n the
    ±s rolls alias (n = 2, k = 1: left == right), and summing both would
    count one neighbour twice while dividing by 2k + 1."""
    return sorted({s % n for s in range(-k, k + 1)})


def _ring_mix(x: torch.Tensor, k: int, comm_dtype: str,
              workers: Workers = LOCAL, n: int | None = None,
              held=None) -> torch.Tensor:
    """Mean of each row with its ring neighbours over axis 0, f32 out.
    Only the neighbour terms cross the wire in ``comm_dtype``; a row's
    own term stays f32.  On a mesh ``x`` is this rank's range of the
    ``n`` ring items (``held``, `Workers.roll`): the same terms, added in
    the same offset order."""
    offs = _ring_offsets(x.shape[0] if n is None else n, k)
    acc = x.float()
    if Q.is_quantized(comm_dtype):
        qv, sc = Q.quantize(x, comm_dtype)
        for off in offs:
            if off:
                acc = acc + Q.dequantize(*workers.roll((qv, sc), off, n,
                                                       held))
    else:
        wire = x.to(Q.float_wire(comm_dtype))
        for off in offs:
            if off:
                acc = acc + workers.roll((wire,), off, n, held)[0].float()
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
    # the worker-axis seam; the algorithm binds a process group's
    workers: Workers = LOCAL

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

    def wire_model(self, sizes, n_workers: int) -> dict:
        """See `MeanAllReduce.wire_model`.  The (W, n) payload is cast once
        (the rolls move the cast wire; the sum stays f32); the accounting
        charges it once per ring hop."""
        n = sum(sizes)
        return {"cast_bytes": n_workers * n * Q.wire_itemsize(self.comm_dtype),
                "accounted_bytes":
                    2 * self.neighbors * _hop_bytes(sizes, self.comm_dtype)}

    def __call__(self, tree: Tree) -> Tree:
        wk = self.workers
        return T.map(lambda d: _ring_mix(d, self.neighbors, self.comm_dtype,
                                         wk, wk.count(d)), tree)


@registry.register(registry.REDUCER, "hierarchical")
class HierarchicalReduce:
    """Layered reduction (Layered SGD, Yu et al. 2019): an exact mean inside
    each group of ``W // groups`` consecutive workers (the fast wire), then
    ring gossip between the group means (the slow wire; only they cross it
    in ``comm_dtype``).  ``reduces_weights = True``, as for gossip."""

    name = "hierarchical"
    reduces_weights = True
    # the worker-axis seam; the algorithm binds a process group's
    workers: Workers = LOCAL

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

    def wire_model(self, sizes, n_workers: int) -> dict:
        """See `MeanAllReduce.wire_model`.  Only the G group means cross
        the slow wire in ``comm_dtype``, so one call casts a (G, 1, n)
        buffer; the accounting charges one intra-group and 2k inter-group
        hops."""
        n = sum(sizes)
        return {"cast_bytes": self.groups * n
                * Q.wire_itemsize(self.comm_dtype),
                "accounted_bytes": (1 + 2 * self.neighbors)
                * _hop_bytes(sizes, self.comm_dtype)}

    def __call__(self, tree: Tree) -> Tree:
        """On a mesh each rank takes the mean of every group its rows
        touch (`group_span`): over its own rows where it holds the whole
        group, else over the group's rows gathered from the ranks that
        hold them (`Workers.gather_groups`, shares of any size: a group
        may lie inside a rank, span a block of ranks or cut through two
        ranks' rows), added in worker order; the ring between the group
        means is gossip's exchange over the ranks' ranges of groups,
        which overlap where a group lies across ranks.  Every term and
        its order are the one-process ones: bitwise on any number of
        ranks and any layout."""
        G, wk = self.groups, self.workers

        def red(d):
            W = wk.count(d)
            if W % G:
                raise ValueError(f"hierarchical: {W} workers do not split "
                                 f"into {G} groups")
            size, c = W // G, d.shape[0]
            g0, g1 = group_span(wk.rank, c, size)
            x = wk.gather_groups(d.float(), size)
            x = x.reshape((g1 - g0, size) + d.shape[1:])
            # exact intra-group mean, members added in order (keepdims)
            intra = x[:, :1].clone()
            for j in range(1, size):
                intra += x[:, j:j + 1]
            intra = intra / size
            mixed = _ring_mix(intra, self.neighbors, self.comm_dtype, wk, G,
                              lambda q: group_span(q, c, size))
            # each of this rank's rows takes its group's mixed mean
            group = torch.div(torch.arange(c, device=d.device) + wk.rank * c,
                              size, rounding_mode="floor") - g0
            return mixed.index_select(0, group).reshape(d.shape)

        return T.map(red, tree)


def collapse_worker_axis(tree: Tree, workers: Workers = LOCAL) -> Tree:
    """A reducer's output at canonical (unstacked) shapes: the mean over
    whatever worker dim remains (exact for the keepdims mean).  A
    weight-mixing reducer's (W / R, ...) rows on a mesh pass their
    ``workers``; a mean-style (1, ...) output is already global."""
    return T.map(lambda x: workers.sum_rows(x.float())[0]
                 / workers.count(x), tree)


def consensus_mean(tree: Tree, workers: Workers = LOCAL) -> Tree:
    """Anchor-form mean over the leading worker axis,
    ``w̄ = w_0 + mean_i(w_i − w_0)``, f32 out: bitwise ``w_0`` when every
    row is identical, for any W (the plain mean of W identical rows is not
    exact unless W is a power of two).  On a mesh ``w_0`` is worker 0's
    row, broadcast from the rank that holds it."""
    def red(p):
        x = p.float()
        a = workers.anchor(x)
        return a[0] + workers.sum_rows(x - a)[0] / workers.count(x)
    return T.map(red, tree)


def check_rows(n_new: int, workers: Workers) -> None:
    """Raise unless ``workers``' ranks split ``n_new`` rows evenly (the
    reference's `validate_worker_count` at a resize)."""
    if int(n_new) % workers.size:
        raise ValueError(
            f"resize to {n_new} workers over {workers.size} worker ranks: "
            f"the rows do not split evenly; lay the membership over the "
            f"ranks that carry it (launch.mesh.mesh_for_spec) and pass that "
            f"mesh's seam (workers=launch.mesh.make_workers(mesh))")


class _TensorMeta:
    """A tensor's shape, dtype and device type: what a rank that holds
    none of it needs to receive it (`hand_over`)."""

    def __init__(self, x: torch.Tensor):
        self.shape = tuple(x.shape)
        self.dtype = x.dtype
        self.device_type = x.device.type

    def device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)


def hand_over(tree: Tree, src: Workers, dst: Workers) -> Tree:
    """``tree`` (what every rank that holds rows under ``src`` holds
    alike: a consensus, a replicated leaf, host counters; None on a rank
    that held none) on every rank that holds rows under ``dst``, and None
    on the others.  Meshes lie over the first ranks of the world
    (`repro_torch.launch.mesh.mesh_for_spec`), so only a ``dst`` that
    reaches further (``dst.span > src.span``) has ranks without it; then
    rank 0 broadcasts the tree's structure and host values over the
    world, and each tensor travels from worker 0 at each 'model'
    coordinate m (global rank m) to the ranks at coordinate m.  Every rank
    of the world calls this, in the same order."""
    if dst.span > src.span:
        import torch.distributed as dist
        if src.model != dst.model:
            raise ValueError(f"a resize keeps the 'model' axis: "
                             f"{src.model} ranks, then {dst.model}")
        me = dist.get_rank()
        host = dist.get_backend() == "gloo"
        held = tree is not None and src.holds
        leaves = T.flatten(tree)[0] if held else None
        skel = [None, None]
        if me == 0:
            leaves_, treedef = T.flatten(tree)
            skel = [treedef, [_TensorMeta(x) if isinstance(x, torch.Tensor)
                              else x for x in leaves_]]
        dist.broadcast_object_list(skel, src=0)
        treedef, metas = skel
        out = []
        for j, meta in enumerate(metas):
            if not isinstance(meta, _TensorMeta):
                out.append(meta)
                continue
            dev = torch.device("cpu") if host else meta.device()
            got = leaves[j] if held else None
            for m in range(dst.model):
                buf = leaves[j].to(dev) if me == m else \
                    torch.empty(meta.shape, dtype=meta.dtype, device=dev)
                dist.broadcast(buf, src=m)
                if got is None and dst.holds and dst.model_rank == m:
                    got = buf.to(meta.device())
            out.append(got)
        tree = T.unflatten(treedef, out) if dst.holds else None
    return tree if dst.holds else None

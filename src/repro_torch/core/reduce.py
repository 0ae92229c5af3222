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

    def roll(self, tensors, off: int, n: int, span: int = 1) -> tuple:
        """This rank's rows of ``torch.roll(X, off, 0)`` for each tensor
        ``X`` of ``tensors``, whose global leading axis holds ``n`` items;
        this rank holds its block of them (``span`` ranks in a row hold
        the same block: `ProcessWorkers.roll`).  Only moves values."""
        del n, span
        return tuple(torch.roll(t, off, 0) for t in tensors)

    def check_blocks(self, groups: int) -> int:
        """How many ranks in a row share one of ``groups`` consecutive
        worker groups (1 when each rank holds whole groups); raises when
        the groups and the ranks do not nest."""
        del groups
        return 1

    def gather_block(self, x: torch.Tensor, span: int) -> torch.Tensor:
        """The rows of the ``span`` ranks in a row that hold this rank's
        block, in worker order (this rank's own rows at ``span`` 1)."""
        del span
        return x


LOCAL = Workers()

# the ROADMAP item a layout the worker axis cannot carry across ranks names
LAYOUT_ITEM = ("ROADMAP queue A item 6.8: a process group per membership "
               "and per worker layout")


class ProcessWorkers(Workers):
    """The worker axis over the ranks of ``group`` (a process group of
    ``size`` ranks; this one is ``rank``, its coordinate on the worker
    mesh axes, pod-major): each rank holds W / R consecutive rows.

    A sum over the axis is the local row sum followed by one
    ``all_reduce(SUM)``, issued asynchronously (`start_sum`) so that the
    caller computes under it; `means` reduces a step's metric sums in one
    small all-reduce, so every rank reports the same global numbers and
    nothing waits on the host.  At one rank every result is bitwise the
    one-process one: the same row order, the same division by W."""

    distributed = True

    def __init__(self, group, *, rank: int, size: int):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        # sub-groups of `span` ranks in a row, built once (`check_blocks`)
        self._blocks: dict = {}

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

    def roll(self, tensors, off: int, n: int, span: int = 1) -> tuple:
        """Worker rank p holds items ``[b·c, (b+1)·c)`` of the ``n``,
        where ``b = p // span`` and ``c = n·span / R``.  For the roll by
        ``off`` this rank needs items ``(b·c + j − off) mod n``, j < c:
        each comes from its own rows or from the holder at this rank's
        position in the holding block.  Every rank derives every rank's
        needs, so all post matching sends and receives, in one
        ``batch_isend_irecv``, at most one message a rank pair, holding
        the values and (quantized wire) the scales as bytes."""
        if self.size == 1:
            return super().roll(tensors, off, n)
        import torch.distributed as dist
        R, me = self.size, self.rank
        c = n * span // R
        if c * R != n * span or c < 1:
            raise ValueError(f"{n} ring items do not lie in blocks over "
                             f"{R} ranks ({LAYOUT_ITEM})")

        def sources(q):
            # (source rank, its local index) of each item rank q needs
            base = (q // span) * c
            out = []
            for j in range(c):
                i = (base + j - off) % n
                out.append(((i // c) * span + q % span, i % c))
            return out

        payload = _as_bytes(tensors)
        mine = sources(me)
        ranks = self._ranks()
        ops, recvs = [], []
        for q in range(R):
            if q == me:
                continue
            want = [k for p, k in sources(q) if p == me]
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
        out = torch.empty_like(payload)
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
        return _from_bytes(out, tensors)

    def check_blocks(self, groups: int) -> int:
        """``groups`` a multiple of R: each rank holds whole groups (span
        1).  R a multiple of ``groups``: a group spans ``R / groups``
        ranks in a row, whose sub-group is built here, once, by every
        rank for every block in the same order (``new_group`` is
        collective over the default group: where the world holds other
        worker groups too, those of the other 'model' coordinates, every
        rank builds every group's blocks, group by group in the order of
        their first ranks).  Otherwise the groups cut through a rank's
        rows: refused."""
        groups = int(groups)
        if groups % self.size == 0:
            return 1
        if self.size % groups:
            raise ValueError(
                f"hierarchical: {groups} groups over {self.size} ranks cut "
                f"through a rank's rows ({LAYOUT_ITEM})")
        span = self.size // groups
        if span not in self._blocks:
            if span == self.size:
                self._blocks[span] = self.group
            else:
                import torch.distributed as dist
                ranks = self._ranks()
                every = [ranks]
                if dist.get_world_size() > self.size:
                    seen = [None] * dist.get_world_size()
                    dist.all_gather_object(seen, ranks)
                    every = sorted({tuple(r) for r in seen})
                for rs in every:
                    for b in range(self.size // span):
                        g = dist.new_group(list(rs[b * span:(b + 1) * span]))
                        if list(rs) == list(ranks) \
                                and b == self.rank // span:
                            self._blocks[span] = g
        return span

    def gather_block(self, x: torch.Tensor, span: int) -> torch.Tensor:
        """An all-gather over the block's sub-group, the members
        concatenated in worker order (so a sum over them can add the rows
        in the one-process order)."""
        if span == 1:
            return x
        import torch.distributed as dist
        self.check_blocks(self.size // span)
        src = self._staged(x.contiguous())
        parts = [torch.empty_like(src) for _ in range(span)]
        dist.all_gather(parts, src, group=self._blocks[span])
        return torch.cat(parts, dim=0).to(x.device)


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
              span: int = 1) -> torch.Tensor:
    """Mean of each row with its ring neighbours over axis 0, f32 out.
    Only the neighbour terms cross the wire in ``comm_dtype``; a row's
    own term stays f32.  On a mesh ``x`` is this rank's block of the
    ``n`` ring items (`Workers.roll`): the same terms, added in the same
    offset order."""
    offs = _ring_offsets(x.shape[0] if n is None else n, k)
    acc = x.float()
    if Q.is_quantized(comm_dtype):
        qv, sc = Q.quantize(x, comm_dtype)
        for off in offs:
            if off:
                acc = acc + Q.dequantize(*workers.roll((qv, sc), off, n,
                                                       span))
    else:
        wire = x.to(Q.float_wire(comm_dtype))
        for off in offs:
            if off:
                acc = acc + workers.roll((wire,), off, n, span)[0].float()
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
    _workers: Workers = LOCAL

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

    @property
    def workers(self) -> Workers:
        """The worker-axis seam.  Binding a process group settles how the
        groups lie over its ranks (`Workers.check_blocks`): whole groups
        on each rank, or each group over a block of ranks whose sub-group
        is built here, at bind time; groups that cut through a rank's
        rows are refused."""
        return self._workers

    @workers.setter
    def workers(self, workers: Workers) -> None:
        workers.check_blocks(self.groups)
        self._workers = workers

    def __call__(self, tree: Tree) -> Tree:
        """On a mesh a group inside a rank takes its mean locally; a
        group over a block of ranks gathers its members from the block's
        sub-group and adds them in worker order; the ring between the
        group means is gossip's exchange.  Either way every term and its
        order are the one-process ones: bitwise on any number of ranks."""
        G, wk = self.groups, self.workers

        def red(d):
            W = wk.count(d)
            if W % G:
                raise ValueError(f"hierarchical: {W} workers do not split "
                                 f"into {G} groups")
            span = wk.check_blocks(G)
            x = wk.gather_block(d.float(), span)
            x = x.reshape((x.shape[0] * G // W, W // G) + d.shape[1:])
            # exact intra-group mean, members added in order (keepdims)
            intra = x[:, :1].clone()
            for j in range(1, W // G):
                intra += x[:, j:j + 1]
            intra = intra / (W // G)
            mixed = _ring_mix(intra, self.neighbors, self.comm_dtype, wk, G,
                              span)
            return mixed.expand((mixed.shape[0], d.shape[0] // mixed.shape[0])
                                + d.shape[1:]).reshape(d.shape)

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

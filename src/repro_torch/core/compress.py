"""Error-feedback compressed reducers (the port of ``repro.core.compress``).

Each worker compresses its wire payload (magnitude top-k, shared-seed
random-k, or a PowerSGD rank-r factorization), and what compression
dropped this step, the **error-feedback residual**, is added back before
compressing the next one, so the compressed trajectory contracts to the
uncompressed one instead of accumulating a bias (EF-SGD, Stich et al.
2018; PowerSGD, Vogels et al. 2019).

All four reducers are mean-style (``reduces_weights = False``): their
output is the same on every worker, which keeps DC-S3GD's Eq. 12 base
``w_i - Δw_i`` common.  They compress per bucket of the flat-buffer wire
(`repro_torch.parallel.buckets`), so the owning algorithm needs
``buckets > 0``; ``init(n_workers, plan)`` raises on a missing plan.

They carry state across steps in ``TrainState.comm["reducer"]``:

* ``residual``: per-worker (W, bucket) f32 buffers of what the last
  compression dropped;
* ``step`` (randk): a host int every worker folds into the shared seed,
  so all workers select the same coordinates;
* ``q`` (powersgd): the warm-started (cols, rank) projection per bucket.

On a mesh (the algorithm binds ``workers``, a `repro_torch.core.reduce.
Workers`) each rank keeps the residual rows of its own W / R workers and
selects on them; the worker mean is the local row sum of the wire-cast
payload, one ``all_reduce(SUM)`` and a division by the global W, and
topk_exact's union is the OR of every worker's mask (an ``all_reduce
(MAX)`` of a (1, n) uint8 mask).

The reference draws randk's support and powersgd's initial Q from
``jax.random``, which torch cannot reproduce: here they come from a
``torch.Generator`` seeded from ``seed`` (and randk's step and the bucket
index).  Parity tests hand the reference's draws in through the
``indices`` / ``q0`` arguments, which the training path never passes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core import registry
from repro_torch.core.reduce import LOCAL, Workers, quantized_mean, \
    wire_mean

Tree = Any

_INDEX_BYTES = 4  # int32 coordinates on the wire (topk only)


def _quantized_roundtrip(c: torch.Tensor, comm_dtype) -> torch.Tensor:
    """What the receivers reconstruct from a quantized wire crossing:
    per-worker-row int8/fp8 values + one f32 scale, dequantized."""
    return Q.dequantize(*Q.quantize(c, comm_dtype))


def _require_buckets(name: str, plan) -> None:
    if plan is None:
        raise ValueError(
            f"reducer {name!r} compresses per bucket and needs the flat-"
            f"buffer wire: construct the algorithm with buckets > 0 "
            f"(registry.make(..., buckets=N) / --buckets N)")


def _as_buckets(wire) -> List[torch.Tensor]:
    if not isinstance(wire, (list, tuple)) or not all(
            isinstance(b, torch.Tensor) and b.dim() == 2 for b in wire):
        raise TypeError(
            "compressed reducers consume the bucketed (W, bucket) wire "
            "(a list of flat buffers), not a parameter tree: run with "
            "buckets > 0")
    return list(wire)


def _k_of(n: int, density: float) -> int:
    return max(1, min(n, int(round(density * n))))


def _matrix_dims(n: int) -> Tuple[int, int]:
    """Square-ish (rows, cols) factorization of a flat bucket, which
    minimizes the (rows + cols) · rank wire payload."""
    c = max(int(math.isqrt(n)), 1)
    while n % c:
        c -= 1
    return n // c, c


def _seed_of(*words: int) -> int:
    """A 64-bit generator seed from a few integers (seed, step, bucket)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


# ---------------------------------------------------------------------------
# per-row magnitude threshold
# ---------------------------------------------------------------------------

# rows up to one BLOCK (32768 elements) take the exact top-k threshold;
# above it the coarse bit threshold
EXACT_TOPK_MAX = 32768


def magnitude_threshold(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row threshold t with ``|{x : mag >= t}| >= k`` and magnitude
    dominance (every kept magnitude >= t > every dropped one).

    ``mag`` is (..., n) non-negative f32.  For ``n <= EXACT_TOPK_MAX``
    this is the exact k-th largest value.  Larger rows take the coarse
    bit threshold ``t = f32(hi_k << 16)``, where ``hi_k`` is the k-th
    largest ``hi = bits(mag) >> 16`` of the row: non-negative f32s order
    like their int32 bit patterns, so at least k elements are kept and
    only low-mantissa ties of the k-th value overshoot.

    The reference finds ``hi_k`` by a bit-by-bit counting search on a
    1/16 subsample, refined in a window and checked, with a full-row
    search under ``lax.cond`` when the check fails; its result is always
    the true ``hi_k``.  Here a top-k of the int16 high halves gives
    ``hi_k`` directly: the same bits, with no branch on a device value
    and so no host read."""
    n = mag.shape[-1]
    if k >= n:
        return torch.zeros(mag.shape[:-1] + (1,), dtype=mag.dtype,
                           device=mag.device)
    if n <= EXACT_TOPK_MAX:
        return torch.topk(mag, k, dim=-1).values[..., -1:]
    hi = (mag.contiguous().view(torch.int32) >> 16).to(torch.int16)
    hi_k = torch.topk(hi, k, dim=-1, sorted=False).values \
        .amin(dim=-1, keepdim=True)
    return (hi_k.to(torch.int32) << 16).view(torch.float32)


# ---------------------------------------------------------------------------
# the reducers
# ---------------------------------------------------------------------------


class _ErrorFeedbackMean:
    """Shared skeleton: accumulate residual -> compress -> mean -> carry
    what was dropped.  Subclasses implement ``_compress(b, a, rstate)``
    (the per-bucket dense-shaped compression) and ``wire_bytes``."""

    reduces_weights = False
    stateless = False
    # the owning algorithm flips this under use_kernels; topk / topk_exact
    # then run each bucket's select + wire cast + mean + residual as one
    # kernel launch (repro_torch.kernels.compress)
    use_kernels = False
    # the worker-axis seam; the algorithm binds a process group's
    workers: Workers = LOCAL

    def __init__(self, cfg=None, *, comm_dtype: str | None = None):
        self.comm_dtype = comm_dtype if comm_dtype is not None else \
            (cfg.comm_dtype if cfg is not None else "float32")
        if not Q.is_quantized(self.comm_dtype):
            Q.float_wire(self.comm_dtype)   # raises on an unknown name

    # -- carried state ------------------------------------------------------

    def init(self, n_workers: int, plan, *, device=None) -> Tree:
        """Zero residuals for this rank's rows of the ``n_workers``."""
        _require_buckets(self.name, plan)
        rows = self.workers.rows(n_workers)
        return {"residual": [torch.zeros((rows, n), dtype=torch.float32,
                                         device=device)
                             for n in plan.bucket_sizes]}

    def state_specs(self, axes, plan) -> Tree:
        """Specs matching `init`: worker axes lead the residuals."""
        _require_buckets(self.name, plan)
        return {"residual": [(axes.worker_spec, None)
                             for _ in plan.bucket_sizes]}

    # -- the reduction ------------------------------------------------------

    def __call__(self, wire, rstate: Tree) -> Tuple[List[torch.Tensor], Tree]:
        return self._reduce(wire, rstate,
                            lambda b, a: self._compress(b, a, rstate))

    def _reduce(self, wire, rstate: Tree,
                compress: Callable[[int, torch.Tensor], torch.Tensor]
                ) -> Tuple[List[torch.Tensor], Tree]:
        buckets = _as_buckets(wire)
        quantized = Q.is_quantized(self.comm_dtype)
        # the fused kernel implements the plain-cast wire only; a quantized
        # comm dtype takes the torch path below (the reference's routing)
        dt = None if quantized else Q.float_wire(self.comm_dtype)
        out, new_res = [], []
        for b, d in enumerate(buckets):
            # error feedback: what compression dropped last step re-enters
            # the payload before this step's selection
            a = d.float() + rstate["residual"][b]
            fused = self._fused_bucket(b, a, dt) \
                if (self.use_kernels and not quantized) else None
            if fused is not None:
                o, r = fused
            else:
                c = compress(b, a)
                wk = self.workers
                if quantized:
                    # the sparse payload crosses the wire quantized; the
                    # residual absorbs selection AND quantization error
                    cq = _quantized_roundtrip(c, self.comm_dtype)
                    o, r = wk.sum_rows(cq) / wk.count(cq), a - cq
                else:
                    o, r = wire_mean(c, dt, wk), a - c
            out.append(o)
            new_res.append(r)
        new_state = dict(rstate)
        new_state["residual"] = new_res
        return out, self._advance(new_state)

    def _fused_bucket(self, b: int, a: torch.Tensor, dt):
        """The fused kernel body for one accumulated bucket ``a``:
        ``(mean, new_residual)``, or None where there is none."""
        return None

    def revoke(self, wire, prev_rstate: Tree, rstate: Tree) -> Tree:
        """Carried state for a step whose reduction output was NOT applied
        (a revoked staleness window): the whole accumulated payload
        returns to the residual; counters and warm starts keep the
        advanced values from ``rstate``."""
        out = dict(rstate)
        out["residual"] = [d.float() + e for d, e in
                           zip(_as_buckets(wire), prev_rstate["residual"])]
        return out

    def _advance(self, rstate: Tree) -> Tree:
        return rstate

    def resize(self, rstate: Tree, n_new: int) -> Tree:
        """Elastic resize of the carried EF state: the summed residual is
        spread equally over the ``n_new`` workers, so the mass per bucket
        is conserved (up to one f32 rounding).  Counters and warm starts
        are worker-count independent and carry over.  On a mesh the sum
        runs over every rank's rows.  Each residual comes back as one row,
        a worker's share: the algorithm's ``resize_state`` expands it to
        the rows each rank of the (possibly new) mesh holds."""
        n_new = int(n_new)
        wk = self.workers
        out = dict(rstate)
        out["residual"] = [wk.sum_rows(r) / n_new
                           for r in rstate["residual"]]
        return out

    def _compress(self, b: int, a: torch.Tensor, rstate: Tree
                  ) -> torch.Tensor:
        raise NotImplementedError

    # -- the wire's accounting (repro_torch.analysis.lint) ------------------

    def wire_model(self, sizes: Sequence[int], n_workers: int) -> dict:
        """The cast census against the hand accounting (see
        `repro_torch.core.reduce.MeanAllReduce.wire_model`).

        The simulated wire is dense-shaped: `wire_mean` casts the whole
        (W, n) sparsified bucket and the (1, n) mean, though only about k
        coordinates are non-zero, so ``cast_bytes`` counts the dense
        casts, while ``accounted_bytes`` is the sparse payload (values and
        indices) that ``wire_bytes`` reports.  A quantized wire casts the
        (W, n) payload only."""
        it = Q.wire_itemsize(self.comm_dtype)
        mult = n_workers if Q.is_quantized(self.comm_dtype) \
            else n_workers + 1
        return {"cast_bytes": mult * sum(sizes) * it,
                "accounted_bytes": self._accounted_bytes(sizes, n_workers)}

    def _accounted_bytes(self, sizes: Sequence[int],
                         n_workers: int) -> int:
        raise NotImplementedError


@registry.register(registry.REDUCER, "topk")
class TopKReduce(_ErrorFeedbackMean):
    """Magnitude top-k sparsified mean: each worker keeps the ``density``
    fraction of largest-|.| coordinates of each bucket (threshold from
    `magnitude_threshold`, ``>=`` so ties never drop below k) and the mean
    is taken over the sparse payloads.

    Wire: k values in ``comm_dtype`` + k int32 coordinates per bucket,
    since every worker selects its own support.

    Under ``use_kernels`` each bucket's select + wire cast + mean +
    residual update is one launch of `repro_torch.kernels.compress.
    select_ef_mean` (any bucket size, any plain-cast wire); the threshold
    stays in torch.  On a mesh the launch writes the partial row sum, and
    the mean is finished after the all-reduce (topk_exact's union mask
    comes in from the all-reduce of every rank's OR)."""

    name = "topk"
    _union = False  # per-worker supports; topk_exact means on the union

    def __init__(self, cfg=None, *, comm_dtype: str | None = None,
                 density: float | None = None):
        super().__init__(cfg, comm_dtype=comm_dtype)
        self.density = float(density) if density is not None else \
            (cfg.compress_density if cfg is not None else 0.01)

    @property
    def hparams(self) -> dict:
        return {"comm_dtype": self.comm_dtype, "density": self.density}

    def wire_bytes(self, sizes: Sequence[int]) -> int:
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        return sum(_k_of(n, self.density) * (it + _INDEX_BYTES) + sb
                   for n in sizes)

    def _accounted_bytes(self, sizes: Sequence[int],
                         n_workers: int) -> int:
        # k values in comm_dtype + k int32 coordinates per bucket (+ one
        # f32 scale per bucket row on a quantized wire)
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        return sum(_k_of(n, self.density) * (it + _INDEX_BYTES) + sb
                   for n in sizes)

    def _compress(self, b: int, a: torch.Tensor, rstate: Tree
                  ) -> torch.Tensor:
        k = _k_of(a.shape[-1], self.density)
        mag = a.abs()
        thresh = magnitude_threshold(mag, k)
        return torch.where(mag >= thresh, a, 0.0)

    def _fused_bucket(self, b: int, a: torch.Tensor, dt):
        from repro_torch.kernels import compress as kc
        k = _k_of(a.shape[-1], self.density)
        thresh = magnitude_threshold(a.abs(), k)
        wk = self.workers
        if not wk.distributed:
            return kc.select_ef_mean(a, thresh, comm_dtype=dt,
                                     union=self._union)
        mask = wk.any_rows(a.abs() >= thresh.reshape(-1, 1)) \
            if self._union else None
        part, res = kc.select_ef_mean(a, thresh, comm_dtype=dt,
                                      union=self._union, mask=mask,
                                      partial=True)
        return kc.finish_mean(wk.sum_rows(part), wk.count(a), dt), res


@registry.register(registry.REDUCER, "topk_exact")
class TopKExactReduce(TopKReduce):
    """All-gather top-k: every worker contributes its true value on the
    **union** of the per-worker supports, so the reduction is the exact
    dense mean restricted to the union.

    Wire per worker: k int32 coordinates (the support all-gather) + up
    to ``min(W·k, n)`` values in ``comm_dtype`` (the union payload)."""

    name = "topk_exact"
    _union = True

    def init(self, n_workers: int, plan, *, device=None) -> Tree:
        self._n_workers = int(n_workers)
        return super().init(n_workers, plan, device=device)

    def resize(self, rstate: Tree, n_new: int) -> Tree:
        # the union payload (and so wire_bytes) scales with W
        self._n_workers = int(n_new)
        return super().resize(rstate, n_new)

    def wire_bytes(self, sizes: Sequence[int]) -> int:
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        w = getattr(self, "_n_workers", None)
        if w is None:
            raise RuntimeError(
                "topk_exact.wire_bytes needs the worker count: call "
                "init(n_workers, plan) first")
        total = 0
        for n in sizes:
            k = _k_of(n, self.density)
            total += k * _INDEX_BYTES + min(w * k, n) * it + sb
        return total

    def _accounted_bytes(self, sizes: Sequence[int],
                         n_workers: int) -> int:
        # k coordinates for the support all-gather + up to min(W·k, n)
        # union values per bucket, at the live worker count
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        total = 0
        for n in sizes:
            k = _k_of(n, self.density)
            total += k * _INDEX_BYTES + min(n_workers * k, n) * it + sb
        return total

    def _compress(self, b: int, a: torch.Tensor, rstate: Tree
                  ) -> torch.Tensor:
        k = _k_of(a.shape[-1], self.density)
        mag = a.abs()
        thresh = magnitude_threshold(mag, k)
        union = self.workers.any_rows(mag >= thresh).bool()
        return torch.where(union, a, 0.0)


@registry.register(registry.REDUCER, "randk")
class RandKReduce(_ErrorFeedbackMean):
    """Shared-seed random-k sparsified mean: every worker selects the SAME
    k coordinates per bucket, drawn from a generator seeded from
    ``seed``, the carried step and the bucket index, so the mean is exact
    on the chosen support and the wire carries values only."""

    name = "randk"

    def __init__(self, cfg=None, *, comm_dtype: str | None = None,
                 density: float | None = None, seed: int = 0):
        super().__init__(cfg, comm_dtype=comm_dtype)
        self.density = float(density) if density is not None else \
            (cfg.compress_density if cfg is not None else 0.01)
        self.seed = int(seed)

    @property
    def hparams(self) -> dict:
        return {"comm_dtype": self.comm_dtype, "density": self.density,
                "seed": self.seed}

    def wire_bytes(self, sizes: Sequence[int]) -> int:
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        return sum(_k_of(n, self.density) * it + sb for n in sizes)

    def _accounted_bytes(self, sizes: Sequence[int],
                         n_workers: int) -> int:
        # a shared-seed support: k values per bucket, no index payload
        it = Q.wire_itemsize(self.comm_dtype)
        sb = Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        return sum(_k_of(n, self.density) * it + sb for n in sizes)

    def init(self, n_workers: int, plan, *, device=None) -> Tree:
        state = super().init(n_workers, plan, device=device)
        state["step"] = 0
        return state

    def state_specs(self, axes, plan) -> Tree:
        specs = super().state_specs(axes, plan)
        specs["step"] = ()
        return specs

    def _advance(self, rstate: Tree) -> Tree:
        rstate["step"] = rstate["step"] + 1
        return rstate

    def support(self, b: int, n: int, step: int, device) -> torch.Tensor:
        """The k shared coordinates of bucket ``b`` at ``step``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed_of(self.seed, step, b))
        return torch.randperm(n, generator=gen, device=device)[
            :_k_of(n, self.density)]

    def __call__(self, wire, rstate: Tree, *, indices=None
                 ) -> Tuple[List[torch.Tensor], Tree]:
        """``indices``: per-bucket coordinates that replace this step's
        draw (a test hook for the reference's draws)."""
        def compress(b, a):
            n = a.shape[-1]
            idx = self.support(b, n, rstate["step"], a.device) \
                if indices is None else indices[b]
            mask = torch.zeros(n, dtype=torch.bool, device=a.device)
            mask[idx] = True
            return torch.where(mask, a, 0.0)
        return self._reduce(wire, rstate, compress)


@registry.register(registry.REDUCER, "powersgd")
class PowerSGDReduce(_ErrorFeedbackMean):
    """Rank-r low-rank mean (PowerSGD): each bucket reshapes to a
    square-ish (rows, cols) matrix M_i, and one warm-started power
    iteration factors the mean as P·Qᵀ:

        P_i = M_i Q     -> mean over workers -> orthonormalize
        Q_i = M_iᵀ P̂    -> mean over workers
        out = P̂ Qᵀ      (the same on every worker)

    Only the two skinny factors cross the wire: (rows + cols) · r values
    per bucket.  Q is carried across steps (warm start); the rank-r
    remainder rides the error-feedback residual."""

    name = "powersgd"

    def __init__(self, cfg=None, *, comm_dtype: str | None = None,
                 rank: int | None = None, seed: int = 0):
        super().__init__(cfg, comm_dtype=comm_dtype)
        self.rank = int(rank) if rank is not None else \
            (cfg.compress_rank if cfg is not None else 4)
        self.seed = int(seed)

    @property
    def hparams(self) -> dict:
        return {"comm_dtype": self.comm_dtype, "rank": self.rank,
                "seed": self.seed}

    def _dims(self, n: int) -> Tuple[int, int, int]:
        rows, cols = _matrix_dims(n)
        return rows, cols, max(1, min(self.rank, rows, cols))

    def wire_bytes(self, sizes: Sequence[int]) -> int:
        it = Q.wire_itemsize(self.comm_dtype)
        # a quantized wire carries one f32 scale per factor payload (two
        # crossings per bucket: the P and Q rounds)
        sb = 2 * Q.SCALE_BYTES if Q.is_quantized(self.comm_dtype) else 0
        total = 0
        for n in sizes:
            rows, cols, r = self._dims(n)
            total += (rows + cols) * r * it + sb
        return total

    def _accounted_bytes(self, sizes: Sequence[int],
                         n_workers: int) -> int:
        return self.wire_bytes(sizes)

    def wire_model(self, sizes: Sequence[int], n_workers: int) -> dict:
        """See `_ErrorFeedbackMean.wire_model`.  Here the wire is the two
        skinny factors: both rounds go through `wire_mean`, so a bucket
        casts the (W, rows, r) and (W, cols, r) payloads and the two
        (1, ., r) means, (W + 1)·(rows + cols)·r elements; a quantized
        wire only the two (W, ., r) payloads."""
        it = Q.wire_itemsize(self.comm_dtype)
        mult = n_workers if Q.is_quantized(self.comm_dtype) \
            else n_workers + 1
        factor = 0
        for n in sizes:
            rows, cols, r = self._dims(int(n))
            factor += (rows + cols) * r
        return {"cast_bytes": mult * factor * it,
                "accounted_bytes": self._accounted_bytes(sizes, n_workers)}

    def init(self, n_workers: int, plan, *, device=None, q0=None) -> Tree:
        """``q0``: per-bucket (cols, r) draws that replace the generator's
        (a test hook for the reference's draws); orthonormalized here."""
        state = super().init(n_workers, plan, device=device)
        qs = []
        for b, n in enumerate(plan.bucket_sizes):
            _, cols, r = self._dims(int(n))
            if q0 is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(_seed_of(self.seed, b))
                q = torch.randn((cols, r), generator=gen, device=device)
            else:
                q = q0[b].to(device=device, dtype=torch.float32)
            qs.append(torch.linalg.qr(q).Q)
        state["q"] = qs
        return state

    def state_specs(self, axes, plan) -> Tree:
        specs = super().state_specs(axes, plan)
        # the skinny factors are identical on every worker: replicated
        specs["q"] = [(None, None) for _ in plan.bucket_sizes]
        return specs

    def __call__(self, wire, rstate: Tree) -> Tuple[List[torch.Tensor], Tree]:
        buckets = _as_buckets(wire)
        quantized = Q.is_quantized(self.comm_dtype)
        dt = None if quantized else Q.float_wire(self.comm_dtype)

        wk = self.workers

        def factor_mean(f):
            # one wire crossing of a (W, ., r) factor payload: on a mesh an
            # all-reduce, whose result (and so the QR after it and the
            # warm start q) is the same bits on every rank
            if quantized:
                return quantized_mean(f, self.comm_dtype, wk)[0]
            return wire_mean(f, dt, wk)[0]

        out, new_res, new_q = [], [], []
        for b, d in enumerate(buckets):
            a = d.float() + rstate["residual"][b]
            n = a.shape[-1]
            rows, cols, r = self._dims(n)
            m = a.reshape(a.shape[0], rows, cols)
            # round 1: project onto the warm-started subspace, mean the
            # (rows, r) factors over workers (first wire crossing)
            p = torch.linalg.qr(factor_mean(m @ rstate["q"][b])).Q
            # round 2: mean the (cols, r) co-factors (second crossing)
            q = factor_mean(m.transpose(1, 2) @ p)
            approx = (p @ q.T).reshape(1, n)
            out.append(approx)
            new_res.append(a - approx)
            new_q.append(q)
        new_state = dict(rstate)
        new_state["residual"] = new_res
        new_state["q"] = new_q
        return out, new_state


class DenseWindowReduce:
    """A stateful error-feedback reducer made dense for a while: the joiner
    catch-up window of ``Membership(dense_after_join=N)``.

    A worker that joins an elastic run inherits a share of the residual
    from the mass-conserving resize: payload that compression has not yet
    delivered.  Draining it through the compressor takes many steps at
    low density; inside the window this wrapper delivers it at once,

        a = wire + residual  ->  the exact dense mean of a  ->  residual = 0,

    so after one dense step the residual is exactly zero.  On a quantized
    wire the whole payload crosses quantized and the residual keeps the
    quantization error.  The carried state keeps the inner reducer's
    structure (residuals zeroed, counters and warm starts untouched), so
    swapping the wrapper in and out needs no state surgery.  Everything
    else (``name``, ``hparams``, ``wire_bytes``, ``resize``, ``revoke``)
    is the inner reducer's: a checkpoint written inside the window records
    the inner reducer and resumes compressed.  It never runs a kernel."""

    stateless = False
    reduces_weights = False

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def workers(self) -> Workers:
        return self.inner.workers

    @workers.setter
    def workers(self, workers: Workers) -> None:
        self.inner.workers = workers

    def wire_model(self, sizes: Sequence[int], n_workers: int) -> dict:
        """Not delegated: inside the window the wire is dense (the whole
        (W, bucket) buffers go through `wire_mean`), so both accountings
        count the dense payload.  ``wire_bytes`` stays the inner
        reducer's: a bench column reports the steady compressed wire."""
        sizes = [int(s) for s in sizes]
        it = Q.wire_itemsize(self.inner.comm_dtype)
        n = sum(sizes)
        if Q.is_quantized(self.inner.comm_dtype):
            return {"cast_bytes": n_workers * n * it,
                    "accounted_bytes": n * it + Q.SCALE_BYTES * len(sizes)}
        return {"cast_bytes": (n_workers + 1) * n * it,
                "accounted_bytes": n * it}

    def __call__(self, wire, rstate: Tree) -> Tuple[List[torch.Tensor], Tree]:
        buckets = _as_buckets(wire)
        quantized = Q.is_quantized(self.inner.comm_dtype)
        dt = None if quantized else Q.float_wire(self.inner.comm_dtype)
        out, new_res = [], []
        wk = self.workers
        for b, d in enumerate(buckets):
            a = d.float() + rstate["residual"][b]
            if quantized:
                cq = _quantized_roundtrip(a, self.inner.comm_dtype)
                out.append(wk.sum_rows(cq) / wk.count(cq))
                new_res.append(a - cq)
            else:
                out.append(wire_mean(a, dt, wk))
                new_res.append(torch.zeros_like(a))
        new_state = dict(rstate)
        new_state["residual"] = new_res
        return out, new_state

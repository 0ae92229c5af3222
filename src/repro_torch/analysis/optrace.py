"""Op traces of eager PyTorch calls: the port's counterpart of
``repro.analysis.hlo``.

The reference reads its roofline and its lint facts off the lowered
program's HLO text.  The port runs eagerly, so there is no program to
lower: instead `trace` runs one call under a ``TorchDispatchMode`` and
records every aten op the call dispatches, with

* its input and output shapes, dtypes and devices;
* its FLOPs: ``dot_flops`` from ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions, attention), ``elem_flops`` one per output
  element of a pointwise op;
* the bytes it reads and writes (each input once, each output once; a
  view moves nothing, a broadcast dimension is read once);
* ``math``, the arithmetic it runs in, which the roofline prices: a dot
  at its dtype's tensor-core rate (``"tf32"`` for an f32 dot while
  ``torch.backends.cuda.matmul.allow_tf32`` is set, else ``"float32"``,
  the CUDA cores), everything else at the f32 CUDA-core rate (PyTorch's
  bf16 elementwise kernels compute in f32);
* the scope stack: the names of the `scope` blocks it ran inside;
* for a collective (a ``c10d`` op: ``torch.distributed``'s calls reach
  the dispatcher, under fake tensors too) no HBM bytes but its payload,
  ``coll_bytes``: the bytes of the tensors it reduces or contributes.

**Kernels.**  The hand-written kernels are launched through raw pointers
and never reach the dispatcher, so each wrapper carries
`repro_torch.instrument.traced_kernel`: inside an active trace the call
becomes ONE node (``kernel.<name>``) with the FLOPs, bytes and wire casts
its cost function derives from its inputs, the function ``chip_smoke.py``
bounds the kernel with.  The aten ops inside the wrapper (its plain
version on the CPU, its output allocations on the card) are not
recorded, so nothing is counted twice.

**Scopes.**  ``with repro_torch.instrument.scope("wire"):`` marks the
reducers' simulated wire, as the reference's ``jax.named_scope("wire")``
does; the algorithms mark their forward and backward pass ``"model"``,
and the tensor-parallel collectives run in ``"tp"``
(`repro_torch.parallel.tensor`).

`count_ops` replaces the reference's StableHLO op counts.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import instrument
from repro_torch.instrument import tensors as _tensors

# ops that allocate, alias or query metadata without moving bytes
# (``prim.device``: a fake tensor's device query, dispatched only under
# FakeTensorMode, where it would otherwise charge a read of its input)
_FREE = {"empty", "empty_like", "empty_strided", "detach", "alias",
         "_unsafe_view", "lift_fresh", "set_", "resize_", "_reshape_alias",
         "new_empty", "new_empty_strided", "_local_scalar_dense", "device"}
# ops whose output shape depends on the data: on the card they wait for
# the device (host-sync pass)
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique",
            "_unique2", "unique_dim", "unique_consecutive")


@dataclasses.dataclass(frozen=True)
class Cast:
    """One dtype conversion: ``elements`` values from ``src`` to ``dst``
    (torch dtype names, e.g. ``"float32"`` -> ``"bfloat16"``)."""

    src: str
    dst: str
    elements: int


@dataclasses.dataclass
class Op:
    """One recorded op (see the module docstring)."""

    name: str                       # "aten.mm.default" / "kernel.dc_norms"
    inputs: Tuple[tuple, ...]       # (shape, dtype, device) per tensor
    outputs: Tuple[tuple, ...]
    dot_flops: int
    elem_flops: int
    bytes_read: int
    bytes_written: int
    math: str
    scope: Tuple[str, ...]
    casts: Tuple[Cast, ...] = ()
    reads: Tuple[str, ...] = ()     # labels of watched tensors it read
    coll_bytes: int = 0             # a collective's payload

    @property
    def kind(self) -> str:
        return "kernel" if self.name.startswith("kernel.") else "aten"

    @property
    def flops(self) -> int:
        return self.dot_flops + self.elem_flops

    @property
    def bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    def in_scope(self, name: str) -> bool:
        return name in self.scope


class OpTrace:
    """The ops one traced call dispatched, in order, with the scope
    regions it entered (``regions``: (name, index of the first op inside)
    per ``scope`` entry) and free-form ``meta`` its producer attaches
    (`repro_torch.launch.engine.Engine.trace_train_step` puts the wire's
    layout there)."""

    def __init__(self, watch: Optional[Dict[int, str]] = None):
        self.ops: List[Op] = []
        self.regions: List[Tuple[str, int]] = []
        self.meta: Dict[str, Any] = {}
        self._watch = dict(watch or {})
        self.suspended = 0

    # -- totals --------------------------------------------------------------

    @property
    def dot_flops(self) -> int:
        return sum(o.dot_flops for o in self.ops)

    @property
    def elem_flops(self) -> int:
        return sum(o.elem_flops for o in self.ops)

    @property
    def flops(self) -> int:
        return sum(o.flops for o in self.ops)

    @property
    def bytes(self) -> int:
        return sum(o.bytes for o in self.ops)

    def casts(self, scope: Optional[str] = None) -> List[Tuple[Cast, Op]]:
        """Every conversion (``_to_copy``, a dtype-changing ``copy_``, a
        kernel's declared wire casts) with its op; only those inside
        ``scope`` when given."""
        return [(c, o) for o in self.ops for c in o.casts
                if scope is None or o.in_scope(scope)]

    def coll_bytes(self, scope: str) -> int:
        """The payload of the collectives inside ``scope``."""
        return sum(o.coll_bytes for o in self.ops if o.in_scope(scope))

    def by_group(self) -> Dict[str, Dict[str, int]]:
        """FLOPs and bytes by group: ``wire`` (ops in the wire scope),
        ``tp`` (the tensor-parallel collectives), ``kernels`` (hand-written kernel nodes outside it), ``matmul``
        (aten ops with dot FLOPs), ``elementwise`` (the rest)."""
        out: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"ops": 0, "flops": 0, "bytes": 0})
        for o in self.ops:
            g = "wire" if o.in_scope("wire") else "tp" if o.in_scope("tp") \
                else "kernels" if o.kind == "kernel" else "matmul" \
                if o.dot_flops else "elementwise"
            out[g]["ops"] += 1
            out[g]["flops"] += o.flops
            out[g]["bytes"] += o.bytes
        return dict(out)

    # -- recording -----------------------------------------------------------

    def enter_region(self, name: str) -> None:
        self.regions.append((name, len(self.ops)))

    def _labels(self, tensors: Sequence[torch.Tensor]) -> Tuple[str, ...]:
        if not self._watch:
            return ()
        return tuple(self._watch[p] for p in
                     {t.untyped_storage().data_ptr() for t in tensors}
                     if p in self._watch)

    def _record_aten(self, func, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        short = func._overloadpacket.__name__
        if func.namespace == "c10d":
            # all_gather's first argument is its output buffers
            sent = _tensors(args[1] if short == "allgather_" else args[0])
            self.ops.append(Op(
                name=str(func), inputs=tuple(_sig(t) for t in ins),
                outputs=(), dot_flops=0, elem_flops=0, bytes_read=0,
                bytes_written=0, math="float32", scope=instrument.scopes(),
                coll_bytes=sum(t.numel() * t.element_size() for t in sent)))
            return
        dot = 0
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            dot = int(fn(*args, **kwargs, out_val=out))
        free = short in _FREE or getattr(func, "is_view", False)
        elem = 0 if dot or free or torch.Tag.pointwise not in func.tags \
            else sum(t.numel() for t in outs)
        casts = ()
        if short in ("_to_copy", "copy_") and ins and outs:
            src = ins[-1] if short == "copy_" else ins[0]
            if src.dtype != outs[0].dtype:
                casts = (Cast(_dt(src.dtype), _dt(outs[0].dtype),
                              outs[0].numel()),)
        self.ops.append(Op(
            name=str(func), inputs=tuple(_sig(t) for t in ins),
            outputs=tuple(_sig(t) for t in outs), dot_flops=dot,
            elem_flops=elem,
            bytes_read=0 if free else sum(_moved(t) for t in ins),
            bytes_written=0 if free else sum(_moved(t) for t in outs),
            math=_math(ins, dot), scope=instrument.scopes(), casts=casts,
            reads=self._labels(ins)))

    def record_kernel(self, name: str, cost: dict,
                       ins: Sequence[torch.Tensor]) -> None:
        self.ops.append(Op(
            name=f"kernel.{name}", inputs=tuple(_sig(t) for t in ins),
            outputs=(), dot_flops=int(cost.get("dot_flops", 0)),
            elem_flops=int(cost.get("flops", 0)),
            bytes_read=int(cost.get("bytes_read", 0)),
            bytes_written=int(cost.get("bytes_written", 0)),
            math=cost.get("math", "float32"), scope=instrument.scopes(),
            casts=tuple(Cast(*c) for c in cost.get("casts", ())),
            reads=self._labels(ins)))


class _Mode(TorchDispatchMode):
    def __init__(self, trace: OpTrace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.trace.suspended:
            self.trace._record_aten(func, args, kwargs, out)
        return out


class trace:
    """``with trace() as tr:`` records the ops dispatched inside into
    ``tr`` (an `OpTrace`).  ``watch`` maps tensors to labels: every op
    that reads one of their storages lists the label in ``Op.reads``.
    Traces do not nest."""

    def __init__(self, watch: Optional[Dict[str, torch.Tensor]] = None):
        self.trace = OpTrace({t.untyped_storage().data_ptr(): label
                              for label, t in (watch or {}).items()})
        self._mode = _Mode(self.trace)

    def __enter__(self) -> OpTrace:
        instrument.activate(self.trace)
        self._mode.__enter__()
        return self.trace

    def __exit__(self, *exc) -> None:
        try:
            self._mode.__exit__(*exc)
        finally:
            instrument.deactivate()


def count_ops(tr: OpTrace, prefix: str) -> int:
    """Ops whose name is ``prefix`` or starts with ``prefix + "."``;
    ``prefix`` may leave out ``aten.`` (``"mm"`` counts ``aten.mm.*``).
    The counterpart of the reference's ``count_ops(hlo_text, op)``."""
    names = (prefix, "aten." + prefix)
    return sum(1 for o in tr.ops
               if any(o.name == n or o.name.startswith(n + ".")
                      for n in names))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dt(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sig(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), _dt(t.dtype), t.device.type)


def _moved(t: torch.Tensor) -> int:
    """Bytes one pass over ``t`` moves: a broadcast (stride 0) dimension
    is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _math(ins: Sequence[torch.Tensor], dot: int) -> str:
    if not dot:
        return "float32"
    dt = next((t.dtype for t in ins if t.is_floating_point()),
              torch.float32)
    if dt == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 \
            else "float32"
    return _dt(dt)

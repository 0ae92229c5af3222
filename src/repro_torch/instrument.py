"""The hooks the kernels and the algorithms carry for op traces: the lowest
layer of the port beside `repro_torch.tree`, imported by the kernel
wrappers, the algorithms and the pipeline, and importing only torch.

* ``with scope("wire"):`` names the ops inside (the reducers' simulated
  wire, as the reference's ``jax.named_scope("wire")`` does; the
  algorithms' forward and backward pass is ``"model"``);
* `traced_kernel` makes a kernel wrapper one node of an active trace,
  costed by the wrapper's cost function: the one function
  ``chip_smoke.py`` computes the kernel's bound from too;
* `nbytes`, `live_pairs` and `host_ints`: what those cost functions use.

Nothing is recorded unless a recorder is active.
`repro_torch.analysis.optrace.trace` installs one (`activate`) for the
length of a call; outside it a scope is one list append and pop and a
wrapper one global read, so the untraced path keeps its launch counts and
dispatches nothing.  A recorder has ``suspended`` (an int: while above 0
the recorder ignores the ops it sees), ``enter_region(name)`` and
``record_kernel(name, cost, inputs)``.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch

# the active recorder (None: nothing records) and the scope stack; module
# globals rather than thread-locals, because autograd runs a backward pass
# on its own threads and its ops belong to the caller's trace and scope
_ACTIVE = None
_SCOPES: List[str] = []


def active():
    """The active recorder, or None."""
    return _ACTIVE


def activate(recorder) -> None:
    """Make ``recorder`` the active one; recorders do not nest."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("op traces do not nest")
    _ACTIVE = recorder


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def scopes() -> Tuple[str, ...]:
    """The names of the `scope` blocks the caller runs inside."""
    return tuple(_SCOPES)


class scope:
    """``with scope("wire"):`` names the ops inside in the active trace's
    records; outside a trace it only pushes and pops the name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        _SCOPES.append(self.name)
        if _ACTIVE is not None:
            _ACTIVE.enter_region(self.name)

    def __exit__(self, *exc) -> None:
        _SCOPES.pop()


def traced_kernel(name: str, cost: Callable[..., dict]):
    """Decorator of a kernel wrapper: inside an active trace the call is
    recorded as one ``kernel.<name>`` node whose FLOPs, bytes, ``math``
    and wire ``casts`` come from ``cost(*args, **kwargs)`` (a dict with
    ``flops`` / ``dot_flops``, ``bytes_read``, ``bytes_written`` and
    optionally ``math`` and ``casts``), and neither the cost function's
    ops nor the wrapper's own are recorded.  Outside a trace it costs one
    global read."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            rec.suspended += 1
            try:
                rec.record_kernel(name, cost(*args, **kwargs),
                                  tensors((args, kwargs)))
                return fn(*args, **kwargs)
            finally:
                rec.suspended -= 1
        return wrapper
    return deco


def tensors(obj) -> List[torch.Tensor]:
    """The tensors in a nest of lists, tuples and dicts, in order."""
    out: List[torch.Tensor] = []
    _collect(obj, out)
    return out


def _collect(obj, out: List[torch.Tensor]) -> None:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _collect(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _collect(x, out)


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    """Total bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def live_pairs(sq: int, sk: int, causal: bool, window: int,
               q_start: int = 0) -> int:
    """(query, key) pairs attention scores: query row i at absolute
    position ``q_start + i`` sees keys j <= it (``causal``) and within
    ``window`` of it (``window > 0``)."""
    total = 0
    for i in range(sq):
        p = q_start + i
        hi = min(sk, p + 1) if causal else sk
        lo = max(0, p - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def host_ints(t: torch.Tensor) -> List[int]:
    """A small integer tensor's values on the host, for a cost function
    whose work depends on them (B4's live lengths).  A CUDA tensor waits
    for the card: a trace or a bound pays that wait, never the untraced
    path, so the sync-debug check is lifted for the one copy."""
    if t.device.type != "cuda":
        return [int(x) for x in t.reshape(-1).tolist()]
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return [int(x) for x in t.reshape(-1).tolist()]
    finally:
        torch.cuda.set_sync_debug_mode(mode)

"""Double-buffered bucket pipeline: the paper's overlap made explicit (the
port of ``repro.parallel.pipeline``).

DC-S3GD's premise is that the all-reduce of step t's update runs under
step t+1's forward and backward pass.  Under ``overlap=True`` the step
makes that structure explicit over the bucketed wire:

* every step **consumes** the reduction already in flight
  (``TrainState.comm["pipeline"]["reduced"]``, one landed buffer per
  bucket), and
* **issues** the next one at the very end of the step, on the payload the
  tail just produced.

The sequence of reducer calls and their inputs is the inline schedule's
(the reduce of step t's payload moves from the top of step t+1 to the end
of step t), so in eager PyTorch the pipelined trajectory is bitwise the
inline one.  The reference fences both ends with
``lax.optimization_barrier`` so XLA cannot fuse across them; eager
execution materialises every tensor and needs no fence.  The issue runs
on the step's own stream: a second CUDA stream is not part of this
module (the JAX package has none).

State contract (``comm["pipeline"]``):

* ``{"reduced": [r_0, ..., r_{B-1}]}``: (1, n_b) f32 for mean-style
  reducers (the error-feedback family included), (W, n_b) for
  ``reduces_weights`` reducers (gossip, hierarchical mix the packed
  weights);
* a stateful reducer's ``comm["reducer"]`` is the state *after* the
  in-flight issue, one call ahead of the inline layout;
* ``init()`` primes the pipeline with the reduce of the zero payload (the
  packed initial weights for weight mixing): the call the inline schedule
  makes on step 0.

``dynamic_ssp`` composes with a stateless reducer (a revoked window
discards the landed value); with a stateful one it is rejected (see
`validate`).  An elastic resize drains a stateless reducer's buffers (a
fresh reduce of the resized wire) and keeps a stateful reducer's
worker-count-independent (1, n) payload (see `resize`).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

from repro_torch.instrument import scope

Tree = Any


def validate(*, buckets: int, reducer, staleness=None) -> None:
    """Reject overlap configurations whose semantics cannot hold.

    * ``buckets == 0``: the pipeline double-buffers the bucketed wire;
      there is no per-leaf schedule to stage.
    * a stateful staleness policy (``dynamic_ssp``) with a stateful
      reducer: a revoked window must return the undelivered payload to
      the error-feedback residual through ``reducer.revoke(wire,
      prev_rstate, rstate)``, but the pipelined issue has already
      consumed ``prev_rstate`` in the previous step."""
    if not buckets:
        raise ValueError(
            "overlap=True needs the bucketed wire: construct the "
            "algorithm with buckets > 0 (registry.make(..., buckets=N, "
            "overlap=True) / --buckets N --overlap)")
    if (staleness is not None
            and not getattr(staleness, "stateless", True)
            and not getattr(reducer, "stateless", True)):
        raise ValueError(
            "overlap=True cannot compose a stateful staleness policy "
            "(dynamic_ssp) with a stateful (error-feedback) reducer: a "
            "revoked window needs the pre-issue residual, which the "
            "pipelined issue has already advanced past.  Use a "
            "stateless reducer with dynamic_ssp, or the fixed window "
            "with the compressed reducer")


def issue(reducer, wire: List, rstate: Optional[Tree] = None
          ) -> Tuple[dict, Optional[Tree]]:
    """Put the next payload on the wire: reduce the bucket list now and
    carry the result as the in-flight state.  Returns ``(pipeline_state,
    new_reducer_state)``, the latter None for a stateless reducer."""
    # the same `wire` scope the inline schedule puts around its reduce
    with scope("wire"):
        if rstate is None:
            reduced = reducer(wire)
        else:
            reduced, rstate = reducer(wire, rstate)
    return {"reduced": list(reduced)}, rstate


def landed(comm: dict) -> List:
    """The reduction this step consumes, issued at the end of the previous
    one (or by ``init()``)."""
    return comm["pipeline"]["reduced"]


def resize(reducer, pstate: dict, wire: List) -> dict:
    """Drain or keep the in-flight buckets across an elastic resize.

    ``wire`` is the already-resized payload (the restacked ``delta_prev``
    buckets, or the packed restacked weights for ``reduces_weights``
    reducers).  A stateless reducer re-issues on it: every row is the
    consensus after the collapse, so this is the reduce the inline
    schedule makes on its first step after the resize.  A stateful
    reducer keeps its landed (1, n) payload, which does not depend on the
    worker count and whose mass the resized residual already accounts
    for."""
    if getattr(reducer, "stateless", True):
        with scope("wire"):
            return {"reduced": list(reducer(wire))}
    return dict(pstate)

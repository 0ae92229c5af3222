"""Staleness policies (`repro_torch.core.api.StalenessPolicy`; the port
of ``repro.core.staleness``).

* ``fixed`` — the paper's unconditional one-step stale window: stateless,
  so the algorithm skips the policy branch.
* ``dynamic_ssp`` — a Dynamic-SSP-style (Zhao et al. 2019, 1908.11848)
  threshold on the observed per-worker step skew.  Its per-worker progress
  counters ride in ``TrainState.comm["staleness"]``; while
  ``max − min`` stays at or under ``threshold`` the stale window is
  admitted (the trajectory is ``fixed``'s); above it the step falls back
  to a blocking pull toward the worker mean and the counters collapse to
  the leader (the pull is the synchronisation).

The counters live on the host, as a numpy int32 array: the reference
decides inside its jitted step with ``lax.cond``, and an eager branch on
a device flag would cost a host sync every step.  Inside a step they
advance in lockstep; skew appears only when the launch layer feeds
measured progress through ``observe`` (`DCS3GD.observe_progress`).
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from repro_torch.core import registry

Tree = Any


@registry.register(registry.STALENESS_POLICY, "fixed")
class FixedWindow:
    """The paper's one-step stale window; carries nothing in ``comm``."""

    name = "fixed"
    stateless = True

    def __init__(self, cfg=None):
        del cfg

    def init(self, n_workers: int) -> Tree:
        return {}

    def state_specs(self, axes) -> Tree:
        return {}

    def admit(self, pstate: Tree) -> Tuple[bool, Tree]:
        return True, {}


@registry.register(registry.STALENESS_POLICY, "dynamic_ssp")
class DynamicSSP:
    """Dynamic-SSP threshold on observed per-worker step skew: the stale
    window is revoked for a step whose ``max(steps) − min(steps)`` exceeds
    ``threshold`` (default ``cfg.ssp_threshold``)."""

    name = "dynamic_ssp"
    stateless = False

    def __init__(self, cfg=None, *, threshold: int | None = None):
        if threshold is None:
            threshold = cfg.ssp_threshold if cfg is not None else 4
        self.threshold = int(threshold)

    def init(self, n_workers: int) -> Tree:
        return {"worker_steps": np.zeros((n_workers,), np.int32)}

    def state_specs(self, axes) -> Tree:
        # (W,) counters shard over the worker axes (W == their product)
        return {"worker_steps": (axes.worker_spec,)}

    def admit(self, pstate: Tree) -> Tuple[bool, Tree]:
        steps = pstate["worker_steps"]
        ok = bool(steps.max() - steps.min() <= self.threshold)
        # a revoked step's blocking pull resolves the staleness: the
        # counters collapse to the leader, so the window re-opens next step
        new = steps if ok else np.full_like(steps, steps.max())
        return ok, {"worker_steps": (new + 1).astype(np.int32)}

    def observe(self, pstate: Tree, worker_steps) -> Tree:
        """Overwrite the counters with measured progress (host-side; the
        launch layer calls this between steps)."""
        out = dict(pstate)
        # host ints in, host counters out: nothing here is on the device
        out["worker_steps"] = np.asarray(  # lint: allow(host-pull-in-traced)
            worker_steps, np.int32)
        return out

    def resize(self, pstate: Tree, n_new: int) -> Tree:
        """A membership transition is a barrier: the counters collapse to
        the leader and the skew restarts at zero at the new W."""
        top = pstate["worker_steps"].max()
        return {"worker_steps": np.full((int(n_new),), top, np.int32)}

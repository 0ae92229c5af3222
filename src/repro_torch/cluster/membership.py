"""`Membership` — the controller that makes the worker count a variable
(the port of ``repro.cluster.membership``).

It owns the live `ClusterSpec` of a training run and, at step boundaries,
turns membership events (scripted faults, straggler ejections) into a
resized run: the carried `TrainState` collapses to consensus and restacks
through the algorithm's ``resize_state``, and the algorithm object is
rebuilt at the new W by `rebuild_algorithm` (same config, same piece
objects, a fresh bucket-plan cache).  ``Engine.fit(membership=...)``
drives it: it polls events before each step and feeds measured
per-worker progress to `observe_progress`, so a worker that stays slow is
ejected (a transient spike is the ``dynamic_ssp`` revoke's job).

Every transition is appended to ``log`` as a dict of step, kind, worker,
reason and worker count (never a clock), so one seeded fault schedule
always gives the same log.

Elastic resume is the same code path without the controller: ``train
--resume X --workers 6`` against a W = 8 checkpoint calls
``resize_state`` and `rebuild_algorithm` directly
(`repro_torch.launch.train`).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.cluster.faults import FaultSchedule
from repro_torch.cluster.spec import ClusterEvent, ClusterSpec


def rebuild_algorithm(alg, n_new: int):
    """The same algorithm, retargeted to ``n_new`` workers.

    Goes back through `repro_torch.core.registry.make` with the *objects*
    the old instance composed (the ``make_*`` factories pass objects
    through), so reducer hyper-parameters, state kept on the pieces (such
    as ``topk_exact``'s worker count, updated by its own ``resize``) and
    the local optimizer survive, as do the bucket count, overlap and the
    plan's padding block; only the worker count and the bucket-plan cache
    change."""
    kw: dict = {"n_workers": int(n_new)}
    for attr in ("local_optimizer", "reducer", "compensator", "staleness",
                 "use_kernels", "buckets", "overlap", "plan_block"):
        if hasattr(alg, attr):
            kw[attr] = getattr(alg, attr)
    from repro_torch.core import registry
    return registry.make(alg.name, alg.cfg, **kw)


class Membership:
    """Join / leave / eject controller over a `ClusterSpec`.

    eject_threshold  virtual-clock step lag beyond which a worker counts
                     as straggling (None disables ejection);
    eject_patience   consecutive observations over the threshold before
                     the ejection fires;
    min_workers      the policy never ejects below this count (scripted
                     leaves obey their script, down to one worker);
    dense_after_join after a join, a stateful (error-feedback) reducer is
                     wrapped in `repro_torch.core.compress.
                     DenseWindowReduce` for this many steps, which delivers
                     the joiner's inherited residual at once; 0 disables.
    """

    def __init__(self, alg, spec: Optional[ClusterSpec] = None, *,
                 faults: Optional[FaultSchedule] = None,
                 eject_threshold: Optional[float] = None,
                 eject_patience: int = 3, min_workers: int = 2,
                 dense_after_join: int = 0):
        self.alg = alg
        self.spec = spec if spec is not None else \
            ClusterSpec.uniform(getattr(alg, "n_workers", 1))
        if self.spec.n_workers != getattr(alg, "n_workers", 1):
            raise ValueError(f"the spec holds {self.spec.n_workers} workers,"
                             f" the algorithm {getattr(alg, 'n_workers', 1)}")
        self.faults = faults
        self.eject_threshold = eject_threshold
        self.eject_patience = int(eject_patience)
        self.min_workers = int(min_workers)
        self.dense_after_join = int(dense_after_join)
        self.log: List[dict] = []
        self._streak: dict = {}
        self._pending: List[ClusterEvent] = []
        self._dense_until: Optional[int] = None

    @property
    def n_workers(self) -> int:
        return self.spec.n_workers

    # -- event sources -------------------------------------------------------

    def poll(self, step: int) -> List[ClusterEvent]:
        """Events due before step ``step`` runs: queued ejections first
        (decided on the previous step's measurements), the end of an
        elapsed dense window, then the fault schedule's events."""
        events, self._pending = self._pending, []
        if self._dense_until is not None and step >= self._dense_until:
            events.append(ClusterEvent("dense_end", reason="window elapsed"))
        if self.faults is not None:
            events += self.faults.membership_events(step, self.spec)
        return events

    def slowdown_factors(self, step: int) -> Optional[List[float]]:
        return None if self.faults is None else \
            self.faults.slowdown_factors(step, self.spec)

    def observe_progress(self, step: int, progress) -> None:
        """Feed measured per-worker virtual progress (spec order) to the
        ejection policy: a worker lagging the leader by more than
        ``eject_threshold`` steps for ``eject_patience`` observations in a
        row is queued for ejection at the next boundary."""
        if self.eject_threshold is None or not progress:
            return
        top = max(progress)
        for wid, p in zip(self.spec.ids, progress):
            lag = top - p
            if lag <= self.eject_threshold:
                self._streak.pop(wid, None)
                continue
            streak = self._streak.get(wid, 0) + 1
            self._streak[wid] = streak
            if (streak >= self.eject_patience
                    and self.spec.n_workers - len(self._pending)
                    > self.min_workers
                    and all(e.worker != wid for e in self._pending)):
                self._pending.append(ClusterEvent(
                    "eject", worker=wid,
                    reason=f"lag {lag:.1f} > {self.eject_threshold} "
                           f"for {streak} steps"))

    # -- applying transitions ------------------------------------------------

    def apply(self, events: List[ClusterEvent], state, *, step: int):
        """Apply membership events at a step boundary; returns ``(state,
        changed)``.  When ``changed``, ``self.alg`` has been rebuilt (at the
        new W, or with the dense window's reducer swapped out) and the
        caller must step with it.  Every membership change, a same-count
        leave + join included, goes through ``resize_state``: a joiner
        starts from the consensus, never from a leaver's row."""
        from repro_torch.core.compress import DenseWindowReduce
        swapped = False
        dense_end = [ev for ev in events if ev.kind == "dense_end"]
        events = [ev for ev in events if ev.kind != "dense_end"]
        if dense_end:
            self._dense_until = None
        if dense_end and isinstance(getattr(self.alg, "reducer", None),
                                    DenseWindowReduce):
            self.alg.reducer = self.alg.reducer.inner
            swapped = True
            self.log.append({"step": int(step), "kind": "dense_window_end",
                             "worker": "", "reason": "window elapsed",
                             "n_workers": self.spec.n_workers})
        spec = self.spec
        for ev in events:
            if ev.kind in ("leave", "eject"):
                if spec.n_workers <= 1 or ev.worker not in spec.ids:
                    continue
                spec = spec.without(ev.worker)
                self._streak.pop(ev.worker, None)
                self.log.append({"step": int(step), "kind": ev.kind,
                                 "worker": ev.worker, "reason": ev.reason,
                                 "n_workers": spec.n_workers})
            elif ev.kind == "join":
                before = spec.ids
                spec = spec.joined(ev.count, pod=ev.pod)
                joined = [i for i in spec.ids if i not in before]
                self.log.append({"step": int(step), "kind": "join",
                                 "worker": ",".join(joined),
                                 "reason": ev.reason,
                                 "n_workers": spec.n_workers})
            else:
                raise ValueError(f"unknown membership event kind "
                                 f"{ev.kind!r}")
        n_new = spec.n_workers
        mutated = spec.ids != self.spec.ids
        self.spec = spec
        if not mutated:
            return state, swapped
        if not hasattr(self.alg, "resize_state"):
            raise TypeError(
                f"algorithm {self.alg.name!r} has no resize_state hook: it "
                f"cannot train through membership changes")
        state = self.alg.resize_state(state, n_new)
        self.alg = rebuild_algorithm(self.alg, n_new)
        if (self.dense_after_join > 0
                and any(ev.kind == "join" for ev in events)
                and not getattr(self.alg.reducer, "stateless", True)):
            # joiner catch-up: the carried reducer state keeps the inner
            # reducer's structure, so the swap needs no state surgery
            if not isinstance(self.alg.reducer, DenseWindowReduce):
                self.alg.reducer = DenseWindowReduce(self.alg.reducer)
            self._dense_until = int(step) + self.dense_after_join
            self.log.append({"step": int(step),
                             "kind": "dense_window_start", "worker": "",
                             "reason": f"dense_after_join="
                                       f"{self.dense_after_join}",
                             "n_workers": n_new})
        return state, True

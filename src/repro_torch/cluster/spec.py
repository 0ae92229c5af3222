"""`ClusterSpec` — the worker-membership contract of an elastic run (the
port of ``repro.cluster.spec``, pure Python).

DC-S3GD tolerates staleness precisely because real clusters have
stragglers and churn; this module gives the membership itself a first-
class description the rest of the system can react to.  A `ClusterSpec`
is an ordered tuple of `Worker`s (id, pod, health): the ORDER is the
stacking order of every worker-stacked ``(W, ...)`` state leaf and of
the ``(W, b, ...)`` batch, so "worker i" in the algorithm math always
means ``spec.workers[i]``.  Transitions never mutate a spec — `without`
/ `joined` / `marked` return new specs, and `repro_torch.cluster.membership.
Membership` owns applying them to live training state.

Pods group workers by interconnect domain (the `hierarchical` reducer's
groups, the multipod mesh's leading axis); `uniform` builds the boring
single-pod case every smoke run uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Worker:
    """One cluster member: a stable string id (never reused within a
    run), its pod (interconnect group), and a health flag the ejection
    policy flips before removal."""

    id: str
    pod: int = 0
    healthy: bool = True


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """One membership transition request, consumed by `Membership.apply`.

    kind    'leave' (graceful departure), 'eject' (policy removal),
            'join' (``count`` fresh workers enter ``pod``);
    worker  the target id for leave/eject (None = caller resolves);
    reason  free-form provenance for the transition log ("scripted",
            "lag 7 > 4 for 3 steps", ...).
    """

    kind: str
    worker: Optional[str] = None
    count: int = 1
    pod: int = 0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Ordered, immutable worker membership (see module docstring)."""

    workers: Tuple[Worker, ...]
    next_serial: int = 0   # monotone id counter — join ids never collide

    @classmethod
    def uniform(cls, n_workers: int, *, pods: int = 1,
                prefix: str = "w") -> "ClusterSpec":
        """n workers round-robined over ``pods`` pods, ids w0..w{n-1}."""
        if not (n_workers >= 1 and pods >= 1 and n_workers % pods == 0):
            raise ValueError(f"{n_workers} workers do not split into "
                             f"{pods} pods")
        per = n_workers // pods
        ws = tuple(Worker(id=f"{prefix}{i}", pod=i // per)
                   for i in range(n_workers))
        return cls(workers=ws, next_serial=n_workers)

    # -- views ---------------------------------------------------------------

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    @property
    def ids(self) -> Tuple[str, ...]:
        return tuple(w.id for w in self.workers)

    def index(self, worker_id: str) -> int:
        """Stacking-order index of a worker id (raises on unknown ids)."""
        for i, w in enumerate(self.workers):
            if w.id == worker_id:
                return i
        raise KeyError(f"unknown worker {worker_id!r}; have {self.ids}")

    def pods(self) -> Dict[int, Tuple[str, ...]]:
        out: Dict[int, List[str]] = {}
        for w in self.workers:
            out.setdefault(w.pod, []).append(w.id)
        return {p: tuple(ids) for p, ids in out.items()}

    def as_meta(self) -> dict:
        """Checkpoint-metadata form (JSON-serializable)."""
        return {"ids": list(self.ids),
                "pods": [w.pod for w in self.workers],
                "next_serial": self.next_serial}

    # -- transitions (pure) --------------------------------------------------

    def without(self, worker_id: str) -> "ClusterSpec":
        i = self.index(worker_id)   # raises on unknown ids
        return dataclasses.replace(
            self, workers=self.workers[:i] + self.workers[i + 1:])

    def joined(self, count: int = 1, *, pod: int = 0,
               prefix: str = "w") -> "ClusterSpec":
        """``count`` fresh workers appended (new ids from ``next_serial``
        — ids are never reused, so transition logs stay unambiguous)."""
        if count < 1:
            raise ValueError(f"a join adds at least one worker, not "
                             f"{count}")
        new = tuple(Worker(id=f"{prefix}{self.next_serial + i}", pod=pod)
                    for i in range(count))
        return dataclasses.replace(self, workers=self.workers + new,
                                   next_serial=self.next_serial + count)

    def marked(self, worker_id: str, *, healthy: bool) -> "ClusterSpec":
        i = self.index(worker_id)
        ws = list(self.workers)
        ws[i] = dataclasses.replace(ws[i], healthy=healthy)
        return dataclasses.replace(self, workers=tuple(ws))

"""Deterministic fault injection — scripted churn for elastic training
(the port of ``repro.cluster.faults``, pure Python: the victims come from
the same stdlib ``random`` draws, so a schedule resolves to the
reference's transitions exactly).

Real clusters lose nodes, gain nodes, and develop stragglers; CI has
none of those.  A `FaultSchedule` scripts them: a list of `FaultEvent`s
(leave / join / eject / slowdown) pinned to step numbers, with any
unnamed victim resolved by a PRNG seeded from ``(seed, step)`` against
the membership current at that step — so the same schedule against the
same run produces the same transitions, twice, forever (the CI elastic
smoke asserts exactly this on the transition log).

Membership events (leave/join/eject) feed `Membership.apply` at step
boundaries; ``slowdown`` events never change membership — they multiply
the *measured* per-worker durations inside ``Engine.fit``'s skew loop,
which is how a scripted straggler trips the ``dynamic_ssp`` revoke or
the ejection policy exactly like a real one.  Note the virtual-clock
advance uses duration *ratios* (``max(durs)/durs[w]``), so slowdowns
shift measured skew deterministically regardless of wall-clock noise.

JSON format (``repro_torch.launch.train --fault-schedule faults.json``)::

    {"seed": 0, "events": [
        {"step": 4,  "kind": "leave", "worker": "w1"},
        {"step": 9,  "kind": "join", "count": 1},
        {"step": 12, "kind": "slowdown", "worker": "w0",
         "factor": 16.0, "duration": 8}
    ]}

``worker`` may be omitted (random victim), ``reason`` defaults to
"scripted".
"""
from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.cluster.spec import ClusterEvent, ClusterSpec


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault.

    step      the fit-loop step the event fires at (before the step runs);
    kind      'leave' | 'join' | 'eject' | 'slowdown';
    worker    victim id; None resolves a seeded random victim at fire
              time (leave/eject/slowdown only);
    count/pod join arity and placement;
    factor    slowdown multiplier on the measured step duration;
    duration  how many consecutive steps the slowdown persists.
    """

    step: int
    kind: str
    worker: Optional[str] = None
    count: int = 1
    pod: int = 0
    factor: float = 1.0
    duration: int = 1
    reason: str = "scripted"

    def __post_init__(self):
        if self.kind not in ("leave", "join", "eject", "slowdown"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultSchedule:
    """Scripted, seeded fault timeline (see module docstring)."""

    def __init__(self, events: Sequence[FaultEvent], *, seed: int = 0):
        self.events = tuple(sorted(events, key=lambda e: e.step))
        self.seed = int(seed)

    @classmethod
    def from_json(cls, src) -> "FaultSchedule":
        """Build from a dict, a JSON string, or a path to a JSON file."""
        if isinstance(src, (str, Path)) and Path(src).exists():
            src = Path(src).read_text()
        if isinstance(src, str):
            src = json.loads(src)
        events = [FaultEvent(**e) for e in src.get("events", [])]
        return cls(events, seed=int(src.get("seed", 0)))

    def _victim(self, ev: FaultEvent, spec: ClusterSpec) -> Optional[str]:
        """Resolve the event's target against the current membership.
        Deterministic: the PRNG is keyed on (seed, step), never on call
        order or wall clock."""
        if ev.worker is not None:
            return ev.worker if ev.worker in spec.ids else None
        if not spec.ids:
            return None
        rng = random.Random((self.seed << 20) ^ ev.step)
        return rng.choice(spec.ids)

    def membership_events(self, step: int, spec: ClusterSpec
                          ) -> List[ClusterEvent]:
        """The leave/join/eject events firing at ``step`` as
        `ClusterEvent`s, victims resolved against ``spec`` (an event
        naming a worker that already left is dropped, not an error —
        schedules are written against the t=0 membership)."""
        out = []
        for ev in self.events:
            if ev.step != step or ev.kind == "slowdown":
                continue
            if ev.kind == "join":
                out.append(ClusterEvent("join", count=ev.count, pod=ev.pod,
                                        reason=ev.reason))
                continue
            victim = self._victim(ev, spec)
            if victim is not None:
                out.append(ClusterEvent(ev.kind, worker=victim,
                                        reason=ev.reason))
        return out

    def slowdown_factors(self, step: int, spec: ClusterSpec
                         ) -> Optional[List[float]]:
        """Per-worker duration multipliers active at ``step`` (spec
        order), or None when no slowdown is live."""
        factors = {wid: 1.0 for wid in spec.ids}
        live = False
        for ev in self.events:
            if ev.kind != "slowdown" or not \
                    (ev.step <= step < ev.step + ev.duration):
                continue
            victim = self._victim(ev, spec)
            if victim is not None:
                factors[victim] *= float(ev.factor)
                live = True
        return [factors[wid] for wid in spec.ids] if live else None

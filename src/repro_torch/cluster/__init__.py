"""Elastic worker membership (the port of ``repro.cluster``):

* `spec.ClusterSpec` / `spec.Worker` / `spec.ClusterEvent`: the membership
  contract (worker order is the stacking order of every (W, ...) leaf);
* `membership.Membership`: events in, a resized state and a rebuilt
  algorithm out, with a deterministic transition log;
* `membership.rebuild_algorithm`: the same algorithm at a new worker
  count (elastic resume shares it with the live resize);
* `faults.FaultSchedule` / `faults.FaultEvent`: scripted, seeded
  join / leave / eject / slowdown timelines.
"""
from repro_torch.cluster.faults import FaultEvent, FaultSchedule
from repro_torch.cluster.membership import Membership, rebuild_algorithm
from repro_torch.cluster.spec import ClusterEvent, ClusterSpec, Worker

__all__ = ["ClusterEvent", "ClusterSpec", "FaultEvent", "FaultSchedule",
           "Membership", "Worker", "rebuild_algorithm"]

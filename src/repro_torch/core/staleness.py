"""Staleness policies (`repro_torch.core.api.StalenessPolicy`).

``fixed`` is the paper's unconditional one-step stale window: stateless,
so the algorithm skips the policy branch.  ``dynamic_ssp`` is queued
(ROADMAP A5).
"""
from __future__ import annotations

from typing import Any

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

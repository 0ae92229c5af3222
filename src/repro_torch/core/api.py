"""The `DistributedOptimizer` protocol and its composable pieces (the port
of ``repro.core.api``).

    from repro_torch.core import registry
    alg = registry.make("dc_s3gd", dc_cfg, n_workers=4)
    state = alg.init(params)
    state, metrics = alg.step(state, batch, loss_fn=model.loss)
    weights = alg.eval_params(state)

State is the frozen `TrainState`; every params/opt/comm leaf carries a
leading worker axis W.  The sharding hooks (``state_specs`` /
``batch_specs``) and ``MeshAxes`` wait for the multi-device slice.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Protocol,
                    Tuple, runtime_checkable)

import torch

Tree = Any
Metrics = Dict[str, Any]
LossFn = Callable[[Tree, Tree], torch.Tensor]
# per-step scalar schedules handed to local optimizers ({"lr", "weight_decay"})
Schedules = Mapping[str, float]


class TrainState(NamedTuple):
    """Generic training state shared by every algorithm.

    params  model weights, (W, ...) per worker;
    opt     local-optimizer slots (``{"m": ...}`` for momentum);
    comm    communication state (``{"delta_prev": ...}`` for DC-S3GD's
            in-flight all-reduce payload);
    step    iteration counter, a host int: the schedules are computed on
            the host from it, so a step never reads the device for them.
    """

    params: Tree
    opt: Tree
    comm: Tree
    step: int


@runtime_checkable
class LocalOptimizer(Protocol):
    """U(g, eta, mu): returns the update Δw plus new slots."""

    name: str

    def init(self, params: Tree) -> Tree:
        ...

    def __call__(self, grads: Tree, slots: Tree, params: Tree,
                 schedules: Schedules, *, axis0_is_worker: bool = False
                 ) -> Tuple[Tree, Tree]:
        ...


@runtime_checkable
class Reducer(Protocol):
    """Cross-worker reduction of a (W, ...)-leaved tree; leaves of the
    result broadcast against (W, ...), f32."""

    name: str

    def __call__(self, tree: Tree) -> Tree:
        ...


@runtime_checkable
class Compensator(Protocol):
    """Staleness correction g -> g̃ given a distance tree D; returns
    (corrected grads, λ used)."""

    name: str
    lambda0: float

    def __call__(self, grads: Tree, distance: Tree, *,
                 axis0_is_worker: bool = False) -> Tuple[Tree, torch.Tensor]:
        ...


@runtime_checkable
class StalenessPolicy(Protocol):
    """How wide the stale window may be; ``stateless`` policies carry
    nothing in ``comm``."""

    name: str
    stateless: bool

    def init(self, n_workers: int) -> Tree:
        ...


@runtime_checkable
class DistributedOptimizer(Protocol):
    name: str

    def init(self, params: Tree) -> TrainState:
        ...

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        ...

    def eval_params(self, state: TrainState) -> Tree:
        """Canonical (unstacked) weights for evaluation."""
        ...

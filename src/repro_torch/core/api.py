"""The `DistributedOptimizer` protocol and its composable pieces (the port
of ``repro.core.api``).

    from repro_torch.core import registry
    alg = registry.make("dc_s3gd", dc_cfg, n_workers=4)
    state = alg.init(params)
    state, metrics = alg.step(state, batch, loss_fn=model.loss)
    weights = alg.eval_params(state)

State is the frozen `TrainState`; every params/opt/comm leaf carries a
leading worker axis W.

Every algorithm declares its own sharding through the ``state_specs`` /
``batch_specs`` hooks: given a `MeshAxes` naming the worker and
tensor-parallel mesh axes, it returns spec trees for its `TrainState` and
its batch (`repro_torch.parallel.sharding`: one plain tuple per leaf,
the reference's ``tuple(PartitionSpec)``).  The Engine's mesh seam, the
dry-run and the tests derive every layout from these two calls.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Protocol,
                    Tuple, runtime_checkable)

import torch

Tree = Any
# one entry per tensor dim: None, a mesh axis name, or a tuple of names
Spec = Tuple
Metrics = Dict[str, Any]
LossFn = Callable[[Tree, Tree], torch.Tensor]
# per-step scalar schedules handed to local optimizers ({"lr", "weight_decay"})
Schedules = Mapping[str, float]


class MeshAxes(NamedTuple):
    """Mesh-axis naming contract handed to the sharding hooks.

    worker      the mesh axes whose product forms the DC worker dim
                (('pod', 'data') on the multipod mesh, ('data',) on one
                pod); every non-'model' axis by convention;
    model       name of the tensor-parallel axis;
    model_size  size of the model axis: the partition rules use it to
                decide head / dim divisibility.
    """

    worker: Tuple[str, ...]
    model: str = "model"
    model_size: int = 1

    @property
    def worker_spec(self):
        """Worker axes as one spec entry: a bare name for one axis, the
        tuple for several, None for none."""
        if not self.worker:
            return None
        return self.worker if len(self.worker) > 1 else self.worker[0]


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
                 axis0_is_worker: bool = False,
                 sum_sq=None) -> Tuple[Tree, torch.Tensor]:
        """``sum_sq`` adds up per-leaf (‖g‖², ‖c‖²) pairs for a global
        λ (the step's norm helper, summing over a 'model' axis)."""
        ...


@runtime_checkable
class StalenessPolicy(Protocol):
    """How wide the stale window may be; ``stateless`` policies carry
    nothing in ``comm``."""

    name: str
    stateless: bool

    def init(self, n_workers: int) -> Tree:
        ...

    def state_specs(self, axes: MeshAxes) -> Tree:
        """Specs matching :meth:`init`'s structure."""
        ...


@runtime_checkable
class DistributedOptimizer(Protocol):
    """A complete distributed training algorithm.  Besides init / step /
    eval_params it owns its sharding: ``state_specs`` / ``batch_specs``
    map its `TrainState` and its (W, b, ...) batch to spec trees for a
    `MeshAxes`; worker-sharded algorithms put the worker axes on the
    leading state dim, replicated ones return canonical specs."""

    name: str

    def init(self, params: Tree) -> TrainState:
        ...

    def step(self, state: TrainState, batch: Tree, *, loss_fn: LossFn
             ) -> Tuple[TrainState, Metrics]:
        ...

    def eval_params(self, state: TrainState) -> Tree:
        """Canonical (unstacked) weights for evaluation."""
        ...

    def state_specs(self, model_cfg: Any, state: TrainState,
                    axes: MeshAxes) -> TrainState:
        """Spec tree mirroring ``state`` (``()`` on scalars)."""
        ...

    def batch_specs(self, model_cfg: Any, batch: Tree,
                    axes: MeshAxes) -> Tree:
        """Spec tree mirroring the (W, b, ...) batch."""
        ...

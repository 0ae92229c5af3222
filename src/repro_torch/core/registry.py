"""Registries: algorithms, local optimizers, reducers, compensators,
staleness policies — the same kinds and names as ``repro.core.registry``.

Call sites construct everything from config strings:

    registry.make("dc_s3gd", cfg, n_workers=32)            # Algorithm 1
    registry.make("stale",   cfg, n_workers=32)            # lambda0 = 0
    registry.make("ssgd",    cfg, n_workers=32)            # synchronous
    registry.make("dc_asgd", cfg, n_workers=32)            # PS simulator

Provider modules register themselves at import via ``@register``; lookups
import the known providers lazily.  An unknown name raises a ``KeyError``
naming it.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Tuple

ALGORITHM = "algorithm"
LOCAL_OPTIMIZER = "local_optimizer"
REDUCER = "reducer"
COMPENSATOR = "compensator"
STALENESS_POLICY = "staleness_policy"

_REGISTRY: Dict[str, Dict[str, Callable[..., Any]]] = {
    ALGORITHM: {}, LOCAL_OPTIMIZER: {}, REDUCER: {}, COMPENSATOR: {},
    STALENESS_POLICY: {},
}

# imported lazily, once, the first time a lookup runs
_PROVIDERS = (
    "repro_torch.core.reduce",
    "repro_torch.core.compress",
    "repro_torch.core.compensate",
    "repro_torch.core.staleness",
    "repro_torch.optim.local",
    "repro_torch.core.dc_s3gd",
    "repro_torch.core.ssgd",
    "repro_torch.core.dc_asgd",
)
_loaded = False


def register(kind: str, name: str):
    """Class/function decorator: ``@register(ALGORITHM, "dc_s3gd")``."""
    if kind not in _REGISTRY:
        raise KeyError(f"unknown registry kind {kind!r}")

    def deco(factory):
        _REGISTRY[kind][name] = factory
        return factory

    return deco


def _ensure_loaded() -> None:
    global _loaded
    if not _loaded:
        for mod in _PROVIDERS:
            importlib.import_module(mod)
        _loaded = True


def _lookup(kind: str, name: str):
    _ensure_loaded()
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(f"unknown {kind} {name!r}; have "
                       f"{sorted(_REGISTRY[kind])}") from None


def names(kind: str = ALGORITHM) -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY[kind]))


def make(name: str, cfg, **kwargs):
    """Build a `DistributedOptimizer` from a `DCS3GDConfig`; keyword
    arguments (``n_workers``, ``reducer``, ``use_kernels``, ``buckets`` ...)
    pass through to the factory."""
    return _lookup(ALGORITHM, name)(cfg, **kwargs)


def make_local_optimizer(spec, cfg=None):
    if not isinstance(spec, str):
        return spec
    return _lookup(LOCAL_OPTIMIZER, spec)(cfg)


def make_reducer(spec, cfg=None, **hparams):
    if not isinstance(spec, str):
        return spec
    return _lookup(REDUCER, spec)(cfg, **hparams)


def make_compensator(spec, cfg=None):
    if not isinstance(spec, str):
        return spec
    return _lookup(COMPENSATOR, spec)(cfg)


def make_staleness_policy(spec, cfg=None):
    if not isinstance(spec, str):
        return spec
    return _lookup(STALENESS_POLICY, spec)(cfg)

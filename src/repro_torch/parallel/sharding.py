"""Partition rules: parameter / batch / cache trees -> spec trees (the port
of ``repro.parallel.sharding``).

Scheme (single pod): mesh ('data', 'model') = (16, 16); multi-pod adds a
leading 'pod' axis that joins 'data' as the DC-S3GD worker axis.

* Tensor parallelism over 'model': attention heads (when divisible; the
  projections stay replicated otherwise), FFN hidden dim, MoE experts,
  SSM / RG-LRU inner dim, vocab dim of the embedding and unembedding.
* DC-S3GD worker axis: leading dim of every state leaf, sharded over
  ('pod', 'data'): one weight replica per data shard.

A spec is a plain tuple per leaf, one entry per tensor dim: None, a mesh
axis name, or a tuple of names (sharded over their product, the first
name major).  It is exactly ``tuple(PartitionSpec)`` of the reference.
Rules are keyed on the parameter's dict-path name; ranks (``leaf.ndim``,
which fake tensors carry too) disambiguate collisions (dense ``w_up``
(d, f) vs MoE ``w_up`` (E, d, f)).

Spec trees mirror their tree's containers; since a spec is itself a
tuple, read them back along the tree they describe (`flat_specs`), never
by flattening the spec tree alone.  `placements` turns a spec into
DTensor placements on a `DeviceMesh`, `local_shape` / `local_slices`
give one rank's shard, `gather_shards` the whole tree of every rank's
shards.  `model_dim` / `sharded_over_model` say which
leaves the tensor-parallel path holds in shards, and `model_shard` cuts
a whole tree to one model rank's shards, refusing a leaf whose sharded
dim does not divide the axis by name.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.types import ModelConfig

Tree = Any
Spec = Tuple
Path = Tuple


# ---------------------------------------------------------------------------
# walking trees with paths
# ---------------------------------------------------------------------------


def _children(t: Tree):
    """(key, child) pairs of a container, in the flatten order of
    `repro_torch.tree` (sorted dict keys; NamedTuple fields by name), or
    None for a leaf."""
    if isinstance(t, dict):
        return [(k, t[k]) for k in sorted(t)]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return list(zip(t._fields, t))
    if isinstance(t, (list, tuple)):
        return list(enumerate(t))
    return None


def map_with_path(fn: Callable[[Path, Any], Any], tree: Tree,
                  path: Path = ()) -> Tree:
    """``fn(path, leaf)`` over every leaf, in ``tree``'s containers; a path
    is the tuple of dict keys, field names and list indices."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = [(k, map_with_path(fn, c, path + (k,))) for k, c in kids]
    if isinstance(tree, dict):
        return dict(out)
    vals = [v for _, v in out]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def leaves_with_path(tree: Tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, c in kids:
        out.extend(leaves_with_path(c, path + (k,)))
    return out


def flat_specs(specs: Tree, like: Tree) -> List[Tuple[Path, Spec]]:
    """(path, spec) for every leaf of ``like``, read from the spec tree
    ``specs`` that mirrors it."""
    out = []
    for path, _ in leaves_with_path(like):
        s = specs
        for k in path:
            s = s[k] if not isinstance(k, str) or isinstance(s, dict) \
                else getattr(s, k)
        out.append((path, tuple(s)))
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _attn_shardable(n: int, model_size: int) -> bool:
    return n > 0 and n % model_size == 0


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or of any object with
    ``axis_names`` and a ``shape`` dict, a shape-only stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def validate_worker_count(n_workers, mesh) -> None:
    """Fail fast when ``n_workers`` cannot be laid out on ``mesh``.

    The (W, ...) state leaves and the (W, b, ...) batch shard their
    leading dim over every non-'model' mesh axis, which requires W to be
    a multiple of that axis product; here it raises at construction with
    the numbers spelled out.  ``mesh=None`` (one process, no sharding)
    and algorithms without a worker count validate trivially."""
    if mesh is None or n_workers is None:
        return
    shape = mesh_shape(mesh)
    worker_axes = tuple(a for a in shape if a != "model")
    capacity = 1
    for a in worker_axes:
        capacity *= shape[a]
    if int(n_workers) % capacity != 0:
        import torch.distributed as dist
        ranks = dist.get_world_size() if dist.is_available() \
            and dist.is_initialized() else 1
        raise ValueError(
            f"n_workers={n_workers} cannot shard over the mesh's worker "
            f"axes {worker_axes} (product {capacity}, mesh shape "
            f"{shape}, {ranks} ranks in the process group): "
            f"the leading worker dim of every state/batch leaf must be a "
            f"multiple of {capacity}. Use a worker count divisible by "
            f"{capacity}, or rebuild the mesh for this membership "
            f"(repro_torch.cluster / launch.mesh.mesh_for_spec).")


def _base_spec(name: str, parent: str, ndim: int, cfg: ModelConfig,
               model_size: int) -> Spec:
    """Spec for the canonical (unstacked) parameter."""
    m = "model"
    heads_ok = _attn_shardable(cfg.eff_n_heads, model_size)
    kv_ok = _attn_shardable(cfg.eff_n_kv_heads, model_size)

    if name in ("scale", "bias", "conv_b", "dt_bias", "d_skip", "lam"):
        # canonical rank 1; SSM/RG-LRU per-channel vectors shard over model
        return (m,) if parent in ("mamba", "rglru") and name != "scale" \
            else (None,)
    if name == "tok":
        # vocab-sharded: the token gather costs one activation all-reduce
        # and activations come out replicated over 'model' (Megatron)
        return (m, None)
    if name == "unembed":
        return (None, m)                       # shard vocab: chunked xent
    if name == "vision_proj":
        return (None, m)
    if name == "wq":
        return (None, m, None) if heads_ok else (None, None, None)
    if name in ("wk", "wv"):
        return (None, m, None) if kv_ok else (None, None, None)
    if name == "wo":
        return (m, None, None) if heads_ok else (None, None, None)
    if name in ("w_up", "w_gate"):
        if parent == "moe":                    # (E, d, f): expert parallel
            return (m, None, None)
        return (None, m)                       # dense (d, f) / rglru (d, w)
    if name == "w_down":
        if parent == "moe":                    # (E, f, d)
            return (m, None, None)
        return (m, None)
    if name == "router":
        return (None, None)
    # --- mamba ---
    if name == "w_in":
        return (None, m)
    if name == "conv_w":
        return (m, None)
    if name == "w_x":
        if parent == "rglru":                  # (d, w)
            return (None, m)
        return (m, None)                       # mamba (e, r+2n)
    if name == "w_dt":
        return (None, m)
    if name == "a_log":
        return (m, None)
    if name == "w_out":
        return (m, None)                       # (e|w, d)
    # --- rglru ---
    if name in ("w_a", "w_i"):
        return (None, m)
    # --- MLA ---
    if name in ("w_dq", "w_dkv", "w_kr"):
        return (None, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return (None, m, None) if heads_ok else (None, None, None)
    raise ValueError(f"no partition rule for param {parent}/{name} "
                     f"(ndim={ndim}): add one to _base_spec")


_PARENTS_OF_INTEREST = {"mamba", "rglru", "attn", "xattn", "moe", "mlp"}


def _path_names(path: Path) -> Tuple[str, str]:
    keys = [str(k) for k in path]
    name = keys[-1]
    parent = next((k for k in reversed(keys[:-1])
                   if k in _PARENTS_OF_INTEREST), "")
    return name, parent


def _ndim(leaf) -> int:
    return leaf.dim() if hasattr(leaf, "dim") else len(getattr(
        leaf, "shape", ()))


def param_specs(cfg: ModelConfig, params: Tree, *, model_size: int,
                worker_axes=None) -> Tree:
    """Spec tree matching ``params`` (real or fake tensors).

    ``worker_axes`` (e.g. ('pod', 'data')) marks a leading DC-S3GD worker
    dim on every leaf.  Stacked stage dims (and any other extra leading
    dims) get None.  A model without a `ModelConfig` (``cfg=None``: the
    paper's CNN, a test problem) has no tensor-parallel rules: its leaves
    are replicated over 'model' and only the worker dim is sharded."""
    def spec_of(path, leaf):
        name, parent = _path_names(path)
        nd = _ndim(leaf)
        base = (None,) * (nd - (1 if worker_axes else 0)) if cfg is None \
            else _base_spec(name, parent, nd, cfg, model_size)
        extra = nd - len(base) - (1 if worker_axes else 0)
        assert extra >= 0, (name, nd, base)
        lead = ((worker_axes,) if worker_axes else ()) + (None,) * extra
        return (*lead, *base)

    return map_with_path(spec_of, params)


def opt_specs(cfg: ModelConfig, opt_state: dict, *, model_size: int,
              worker_axes=None) -> dict:
    """Optimizer slots mirror the param tree one level down ({'m':
    params}, plus the scalar 't' for adam)."""
    return {k: () if k == "t" else
            param_specs(cfg, v, model_size=model_size,
                        worker_axes=worker_axes)
            for k, v in opt_state.items()}


def train_state_specs(cfg: ModelConfig, state, *, model_size: int,
                      worker_axes, comm_overrides: Optional[dict] = None):
    """Shared builder behind the per-algorithm ``state_specs`` hooks.

    params / opt / comm share the param layout (+ the worker axis where
    the algorithm asked for one); ``comm_overrides`` supplies ready-made
    spec subtrees for comm entries that do not mirror the param tree (a
    staleness policy's counters, bucket lists)."""
    from repro_torch.core.api import TrainState

    overrides = comm_overrides or {}
    ps = param_specs(cfg, state.params, model_size=model_size,
                     worker_axes=worker_axes)
    opt = opt_specs(cfg, state.opt, model_size=model_size,
                    worker_axes=worker_axes)
    comm = {k: overrides[k] if k in overrides
            else param_specs(cfg, v, model_size=model_size,
                             worker_axes=worker_axes)
            for k, v in state.comm.items()}
    return TrainState(ps, opt, comm, ())


def batch_specs(cfg: ModelConfig, batch: Tree, *, worker_axes=None,
                data_axes=None) -> Tree:
    """Training batches: leading worker axis (DC) or plain data-parallel
    batch axis (serving)."""
    def spec_of(path, leaf):
        name = str(path[-1]) if path else ""
        if name == "pos":
            return ()
        if name == "mrope_positions" and worker_axes is None:
            return ()
        lead = worker_axes if worker_axes is not None else data_axes
        return (lead, *(None,) * (_ndim(leaf) - 1))
    return map_with_path(spec_of, batch)


def cache_specs(cfg: ModelConfig, cache: Tree, *, model_size: int,
                data_axes=("data",)) -> Tree:
    """Decode caches.  Leaves carry a leading stacked-layer dim.

    KV caches (B, S, KV, hd): batch over data; KV heads over model when
    divisible, otherwise the sequence dim over model.  SSM / recurrent
    states (B, ..., E): inner dim over model.  MLA latent (B, S, r):
    sequence over model."""
    kv_ok = _attn_shardable(cfg.eff_n_kv_heads, model_size)

    def spec_of(path, leaf):
        name, _ = _path_names(path)
        nd = _ndim(leaf)  # includes the leading layer-stack dim
        if name in ("k", "v", "xk", "xv"):
            if kv_ok:
                return (None, data_axes, None, "model", None)
            return (None, data_axes, "model", None, None)
        if name in ("ckv", "k_rope"):
            return (None, data_axes, "model", None)
        if name == "conv":      # (L, B, K-1, E)
            return (None, data_axes, None, "model")
        if name == "ssm":       # (L, B, E, N)
            return (None, data_axes, "model", None)
        if name == "h":         # (L, B, W)
            return (None, data_axes, "model")
        return (None, data_axes, *(None,) * (nd - 2))

    return map_with_path(spec_of, cache)


# ---------------------------------------------------------------------------
# from specs to shards
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements, one per mesh dim, for a leaf of ``spec``: a
    mesh dim named in the entry of tensor dim ``d`` is ``Shard(d)``,
    every other one ``Replicate()``.  A tuple entry ('pod', 'data')
    shards dim ``d`` over both mesh dims in mesh order, JAX's pod-major
    layout."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes_of(entry):
            out[names.index(a)] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """One rank's shard shape; raises where a sharded dim does not divide
    by the product of its axes (the dry-run's type check)."""
    shape = tuple(int(n) for n in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the shape "
                         f"{shape} has dims")
    out = list(shape)
    for d, entry in enumerate(spec):
        k = math.prod(mesh_shape[a] for a in _axes_of(entry))
        if out[d] % k:
            raise ValueError(f"dim {d} of shape {shape} ({out[d]}) does not "
                             f"divide over {entry} (product {k}) under "
                             f"spec {spec}")
        out[d] //= k
    return tuple(out)


def local_slices(shape: Sequence[int], spec: Spec,
                 mesh_shape: Dict[str, int],
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The index of the shard that the rank at mesh coordinate ``coord``
    ({axis: index}) holds: per sharded dim, block number
    Σ-major over the entry's axes (pod-major) times the shard length."""
    loc = local_shape(shape, spec, mesh_shape)
    out = []
    for d, n in enumerate(loc):
        idx = 0
        entry = spec[d] if d < len(spec) else None
        for a in _axes_of(entry):
            idx = idx * mesh_shape[a] + coord[a]
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over 'model', or None (replicated there)."""
    for d, entry in enumerate(spec):
        if "model" in _axes_of(entry):
            return d
    return None


def sharded_over_model(cfg: Optional[ModelConfig], tree: Tree, *,
                       model_size: int) -> Tuple[bool, ...]:
    """Per leaf of ``tree`` (flatten order), whether the partition rules
    shard it over 'model'.  Only names and ranks are read, so a tree of
    local shards, with or without a leading worker dim, answers as the
    whole tree does; a model without a `ModelConfig` is replicated."""
    if cfg is None:
        return tuple(False for _ in leaves_with_path(tree))
    specs = param_specs(cfg, tree, model_size=model_size)
    return tuple(model_dim(s) is not None for _, s in flat_specs(specs,
                                                                 tree))


def validate_model_axis(cfg: Optional[ModelConfig], params: Tree, *,
                        model_size: int) -> None:
    """Raise, naming the leaf, where a dim the rules shard over 'model'
    does not divide the axis (``params``: a whole tree, real or fake)."""
    if cfg is None:
        return
    specs = param_specs(cfg, params, model_size=model_size)
    for (path, x), (_, spec) in zip(leaves_with_path(params),
                                    flat_specs(specs, params)):
        d = model_dim(spec)
        if d is not None and x.shape[d] % model_size:
            raise ValueError(
                f"leaf {'/'.join(map(str, path))} of shape "
                f"{tuple(x.shape)}: dim {d} ({x.shape[d]}) does not divide "
                f"over the 'model' axis of {model_size}")


def model_shard(cfg: Optional[ModelConfig], params: Tree, *,
                model_size: int, rank: int) -> Tree:
    """The shards of a whole parameter tree (no worker dim) that the rank
    at ``rank`` on the 'model' axis holds under the partition rules.
    Raises, naming the leaf, where a sharded dim does not divide the
    axis."""
    if cfg is None:
        return params
    validate_model_axis(cfg, params, model_size=model_size)
    specs = dict(flat_specs(param_specs(cfg, params, model_size=model_size),
                            params))
    sizes = {"model": model_size}

    def take(path, x):
        spec = tuple(e if "model" in _axes_of(e) else None
                     for e in specs[path])
        return x[local_slices(tuple(x.shape), spec, sizes,
                              {"model": rank})].clone()
    return map_with_path(take, params)


def gather_shards(tree: Tree, specs: Tree, mesh) -> Tree:
    """The whole tree of this rank's shards ``tree`` under ``specs`` on
    ``mesh`` (a `DeviceMesh`): every sharded dim all-gathered over each
    of its axes, the minor axis first, so that a ('pod', 'data') entry
    comes back pod-major as `local_slices` cut it.  The inverse of
    `repro_torch.launch.engine.Engine.shard` (a serving rank's cache
    under `cache_specs`, its serve params).  Collective: every rank of
    the mesh calls it with its own shards.  Over gloo a device tensor
    travels through a host copy and comes back on its device."""
    import torch
    import torch.distributed as dist
    flat = dict(flat_specs(specs, tree))

    def whole(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        for d, entry in enumerate(flat[path]):
            for a in reversed(_axes_of(entry)):
                group = mesh.get_group(a)
                # gloo gathers host tensors; never called inside a step
                host = dist.get_backend(group) == "gloo"
                src = x.cpu() if host else x  # lint: allow(host-pull-in-traced)
                parts = [torch.empty_like(src)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, src.contiguous(), group=group)
                x = torch.cat(parts, dim=d).to(x.device)
        return x
    return map_with_path(whole, tree)


def shard_bytes(tree: Tree, specs: Tree, mesh_shape: Dict[str, int]) -> int:
    """Per-device bytes of ``tree``'s shards under ``specs``.  A host int
    (the port's step counter) counts as the int32 scalar the reference
    carries on the device and `repro_torch.checkpoint` stores."""
    total = 0
    for (path, leaf), (_, spec) in zip(leaves_with_path(tree),
                                       flat_specs(specs, tree)):
        if isinstance(leaf, int):
            total += 4
            continue
        n = math.prod(local_shape(tuple(leaf.shape), spec, mesh_shape))
        item = leaf.element_size() if hasattr(leaf, "element_size") \
            else leaf.dtype.itemsize
        total += n * item
    return total

"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Everything here is a function, never a module-level constant: importing
this module touches no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, which the caller starts (`init_process_group`)
with the backend its device type needs, chosen in one place
(`BACKENDS`): NCCL for ``cuda``, gloo for ``cpu``.  The dry-run starts
the ``fake`` backend instead (`repro_torch.launch.dryrun`), so that the
production meshes exist without their 256 / 512 devices.

The DC-S3GD worker axis is every non-'model' mesh axis; a rank's worker
coordinate is its index on those axes, pod-major (`worker_index`), and
`make_workers` gives the algorithms' worker seam
(`repro_torch.core.reduce.ProcessWorkers`) over their process group.  The
'model' axis is the other one: `model_group` holds the ranks that share
this rank's worker coordinates, and `model_axis` gives the
tensor-parallel context (`repro_torch.parallel.tensor.ModelAxis`) over
it.

`mesh_for_spec` lays a cluster membership over the first ranks of the
world, as the reference lays it over ``devices[:used]``: a membership
that fewer ranks carry (6 workers on 4 ranks: a (2, 1) mesh) leaves the
other ranks outside the mesh.  Such a rank holds no rows
(`holds_rows` is False; torch's ``get_coordinate()`` is None there): its
worker seam says so (``ProcessWorkers.holds``), and an `Engine` over the
mesh takes no step on it.  Every rank of the world builds every mesh
(``new_group`` is collective over the default group), in one order, and
each mesh is built once: a membership that comes back reuses its groups.
"""
from __future__ import annotations

import math
from typing import Tuple

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(*, device_type: str, init_method: str, rank: int,
                       world_size: int) -> None:
    """Start this rank's default process group over the backend that
    ``device_type`` needs (``init_method``: a ``file://`` or ``tcp://``
    rendezvous)."""
    import torch.distributed as dist
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            rank=rank, world_size=world_size)


def _device_mesh(device_type: str, shape: Tuple[int, ...],
                 axes: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a started process group of "
            f"{math.prod(shape)} ranks (launch.mesh.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} spans "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layouts: ('data', 'model') = (16, 16) =
    256 devices; two pods add a leading 'pod' axis (DC-S3GD workers = pod
    x data = 32)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small ('data', 'model') mesh over the started process group."""
    return _device_mesh(device_type, (data, model), ("data", "model"))


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def worker_axes(mesh) -> tuple:
    """The DC-S3GD worker axis = every non-'model' mesh axis."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def n_workers(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in worker_axes(mesh))


def make_axes(mesh):
    """The `MeshAxes` contract handed to the per-algorithm sharding hooks."""
    from repro_torch.core.api import MeshAxes
    return MeshAxes(worker=worker_axes(mesh), model="model",
                    model_size=axis_sizes(mesh).get("model", 1))


def coordinate(mesh) -> dict:
    """{axis: this rank's index on it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def worker_index(mesh) -> int:
    """This rank's coordinate on the worker axes, pod-major."""
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    idx = 0
    for a in worker_axes(mesh):
        idx = idx * sizes[a] + coord[a]
    return idx


def worker_group(mesh):
    """The process group of the ranks that share this rank's 'model'
    coordinate: the worker axes, flattened pod-major."""
    axes = worker_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def model_size(mesh) -> int:
    """The size of the 'model' axis (1 for a mesh without one)."""
    return axis_sizes(mesh).get("model", 1)


def model_index(mesh) -> int:
    """This rank's coordinate on the 'model' axis (0 without one)."""
    return coordinate(mesh).get("model", 0)


def model_group(mesh):
    """The process group of the ranks that share this rank's worker
    coordinates (its 'data' / 'pod' indices): the 'model' axis."""
    return mesh.get_group("model")


def model_axis(mesh):
    """The tensor-parallel context over ``mesh``'s 'model' axis."""
    from repro_torch.parallel.tensor import ModelAxis
    return ModelAxis(model_group(mesh), rank=model_index(mesh),
                     size=model_size(mesh))


def holds_rows(mesh) -> bool:
    """Whether this rank lies inside ``mesh`` (a rank outside a mesh that
    `mesh_for_spec` laid over fewer ranks than the world holds no rows)."""
    return mesh.get_coordinate() is not None


def make_workers(mesh):
    """The algorithms' worker seam over ``mesh``'s worker axes, one per
    mesh (so every Engine on the mesh shares it).  On a rank outside the
    mesh the seam holds no rows: it knows the mesh's size and joins no
    group."""
    from repro_torch.core.reduce import ProcessWorkers
    seam = getattr(mesh, "_worker_seam", None)
    if seam is None:
        if holds_rows(mesh):
            seam = ProcessWorkers(worker_group(mesh),
                                  rank=worker_index(mesh),
                                  size=n_workers(mesh),
                                  model=model_size(mesh),
                                  model_rank=model_index(mesh))
        else:
            seam = ProcessWorkers(None, rank=-1, size=n_workers(mesh),
                                  model=model_size(mesh), holds=False)
        mesh._worker_seam = seam
    return seam


def shape_for_spec(spec, *, model: int = 1, n_devices: int
                   ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The mesh shape and axis names that carry a cluster membership
    (`repro_torch.cluster`) on ``n_devices``: a spec spanning several
    pods gets the leading 'pod' axis; the worker product lays over the
    data axis sized to what the devices can carry, the largest divisor
    of the per-pod worker count that the per-pod device share supports.
    Fewer devices than workers is the one-host case: each device then
    carries W / data worker rows."""
    avail = max(n_devices // max(model, 1), 1)
    W = spec.n_workers
    pods = len(spec.pods())
    multi = pods > 1 and W % pods == 0 and avail % pods == 0
    per_pod_workers = W // pods if multi else W
    per_pod_devs = avail // pods if multi else avail
    data = math.gcd(per_pod_workers, per_pod_devs)
    shape = (pods, data, model) if multi else (data, model)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return shape, axes


# the meshes `mesh_for_spec` built, by (default group, device type,
# shape, axes): a membership that comes back reuses its mesh and groups
_MESHES: dict = {}


def mesh_for_spec(spec, *, model: int = 1, device_type: str = "cuda"):
    """The mesh that carries a cluster membership on the started process
    group (the reference's shape arithmetic, `shape_for_spec`), laid over
    the first ``prod(shape)`` ranks of the world in row-major order, as
    the reference lays it over ``devices[:used]``.  The ranks after them
    lie outside the mesh and hold no rows (`holds_rows`).

    Every rank of the world must call this, in the same order: building
    a mesh's groups is collective over the default group.  A mesh is
    built once per world and layout and then reused, groups and worker
    seam with it (8 → 6 → 8 workers builds two meshes, not three).  A
    mesh larger than the world is refused, as the reference's reshape of
    ``devices[:used]`` fails."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape, axes = shape_for_spec(spec, model=model, n_devices=world)
    used = math.prod(shape)
    if used > world:
        raise ValueError(
            f"membership of {spec.n_workers} workers at 'model' = {model} "
            f"lays out as {dict(zip(axes, shape))} = {used} ranks; the "
            f"world has {world}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh for {spec.n_workers} workers needs a started process "
            f"group (launch.mesh.init_process_group)")
    pg = dist.distributed_c10d._get_default_group()
    key = (id(pg), device_type, shape, axes)
    hit = _MESHES.get(key)
    if hit is None or hit[0] is not pg:
        hit = (pg, DeviceMesh(device_type,
                              torch.arange(used).reshape(shape),
                              mesh_dim_names=axes))
        _MESHES[key] = hit
    return hit[1]

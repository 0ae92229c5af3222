"""Partition rules of the port (`repro_torch.parallel.sharding`) against
the reference's, spec for spec: for every arch on both production meshes
the train state's specs through each algorithm's ``state_specs`` hook,
the batch specs, the serving params' and caches' specs, equal the
reference's ``tuple(PartitionSpec)`` leaf for leaf by path.  No process
group and no mesh is built: the hooks take a `MeshAxes`, and the trees
are abstract on both sides (``jax.eval_shape``, fake tensors)."""
import math

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import registry as j_registry
from repro.core.api import MeshAxes as JMeshAxes
from repro.core.types import DCS3GDConfig as JDCS3GDConfig
from repro.core.types import INPUT_SHAPES as J_SHAPES
from repro.launch import specs as JS
from repro.models.transformer import Model as JModel
from repro.parallel import sharding as j_shd

from repro_torch.configs import get_config, reduced
from repro_torch.core import registry
from repro_torch.core.api import MeshAxes
from repro_torch.core.types import DCS3GDConfig, INPUT_SHAPES
from repro_torch.launch import specs as S
from repro_torch.models.transformer import Model
from repro_torch.parallel import sharding as shd

from helpers import ALL_ARCHS
from torch_threads import one_torch_thread  # noqa: F401

MESH = {"data": 16, "model": 16, "pod": 2}
AXES = {False: ("data",), True: ("pod", "data")}


def _jkey(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return getattr(k, a)
    raise ValueError(k)


def _j_flat(specs, tree) -> dict:
    """{path: tuple(spec)} of a reference spec tree along its tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return {tuple(_jkey(k) for k in path): tuple(s)
            for (path, _), s in zip(leaves, sp)}


def _flat(specs, tree) -> dict:
    return dict(shd.flat_specs(specs, tree))


def _axes(multipod):
    return (JMeshAxes(worker=AXES[multipod], model="model", model_size=16),
            MeshAxes(worker=AXES[multipod], model="model", model_size=16))


def _j_bytes(tree, specs) -> int:
    """The reference's per-device bytes of ``tree`` under ``specs``."""
    total = 0
    for (path, leaf), s in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        n = math.prod(leaf.shape)
        for d, ax in zip(leaf.shape, tuple(s)):
            names = () if ax is None else (
                ax if isinstance(ax, tuple) else (ax,))
            n //= math.prod(MESH[a] for a in names)
        total += n * leaf.dtype.itemsize
    return total


def _states(arch, W, make_kw=None, cut=False):
    make_kw = make_kw or {}
    jcfg = JS.dryrun_model_config(j_get_config(arch))
    cfg = S.dryrun_model_config(get_config(arch))
    if cut:
        from repro.configs import reduced as j_reduced
        jcfg, cfg = j_reduced(jcfg), reduced(cfg)
    algo = make_kw.pop("algo", "dc_s3gd")
    jalg = j_registry.make(algo, JDCS3GDConfig(), n_workers=W, **make_kw)
    alg = registry.make(algo, DCS3GDConfig(), n_workers=W, **make_kw)
    jst = JS.abstract_train_state(JModel(jcfg, remat=True), W,
                                  JDCS3GDConfig(), jalg)
    st = S.abstract_train_state(Model(cfg), W, DCS3GDConfig(), alg)
    return (jcfg, jalg, jst), (cfg, alg, st)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("multipod", [False, True])
def test_train_state_specs_match_reference(arch, multipod):
    W = 32 if multipod else 16
    (jcfg, jalg, jst), (cfg, alg, st) = _states(arch, W)
    jaxes, axes = _axes(multipod)
    want = _j_flat(jalg.state_specs(jcfg, jst, jaxes), jst)
    got = _flat(alg.state_specs(cfg, st, axes), st)
    assert got == want
    # the worker axes lead every param leaf
    assert all(s[0] == axes.worker_spec for p, s in got.items()
               if p[0] == "params")


# the other hooks: every algorithm, the bucket plan, the pipeline, the
# staleness policy and the compressed reducers, on the reduced qwen3
HOOKS = {
    "ssgd": {"algo": "ssgd"},
    "stale": {"algo": "stale"},
    "dc_asgd": {"algo": "dc_asgd"},
    "buckets": {"buckets": 4},
    "overlap": {"buckets": 4, "overlap": True},
    "gossip_overlap": {"buckets": 2, "overlap": True, "reducer": "gossip"},
    "dynamic_ssp": {"staleness": "dynamic_ssp"},
    "topk": {"buckets": 4, "reducer": "topk"},
    "randk": {"buckets": 2, "reducer": "randk"},
    "powersgd": {"buckets": 2, "reducer": "powersgd"},
    "ssgd_topk": {"algo": "ssgd", "buckets": 2, "reducer": "topk"},
}


@pytest.mark.parametrize("name", sorted(HOOKS))
@pytest.mark.parametrize("multipod", [False, True])
def test_every_hook_matches_reference(name, multipod):
    W = 32 if multipod else 16
    (jcfg, jalg, jst), (cfg, alg, st) = _states(
        "qwen3-0.6b", W, dict(HOOKS[name]), cut=True)
    jaxes, axes = _axes(multipod)
    want = _j_flat(jalg.state_specs(jcfg, jst, jaxes), jst)
    got = _flat(alg.state_specs(cfg, st, axes), st)
    assert got == want
    batch = S.train_batch_specs(cfg, INPUT_SHAPES["train_4k"], W)
    jbatch = JS.train_batch_specs(jcfg, J_SHAPES["train_4k"], W)
    assert _flat(alg.batch_specs(cfg, batch, axes), batch) == \
        _j_flat(jalg.batch_specs(jcfg, jbatch, jaxes), jbatch)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k",
                                        "long_500k"])
def test_serve_specs_match_reference(arch, shape_name):
    shape, jshape = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
    ok, why = S.supports_shape(get_config(arch), shape)
    assert (ok, why) == JS.supports_shape(j_get_config(arch), jshape)
    if not ok:
        pytest.skip(why)
    jcfg = JS.variant_for_shape(JS.dryrun_model_config(j_get_config(arch)),
                                jshape)
    cfg = S.variant_for_shape(S.dryrun_model_config(get_config(arch)), shape)
    jm, m = JModel(jcfg, remat=False), Model(cfg)
    jp, p = JS.abstract_params(jm), S.abstract_params(m)
    assert _flat(shd.param_specs(cfg, p, model_size=16, worker_axes=None),
                 p) == _j_flat(j_shd.param_specs(
                     jcfg, jp, model_size=16, worker_axes=None), jp)
    da = "data" if shape.global_batch % 16 == 0 else None
    if shape.kind == "decode":
        jc, c = JS.abstract_cache(jm, jshape), S.abstract_cache(m, shape)
        assert {pa: tuple(x.shape) for pa, x in shd.leaves_with_path(c)} \
            == {tuple(_jkey(k) for k in pa): tuple(x.shape) for pa, x in
                jax.tree_util.tree_flatten_with_path(jc)[0]}
        assert _flat(shd.cache_specs(cfg, c, model_size=16, data_axes=da),
                     c) == _j_flat(j_shd.cache_specs(
                         jcfg, jc, model_size=16, data_axes=da), jc)
        batch, jbatch = S.decode_batch_specs(cfg, shape), \
            JS.decode_batch_specs(jcfg, jshape)
    else:
        batch, jbatch = S.prefill_batch_specs(cfg, shape), \
            JS.prefill_batch_specs(jcfg, jshape)
    assert _flat(shd.batch_specs(cfg, batch, data_axes=da), batch) == \
        _j_flat(j_shd.batch_specs(jcfg, jbatch, data_axes=da), jbatch)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_batch_specs_match_reference(arch):
    """The twin of the reference's divisibility test of the batch: equal
    specs, and every sharded dim divides."""
    jcfg = JS.dryrun_model_config(j_get_config(arch))
    cfg = S.dryrun_model_config(get_config(arch))
    alg = registry.make("dc_s3gd", DCS3GDConfig(), n_workers=16)
    jalg = j_registry.make("dc_s3gd", JDCS3GDConfig(), n_workers=16)
    jaxes, axes = _axes(False)
    batch = S.train_batch_specs(cfg, INPUT_SHAPES["train_4k"], 16)
    jbatch = JS.train_batch_specs(jcfg, J_SHAPES["train_4k"], 16)
    got = _flat(alg.batch_specs(cfg, batch, axes), batch)
    assert got == _j_flat(jalg.batch_specs(jcfg, jbatch, jaxes), jbatch)
    for path, spec in got.items():
        shd.local_shape(tuple(batch[path[0]].shape), spec, MESH)


def test_head_padding_only_when_needed():
    for arch in ALL_ARCHS:
        cfg = S.dryrun_model_config(get_config(arch))
        assert cfg == S.dryrun_model_config(get_config(arch))
        assert cfg.pad_heads_to == \
            JS.dryrun_model_config(j_get_config(arch)).pad_heads_to, arch
        if cfg.n_heads:
            assert cfg.eff_n_heads % 16 == 0, arch
            assert cfg.eff_n_heads - cfg.n_heads < 16, arch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-20b"])
def test_per_device_state_bytes_match_reference(arch):
    """The per-device bytes of the abstract train state under its specs
    (pod mesh, W = 16, the dry-run's config) equal the reference's
    spec-derived count, computed here from its own specs."""
    dc = dict(total_steps=10_000, warmup_steps=1_500)
    jcfg = JS.dryrun_model_config(j_get_config(arch))
    cfg = S.dryrun_model_config(get_config(arch))
    jalg = j_registry.make("dc_s3gd", JDCS3GDConfig(**dc), n_workers=16)
    alg = registry.make("dc_s3gd", DCS3GDConfig(**dc), n_workers=16)
    jst = JS.abstract_train_state(JModel(jcfg, remat=True), 16,
                                  JDCS3GDConfig(**dc), jalg)
    st = S.abstract_train_state(Model(cfg), 16, DCS3GDConfig(**dc), alg)
    jaxes, axes = _axes(False)
    want = _j_bytes(jst, jalg.state_specs(jcfg, jst, jaxes))
    got = shd.shard_bytes(st, alg.state_specs(cfg, st, axes),
                          {"data": 16, "model": 16})
    assert got == want
    if arch == "qwen3-0.6b":
        assert got == 1_021_050_884


class _FakeMesh:
    """Shape-only mesh stand-in (the validator reads names and sizes)."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def test_validate_worker_count_errors_are_clear():
    """The twin of the reference's test: the same numbers in the
    message."""
    with pytest.raises(ValueError) as e:
        shd.validate_worker_count(6, _FakeMesh(data=4, model=1))
    with pytest.raises(ValueError) as je:
        j_shd.validate_worker_count(6, _FakeMesh(data=4, model=1))
    msg = str(e.value)
    assert "n_workers=6" in msg and "4" in msg and "data" in msg
    assert msg.split(" (")[0] == str(je.value).split(" (")[0]
    shd.validate_worker_count(8, _FakeMesh(data=4, model=1))
    shd.validate_worker_count(6, None)
    shd.validate_worker_count(None, _FakeMesh(data=4, model=1))
    shd.validate_worker_count(6, _FakeMesh(pod=2, data=3, model=2))


def test_placements_local_shapes_and_pod_major_slices():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh(pod=2, data=16, model=16)
    spec = (("pod", "data"), None, "model")
    assert shd.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None,), mesh) == [Replicate()] * 3
    sizes = shd.mesh_shape(mesh)
    assert shd.local_shape((64, 3, 32), spec, sizes) == (2, 3, 2)
    sl = shd.local_slices((64, 3, 32), spec, sizes,
                          {"pod": 1, "data": 5, "model": 3})
    # pod-major: block 1 * 16 + 5 of 32 along dim 0
    assert sl == (slice(42, 44), slice(0, 3), slice(6, 8))
    with pytest.raises(ValueError, match="does not divide"):
        shd.local_shape((30, 3, 32), spec, sizes)

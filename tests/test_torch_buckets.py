"""Port parity for flat-buffer bucketing: the port's `plan_buckets` gives
exactly the reference's layout (slot order, offsets, bucket sizes, decay
flags) on the reduced model tree, and pack/unpack round-trips bitwise."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.transformer import Model as JModel
from repro.parallel import buckets as JB
from repro_torch import tree as T
from repro_torch.interop import params_from_numpy
from repro_torch.parallel import buckets as B


def _jax_tree():
    params = JModel(reduced(get_config("qwen3-0.6b")), remat=False).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _layout(plan):
    slots = [(s.bucket, s.offset, s.size, tuple(s.shape)) for s in plan.slots]
    return slots, tuple(plan.bucket_sizes), tuple(plan.bucket_decay)


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 8])
def test_plan_matches_reference(n_buckets):
    np_tree = _jax_tree()
    jplan = JB.plan_buckets(np_tree, n_buckets)
    tplan = B.plan_buckets(params_from_numpy(np_tree, device="cpu"),
                           n_buckets)
    assert _layout(tplan) == _layout(jplan)
    assert B.BLOCK == JB.K.BLOCK


def test_full_width_plan_matches_reference_at_four_layers():
    """The main path's plan (qwen3-0.6b, published widths, 4 layers, 4
    buckets), from shapes alone: the reference on abstract leaves, the
    port on meta tensors of the same shapes.  Only the last bucket
    (final_norm) skips decay."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4)
    abstract = jax.eval_shape(JModel(cfg, remat=False).init,
                              jax.random.PRNGKey(0))
    jplan = JB.plan_buckets(abstract, 4)
    meta = T.map(lambda s: torch.empty(s.shape, device="meta"), abstract)
    tplan = B.plan_buckets(meta, 4)
    assert _layout(tplan) == _layout(jplan)
    assert tplan.bucket_sizes == (155_713_536, 62_947_328, 155_713_536,
                                  32_768)
    assert tplan.bucket_decay == (True, True, True, False)
    assert sum(s.size for s in tplan.slots) == 374_351_872


def test_pack_unpack_round_trip_bitwise_with_worker_axis():
    tree = params_from_numpy(_jax_tree(), device="cpu")
    plan = B.plan_buckets(tree, 3)
    stacked = T.map(lambda x: torch.stack([x * (i + 1) for i in range(4)]),
                    tree)
    packed = plan.pack(stacked)
    assert [tuple(b.shape) for b in packed] == \
        [(4, n) for n in plan.bucket_sizes]
    back = plan.unpack(packed)
    for a, b in zip(T.leaves(stacked), T.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # padding is zeros
    for b, buf in enumerate(packed):
        used = sum(s.size for s in plan.slots if s.bucket == b)
        assert not buf[:, used:].any()


def test_pack_matches_reference_pack_bitwise():
    np_tree = _jax_tree()
    jpacked = JB.plan_buckets(np_tree, 2).pack(
        jax.tree.map(jax.numpy.asarray, np_tree))
    tpacked = B.plan_buckets(params_from_numpy(np_tree, device="cpu"),
                             2).pack(params_from_numpy(np_tree, device="cpu"))
    for a, b in zip(jpacked, tpacked):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_tree_flattens_in_sorted_key_order_like_jax():
    tree = {"b": 1, "a": 2, "stage0": {"z": 3, "c": [4, 5]}}
    assert T.leaves(tree) == jax.tree.leaves(tree)
    leaves, td = T.flatten(tree)
    assert T.unflatten(td, leaves) == tree


def test_cached_plan_is_memoized_on_layout():
    tree = params_from_numpy(_jax_tree(), device="cpu")
    cache = {}
    a = B.cached_plan(cache, tree, 2)
    assert B.cached_plan(cache, tree, 2) is a
    assert _layout(a) == _layout(B.plan_buckets(tree, 2))
    # same shapes and dtypes, other values: the same plan
    assert B.cached_plan(cache, T.map(torch.zeros_like, tree), 2) is a
    b = B.cached_plan(cache, tree, 3)
    stacked = T.map(lambda x: torch.stack([x, x]), tree)
    c = B.cached_plan(cache, stacked, 2, strip_leading_axis=True)
    assert len(cache) == 3 and b is not a and _layout(c) == _layout(a)


@pytest.mark.parametrize("algo", ["dc_s3gd", "ssgd"])
def test_dropped_state_is_freed_without_the_cycle_collector(algo):
    """Tree ops and a training step leave no reference cycle around
    tensors: with Python's cyclic collector off, a state that is dropped
    is freed at once (a cycle would keep model-sized buffers alive until
    the collector happens to run, and so raise peak device memory)."""
    import gc
    import weakref
    from repro_torch.core import registry
    from repro_torch.core.types import DCS3GDConfig

    def loss_fn(p, b):
        return ((b["x"] @ p["w"]) ** 2).mean() + p["b"].square().sum()

    batch = {"x": torch.ones(2, 5, 4)}
    alg = registry.make(algo, DCS3GDConfig(), n_workers=2, buckets=1,
                        reducer="topk", use_kernels=True)
    gc.collect()
    gc.disable()
    try:
        state = alg.init({"b": torch.ones(3), "w": torch.ones(4, 3)})
        for _ in range(2):
            old = [weakref.ref(x) for x in T.leaves(state)
                   if isinstance(x, torch.Tensor)]
            state, _ = alg.step(state, batch, loss_fn=loss_fn)
            assert old and all(r() is None for r in old), algo
    finally:
        gc.enable()

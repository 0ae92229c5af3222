"""Port parity for the rest of training: the local optimizers (Nesterov,
LARS, Adam), per-tensor λ, the DC-ASGD simulator, dynamic SSP (its
counters, a revoked step, the measured-skew loop), the weight-mixing
reducers (gossip, hierarchical), the registries and the twin of
``benchmarks/table1_convergence.py`` — each against the JAX reference on
the same numpy inputs and carried-over weights.

Model: the reduced ResNet of ``examples/cnn_paper_repro.py`` (stages
(1, 1), width 8, 8 classes, 16 x 16 images), W = 4, 16 images per
worker, 5 steps.  Tolerances, f32 throughout, as in
``tests/test_torch_cnn.py``: the final weights ``assert_allclose(rtol=
1e-5, atol=1e-4 x the leaf's largest update)``, ``opt`` slots and carried
state ``atol = 1e-4 x`` the leaf's largest magnitude (rtol 1e-5), metrics
rtol 1e-5; single updates and reducer outputs rtol 1e-6 / atol 1e-7
(one f32 rounding apart at most).  The per-tensor λ and Adam
trajectories are ill-conditioned in the reference itself and are held to
the reference's own move under a one-ulp nudge of the weights where that
is larger (``test_dc_s3gd_variants_match_jax``).

LARS: the port takes the trust ratio's norms per worker; the reference's
``lars_update`` under ``axis0_is_worker=True`` takes them over the whole
(W, ...)-stacked leaf, mixing every worker's norms.  The port is held to
the reference applied per worker (``jax.vmap`` over axis 0), and
``test_reference_lars_stacked_norms_mix_workers`` records how far the
reference's stacked call lands from it.
"""
import functools
import importlib.util
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as j_compress
from repro.core import reduce as j_reduce
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticImageDataset as JImages
from repro.data import worker_batches as j_worker_batches
from repro.launch.engine import Engine as JEngine
from repro.models import cnn as J
from repro.optim import local as j_local
from repro_torch import tree as T
from repro_torch.benchmarks import table1_convergence as t_table1
from repro_torch.core import reduce as t_reduce
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.interop import (params_from_numpy, reducer_state_to_numpy,
                                 staleness_counters)
from repro_torch.launch.engine import Engine as TEngine
from repro_torch.models import cnn as C
from repro_torch.optim import local as t_local

ROOT = Path(__file__).resolve().parents[1]
W, STEPS, BPW = 4, 5, 16
NET = dict(stages=(1, 1), width=8, n_classes=8)
HP = dict(learning_rate=0.2, momentum=0.9, lambda0=0.2, weight_decay=1e-4,
          warmup_steps=1, total_steps=STEPS)
METRICS = ("loss", "lambda", "distance_norm", "delta_norm", "ssp_admit",
           "staleness_dist")
KINDS = ("ALGORITHM", "LOCAL_OPTIMIZER", "REDUCER", "COMPENSATOR",
         "STALENESS_POLICY")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one CPU thread while this module runs: its convolutions
    are small, and the suite runs several worker processes at once, where
    every process's own thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights():
    return jax.tree.map(np.asarray,
                        J.init_resnet(jax.random.PRNGKey(0), **NET))


def _close(a, b, rtol=1e-6, atol=1e-7, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


# --- registries -----------------------------------------------------------


def test_registries_hold_the_reference_names_kind_by_kind():
    for kind in KINDS:
        ours = treg.names(getattr(treg, kind))
        assert ours == jreg.names(getattr(jreg, kind)), kind
    assert sum(len(treg.names(getattr(treg, k))) for k in KINDS) == 19


def test_unknown_names_raise_key_errors_naming_them():
    with pytest.raises(KeyError, match="nope"):
        treg.make("nope", TConfig())
    with pytest.raises(KeyError, match="ring_allreduce"):
        treg.make_reducer("ring_allreduce")


# --- local optimizers, one update ----------------------------------------


def _opt_inputs(seed=0, workers=3):
    """A worker-stacked tree with a 0-d, a rank-1 and a rank-2 leaf per
    worker (decay only on the last)."""
    rng = np.random.default_rng(seed)

    def tree(scale=1.0):
        return {"s": (scale * rng.standard_normal((workers,))
                      ).astype(np.float32),
                "v": (scale * rng.standard_normal((workers, 5))
                      ).astype(np.float32),
                "w": (scale * rng.standard_normal((workers, 4, 3))
                      ).astype(np.float32)}
    return tree(), tree(0.1), tree(0.01), tree(1e-4)


def _t(tree):
    return params_from_numpy(tree, device="cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(ours, theirs, **kw):
    for a, b in zip(T.leaves(ours), jax.tree.leaves(theirs)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.numpy(), b, **kw)


SCHED = dict(lr=0.05, weight_decay=2.3e-4)


@pytest.mark.parametrize("name", ["nesterov", "adam"])
def test_one_update_matches_reference(name):
    p, g, m, v = _opt_inputs()
    if name == "nesterov":
        want = j_local.momentum_update(_j(g), {"m": _j(m)}, _j(p),
                                       momentum=0.9, nesterov=True,
                                       axis0_is_worker=True, **SCHED)
        got = t_local.momentum_update(_t(g), {"m": _t(m)}, _t(p),
                                      momentum=0.9, nesterov=True,
                                      axis0_is_worker=True, **SCHED)
        opt = treg.make_local_optimizer("nesterov", TConfig())
        assert opt.nesterov and opt.name == "nesterov"
    else:
        t = np.int32(2)
        want = j_local.adam_update(
            _j(g), {"m": _j(m), "v": jax.tree.map(jnp.abs, _j(v)),
                    "t": jnp.int32(t)}, _j(p), axis0_is_worker=True, **SCHED)
        got = t_local.adam_update(
            _t(g), {"m": _t(m), "v": T.map(torch.abs, _t(v)),
                    "t": torch.tensor(t)}, _t(p), axis0_is_worker=True,
            **SCHED)
        assert int(got[1]["t"]) == int(want[1]["t"]) == 3
        assert got[1]["t"].dtype == torch.int32
    _assert_tree_close(got[0], want[0])
    for k in ("m", "v") if name == "adam" else ("m",):
        _assert_tree_close(got[1][k], want[1][k])


def test_lars_matches_reference_per_worker():
    p, g, m, _ = _opt_inputs(1)

    def ref_one(g_i, m_i, p_i):
        return j_local.lars_update(g_i, {"m": m_i}, p_i, momentum=0.9,
                                   trust=0.001, axis0_is_worker=False,
                                   **SCHED)
    want_d, want_s = jax.vmap(ref_one)(_j(g), _j(m), _j(p))
    got_d, got_s = t_local.lars_update(_t(g), {"m": _t(m)}, _t(p),
                                       momentum=0.9, trust=0.001,
                                       axis0_is_worker=True, **SCHED)
    _assert_tree_close(got_d, want_d)
    _assert_tree_close(got_s["m"], want_s["m"])
    # unstacked (SSGD's canonical tree): the reference's own call
    want = j_local.lars_update(jax.tree.map(lambda x: x[0], _j(g)),
                               {"m": jax.tree.map(lambda x: x[0], _j(m))},
                               jax.tree.map(lambda x: x[0], _j(p)),
                               momentum=0.9, **SCHED)
    got = t_local.lars_update(T.map(lambda x: x[0], _t(g)),
                              {"m": T.map(lambda x: x[0], _t(m))},
                              T.map(lambda x: x[0], _t(p)), momentum=0.9,
                              **SCHED)
    _assert_tree_close(got[0], want[0])


def test_reference_lars_stacked_norms_mix_workers():
    """Recorded reference caveat: its stacked call takes one trust ratio
    for all workers, so it is not the per-worker update the port (and a
    decentralised worker) computes.  Worker 0's 'w' leaf moves by a
    different amount there."""
    p, g, m, _ = _opt_inputs(1)
    stacked, _ = j_local.lars_update(_j(g), {"m": _j(m)}, _j(p),
                                     momentum=0.9, axis0_is_worker=True,
                                     **SCHED)
    ours, _ = t_local.lars_update(_t(g), {"m": _t(m)}, _t(p), momentum=0.9,
                                  axis0_is_worker=True, **SCHED)
    a, b = ours["w"].numpy(), np.asarray(stacked["w"])
    rel = float(np.abs(a - b).max() / np.abs(a).max())
    assert rel > 1e-2, f"stacked and per-worker LARS agree ({rel:.3g})"


# --- trajectories -----------------------------------------------------------


def _data():
    return (JImages(8, image_size=16, seed=0, noise=0.4),
            SyntheticImageDataset(8, image_size=16, seed=0, noise=0.4))


def _jax_steps(alg, state, steps=STEPS, hook=None):
    step = jax.jit(functools.partial(alg.step,
                                     loss_fn=J.cnn_loss_fn(J.resnet_apply)))
    data, history = _data()[0], []
    for t in range(steps):
        if hook is not None:
            state = hook(alg, state, t)
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return state, history


def _torch_steps(alg, state, steps=STEPS, hook=None):
    data, history = _data()[1], []
    loss_fn = C.cnn_loss_fn(C.resnet_apply)
    for t in range(steps):
        if hook is not None:
            state = hook(alg, state, t)
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=loss_fn)
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return state, history


def _nudge(tree):
    """Every weight one ulp up."""
    return jax.tree.map(lambda x: np.nextafter(x, np.float32(np.inf)),
                        tree)


@functools.lru_cache(maxsize=None)
def _spread_weights():
    """Per-worker weights (W, ...): the init plus 1e-2 x a per-worker
    standard normal draw (numpy, seed 5)."""
    rng = np.random.default_rng(5)
    return jax.tree.map(
        lambda p: (p[None] + 1e-2 * rng.standard_normal((W,) + p.shape))
        .astype(np.float32), _weights())


@functools.lru_cache(maxsize=None)
def _jax_run(algo, buckets=0, kernels=False, hp=(), hook=None,
             nudged=False, spread=False, **make):
    cfg = JConfig(**HP, **dict(hp))
    alg = jreg.make(algo, cfg, n_workers=W, buckets=buckets,
                    use_kernels=kernels, **make)
    w = _nudge(_weights()) if nudged else _weights()
    state = alg.init(jax.tree.map(jnp.asarray, w))
    if spread:
        state = state._replace(params=jax.tree.map(jnp.asarray,
                                                   _spread_weights()))
    state, hist = _jax_steps(alg, state, hook=hook)
    return jax.tree.map(np.asarray, state), hist


def _torch_run(algo, buckets=0, kernels=False, hp=(), hook=None,
               spread=False, **make):
    cfg = TConfig(**HP, **dict(hp))
    alg = treg.make(algo, cfg, n_workers=W, buckets=buckets,
                    use_kernels=kernels, **make)
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    if spread:
        state = state._replace(params=params_from_numpy(_spread_weights(),
                                                        device="cpu"))
    state, hist = _torch_steps(alg, state, hook=hook)
    return alg, state, hist


def _assert_run_close(t_state, t_hist, j_state, j_hist, w0=None,
                      nudged=None):
    """``nudged``: the reference's own run from weights one ulp away;
    where the reference moves further than the tolerance under that
    nudge, a leaf (metric) is held to twice the reference's own move."""
    w0 = _weights() if w0 is None else w0
    j2 = jax.tree.leaves(nudged[0].params) if nudged else \
        jax.tree.leaves(j_state.params)
    for x, y, z, y2 in zip(T.leaves(t_state.params),
                           jax.tree.leaves(j_state.params),
                           jax.tree.leaves(w0), j2):
        y = np.asarray(y)
        own = 2 * float(np.abs(y - np.asarray(y2)).max())
        np.testing.assert_allclose(
            x.numpy(), y, rtol=1e-5,
            atol=max(1e-4 * float(np.abs(y - z).max()), own),
            err_msg="params")
    ref2 = nudged[0] if nudged else j_state
    carried = [(t_state.opt, j_state.opt, ref2.opt, "opt")]
    for key in ("delta_prev", "worker_params"):
        if key in j_state.comm:
            carried.append((t_state.comm[key], j_state.comm[key],
                            ref2.comm[key], key))
    for ours, theirs, theirs2, what in carried:
        for x, y, y2 in zip(T.leaves(ours), jax.tree.leaves(theirs),
                            jax.tree.leaves(theirs2)):
            y = np.asarray(y)
            own = 2 * float(np.abs(y - np.asarray(y2)).max())
            np.testing.assert_allclose(
                x.numpy(), y, rtol=1e-5,
                atol=max(1e-4 * float(np.abs(y).max()), own), err_msg=what)
    assert len(t_hist) == len(j_hist)
    for i, (th, jh) in enumerate(zip(t_hist, j_hist)):
        assert set(th) == set(jh)
        for k in jh:
            own = 2 * abs(jh[k] - nudged[1][i][k]) if nudged else 0.0
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5,
                                       atol=max(1e-7, own), err_msg=k)


@pytest.mark.parametrize("buckets", [0, 2])
@pytest.mark.parametrize("variant", [
    ("local_optimizer", "nesterov"), ("local_optimizer", "adam"),
    ("lambda_norm", "per_tensor")])
def test_dc_s3gd_variants_match_jax(variant, buckets):
    """Per-tensor λ and Adam are ill-conditioned here in the reference
    itself.  Per-tensor λ: a leaf whose ‖g²D‖ is tiny gets λ ~ 1e9, and
    from step 3 the stem's update follows the last bits of D; the
    reference run from weights one ulp away moves the stem by 3.96e-5 (1.1e-3
    of its update), and the port lands 3.96e-5 from the reference.  Adam:
    m̂/(√v̂ + ε) turns a gradient coordinate at rounding level into a step
    of ±lr; under the nudge the reference moves one element of the stem's
    delta_prev by 6.34e-6, the port lands 6.37e-6 away.  So these two are
    held, leaf by leaf and metric by metric, to the larger of the
    tolerance and twice the reference's own move under the nudge."""
    key, value = variant
    kw = dict(hp=((key, value),)) if key == "lambda_norm" \
        else {key: value}
    j_state, j_hist = _jax_run("dc_s3gd", buckets, **kw)
    _, t_state, t_hist = _torch_run("dc_s3gd", buckets, **kw)
    nudged = _jax_run("dc_s3gd", buckets, nudged=True, **kw) \
        if value in ("per_tensor", "adam") else None
    _assert_run_close(t_state, t_hist, j_state, j_hist, nudged=nudged)
    assert t_hist[-1]["lambda"] > 0
    if value == "adam":
        assert int(t_state.opt["t"]) == STEPS
        assert t_state.opt["t"].dtype == torch.int32


def test_ssgd_with_lars_matches_jax():
    """SSGD's tree has no worker axis, so LARS's norms are the same
    quantity in both packages."""
    j_state, j_hist = _jax_run("ssgd", local_optimizer="lars")
    _, t_state, t_hist = _torch_run("ssgd", local_optimizer="lars")
    lead = functools.partial(jax.tree.map, lambda x: x[None])
    _assert_run_close(
        t_state._replace(params=T.map(lambda x: x[None], t_state.params)),
        t_hist, j_state._replace(params=lead(j_state.params)), j_hist,
        w0=lead(_weights()))


def test_fused_tail_keeps_the_reference_restriction():
    alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=W, use_kernels=True,
                    local_optimizer="adam")
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    with pytest.raises(ValueError, match="momentum"):
        _torch_steps(alg, state, steps=1)


def test_dc_asgd_matches_jax_over_2w_transactions():
    steps = 2 * W
    cfg = JConfig(**HP)
    j_alg = jreg.make("dc_asgd", cfg, n_workers=W)
    j_state, j_hist = _jax_steps(j_alg, j_alg.init(jax.tree.map(
        jnp.asarray, _weights())), steps=steps)
    t_alg = treg.make("dc_asgd", TConfig(**HP), n_workers=W)
    t_state, t_hist = _torch_steps(t_alg, t_alg.init(params_from_numpy(
        _weights(), device="cpu")), steps=steps)
    j_state = jax.tree.map(np.asarray, j_state)
    assert t_state.step == steps
    _assert_run_close(t_state, t_hist, j_state, j_hist)
    assert set(t_hist[0]) == {"loss", "lambda", "staleness_dist"}
    assert t_hist[0]["lambda"] == 0.0 and t_hist[-1]["lambda"] > 0
    # every worker has received the PS copy once: all are stale by < W
    assert all(h["staleness_dist"] > 0 for h in t_hist)


# --- dynamic SSP ----------------------------------------------------------


def test_dynamic_ssp_counters_match_reference():
    cfg = TConfig(ssp_threshold=2)
    ours = treg.make_staleness_policy("dynamic_ssp", cfg)
    theirs = jreg.make_staleness_policy("dynamic_ssp",
                                        JConfig(ssp_threshold=2))
    assert ours.threshold == theirs.threshold == 2
    assert treg.make_staleness_policy("dynamic_ssp").threshold == 4
    po, pt = ours.init(W), theirs.init(W)
    np.testing.assert_array_equal(po["worker_steps"],
                                  staleness_counters(pt)["worker_steps"])
    for observed in ([0, 0, 0, 0], [3, 1, 2, 2], [5, 1, 2, 2], [4, 4, 4, 4]):
        po = ours.observe(po, observed)
        pt = theirs.observe(pt, observed)
        ok_o, po = ours.admit(po)
        ok_t, pt = theirs.admit(pt)
        assert ok_o == bool(ok_t)
        assert isinstance(po["worker_steps"], np.ndarray)
        assert po["worker_steps"].dtype == np.int32
        np.testing.assert_array_equal(
            po["worker_steps"], staleness_counters(pt)["worker_steps"])
    for n_new in (2, 6):
        np.testing.assert_array_equal(
            ours.resize(po, n_new)["worker_steps"],
            staleness_counters(theirs.resize(pt, n_new))["worker_steps"])
    fixed = treg.make_staleness_policy("fixed")
    assert fixed.admit({}) == (True, {}) and fixed.stateless


def _skew_hook(alg, state, t):
    """Before step 2, report worker 2 five steps ahead: the window is
    revoked for that step and re-opens after (both packages' algorithms
    have ``observe_progress``)."""
    if t == 2:
        return alg.observe_progress(state, [2, 2, 7, 2])
    return state



@pytest.mark.parametrize("form", [(0, False), (2, True)])
def test_revoked_step_matches_jax(form):
    buckets, kernels = form
    kw = dict(hook=_skew_hook, staleness="dynamic_ssp")
    j_state, j_hist = _jax_run("dc_s3gd", buckets, kernels, **kw)
    _, t_state, t_hist = _torch_run("dc_s3gd", buckets, kernels, **kw)
    assert [h["ssp_admit"] for h in t_hist] == [1.0, 1.0, 0.0, 1.0, 1.0]
    _assert_run_close(t_state, t_hist, j_state, j_hist)
    np.testing.assert_array_equal(
        t_state.comm["staleness"]["worker_steps"],
        staleness_counters(j_state.comm["staleness"])["worker_steps"])
    assert t_state.comm["staleness"]["worker_steps"].tolist() == [10] * W


def test_revoke_returns_the_topk_payload_to_the_residual():
    """A revoked window with the topk wire: the residual after the step is
    the whole accumulated payload (carried delta + old residual), bitwise
    the reference's ``revoke`` on the same numpy inputs."""
    cfg = TConfig(**HP, compress_density=0.05)
    alg = treg.make("dc_s3gd", cfg, n_workers=W, buckets=2, reducer="topk",
                    staleness="dynamic_ssp")
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    state, _ = _torch_steps(alg, state, steps=3)
    before = state
    state = alg.observe_progress(state, [0, 9, 0, 0])
    state, m = _torch_steps(alg, state, steps=1)
    assert m[0]["ssp_admit"] == 0.0
    wire, res = before.comm["delta_prev"], before.comm["reducer"]["residual"]
    for new, d, r in zip(state.comm["reducer"]["residual"], wire, res):
        assert torch.equal(new, d.float() + r)
        assert new.any()
    ref = j_compress.TopKReduce(JConfig(compress_density=0.05)).revoke(
        [jnp.asarray(d.numpy()) for d in wire],
        {"residual": [jnp.asarray(r.numpy()) for r in res]},
        reducer_state_to_numpy(before.comm["reducer"]))
    for new, r in zip(state.comm["reducer"]["residual"], ref["residual"]):
        np.testing.assert_array_equal(new.numpy(), np.asarray(r))


def test_engine_measure_skew_trips_dynamic_ssp_as_the_reference():
    """The same per-worker durations drive both Engines' virtual clocks:
    worker 2 runs at a third of the speed from step 1 (step 0 is the
    warm-up), so the skew passes the threshold and the window is revoked
    on the same steps, the clocks collapsing to the leader each time."""
    def probe(it, dt):
        return [1.0, 1.0, 3.0, 1.0]

    steps, hp = 6, dict(HP, total_steps=6, ssp_threshold=3)
    loss_j, loss_t = (J.cnn_loss_fn(J.resnet_apply),
                      C.cnn_loss_fn(C.resnet_apply))
    j_alg = jreg.make("dc_s3gd", JConfig(**hp), n_workers=W,
                      staleness="dynamic_ssp")
    j_data, t_data = _data()
    _, j_hist, _ = JEngine(types.SimpleNamespace(loss=loss_j), j_alg).fit(
        j_alg.init(jax.tree.map(jnp.asarray, _weights())),
        lambda it: j_worker_batches(j_data, it, W, BPW), steps=steps,
        log_every=1, verbose=False, measure_skew=True, skew_probe=probe)
    t_alg = treg.make("dc_s3gd", TConfig(**hp), n_workers=W,
                      staleness="dynamic_ssp")
    _, t_hist, _ = TEngine(types.SimpleNamespace(loss=loss_t), t_alg).fit(
        t_alg.init(params_from_numpy(_weights(), device="cpu")),
        lambda it: t_worker_batches(t_data, it, W, BPW, device="cpu"),
        steps=steps, log_every=1, measure_skew=True, skew_probe=probe)
    for key in ("ssp_admit", "measured_skew"):
        assert [h[key] for h in t_hist] == [h[key] for h in j_hist], key
    assert 0.0 in [h["ssp_admit"] for h in t_hist]
    for th, jh in zip(t_hist, j_hist):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)


# --- weight-mixing reducers ---------------------------------------------


def _wire_tree(workers, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((workers, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((workers, 7)).astype(np.float32)}


@pytest.mark.parametrize("wire", ["float32", "int8"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("workers", [2, 4, 8])
def test_gossip_matches_reference(workers, k, wire):
    x = _wire_tree(workers, workers + k)
    ours = t_reduce.GossipReduce(comm_dtype=wire, neighbors=k)
    theirs = j_reduce.GossipReduce(comm_dtype=wire, neighbors=k)
    got, want = ours(_t(x)), theirs(_j(x))
    _assert_tree_close(got, want)
    assert ours.hparams == theirs.hparams and ours.reduces_weights
    assert ours.wire_bytes([30, 7]) == theirs.wire_bytes([30, 7])
    if workers == 2 and wire == "float32":
        # offsets alias (left == right): the exact 2-worker mean, no
        # neighbour counted twice
        for leaf in T.leaves(got):
            torch.testing.assert_close(leaf[0], leaf[1], rtol=0, atol=0)
        np.testing.assert_allclose(got["b"][0].numpy(),
                                   (x["b"][0] + x["b"][1]) / 2, rtol=1e-7)


@pytest.mark.parametrize("wire", ["float32", "int8"])
@pytest.mark.parametrize("workers,groups", [(4, 2), (8, 2), (8, 4)])
def test_hierarchical_matches_reference(workers, groups, wire):
    x = _wire_tree(workers, groups)
    ours = t_reduce.HierarchicalReduce(comm_dtype=wire, groups=groups)
    theirs = j_reduce.HierarchicalReduce(comm_dtype=wire, groups=groups)
    _assert_tree_close(ours(_t(x)), theirs(_j(x)))
    assert ours.hparams == theirs.hparams and ours.reduces_weights
    assert ours.wire_bytes([30, 7]) == theirs.wire_bytes([30, 7])
    with pytest.raises(ValueError, match="groups"):
        ours(_t(_wire_tree(groups + 1)))


@pytest.mark.parametrize("form", [(0, False), (2, True)])
@pytest.mark.parametrize("reducer", ["gossip", "hierarchical"])
def test_weight_mixing_trajectories_match_jax(reducer, form):
    """From per-worker weights 1e-2 apart, so that D = R(w) − w is a real
    distance.  (From equal workers, gossip at W = 4 mixes three equal rows
    into (3w)/3, which f32 does not round back to w: D starts as rounding
    noise, Eq. 17 scales the correction to λ0‖g‖ whatever D's size, and
    the reference run from weights one ulp away already moves the stem by
    3.9e-3 — a reference caveat, recorded in ROADMAP queue C.)"""
    buckets, kernels = form
    j_state, j_hist = _jax_run("dc_s3gd", buckets, kernels, spread=True,
                               reducer=reducer)
    _, t_state, t_hist = _torch_run("dc_s3gd", buckets, kernels,
                                    spread=True, reducer=reducer)
    assert "delta_prev" not in t_state.comm and t_state.comm == {}
    _assert_run_close(t_state, t_hist, j_state, j_hist,
                      w0=_spread_weights())
    assert t_hist[-1]["distance_norm"] > 0 and t_hist[-1]["lambda"] > 0


def test_weight_mixing_bucketed_is_bitwise_per_leaf():
    _, s0, h0 = _torch_run("dc_s3gd", 0, reducer="gossip")
    _, s1, h1 = _torch_run("dc_s3gd", 2, reducer="gossip")
    for a, b in zip(T.leaves(s0.params), T.leaves(s1.params)):
        assert torch.equal(a, b)
    assert h0 == h1


# --- the table1 twin ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_table1():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "_jax_table1", ROOT / "benchmarks" / "table1_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("algo", ["ssgd", "stale", "dc_s3gd"])
def test_table1_twin_matches_the_reference_benchmark(algo):
    j_loss, j_err = _jax_table1().run_cnn(algo, steps=4)
    loss, err = t_table1.run_cnn(algo, steps=4, device="cpu",
                                 params=_weights())
    assert abs(loss - j_loss) <= 1e-4, (loss, j_loss)
    assert abs(err - j_err) <= 1 / 256 + 1e-7, (err, j_err)


def test_table1_twin_prints_the_reference_rows(capsys):
    rows = t_table1.main(types.SimpleNamespace(steps=4, device="cpu"))
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("table1_")]
    assert [r[0] for r in rows] == ["ssgd", "stale", "dc_s3gd"]
    assert [ln.split(",")[0] for ln in out] == [
        "table1_resnet_ssgd", "table1_resnet_stale", "table1_resnet_dc_s3gd",
        "table1_claim_dc_recovers_ssgd"]
    for ln, (_, loss, err) in zip(out, rows):
        assert ln.split(",", 2)[2] == f"final_loss={loss:.4f};top1_err=" \
            f"{err:.3f}" and math.isfinite(loss)

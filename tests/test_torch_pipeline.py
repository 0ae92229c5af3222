"""The double-buffered bucket pipeline (`repro_torch.parallel.pipeline`,
``overlap=True``) against the inline schedule within the port and against
the reference's pipeline.

Within the port, bitwise: overlap == inline in params, ``opt["m"]``,
``delta_prev`` and every loss, for every reducer (the fused tail too, and
dynamic SSP with a stateless reducer through a revoked window); gossip
included, which the reference holds only to allclose (atol 1e-6: XLA may
fuse its weighted sum's last multiply differently at another program
position; eager PyTorch runs the same kernels either way).  The reducer
state runs one call ahead of the inline layout: overlap after N steps is
bitwise inline after N + 1.

Against the reference (the numpy least-squares probe of
``tests/torch_problems.py``, W = 4, 2 buckets, 5 steps): the final params
rtol 1e-5 / atol 1e-6, metrics rtol 1e-5 (the probe's tolerances in
``tests/test_torch_dc_s3gd.py``); the landed buffers rtol 1e-5 / atol
1e-6 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_problems as P
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro_torch import tree as T
from repro_torch.cluster import rebuild_algorithm
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.parallel import pipeline as PL

HP = dict(learning_rate=0.1, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1, compress_density=1e-3)
W, STEPS = 4, 5
REDUCERS = ["mean_allreduce", "topk", "topk_exact", "randk", "powersgd",
            "gossip", "hierarchical"]
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


def _run(algo="dc_s3gd", steps=STEPS, n_workers=W, skew=None, **kw):
    """The port on the probe; ``skew`` maps a step to the per-worker
    progress fed in after it (a revoked window for dynamic SSP)."""
    alg = treg.make(algo, TConfig(**HP), n_workers=n_workers, **kw)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    history = []
    for t in range(steps):
        state, m = alg.step(state, P.t_batch(t, n_workers),
                            loss_fn=P.t_loss)
        history.append({k: float(v) for k, v in m.items()})
        if skew and t in skew:
            state = alg.observe_progress(state, skew[t])
    return alg, state, history


def _assert_same_run(a, b):
    (_, s0, h0), (_, s1, h1) = a, b
    assert P.bitwise(s0.params, s1.params)
    assert P.bitwise(s0.opt, s1.opt)
    if "delta_prev" in s0.comm:
        assert P.bitwise(s0.comm["delta_prev"], s1.comm["delta_prev"])
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]


# --- overlap == inline, bitwise within the port ----------------------------


@pytest.mark.parametrize("algo", ["dc_s3gd", "stale"])
@pytest.mark.parametrize("reducer", REDUCERS)
def test_overlap_bitwise_matches_inline(algo, reducer):
    inline = _run(algo, reducer=reducer, buckets=2)
    piped = _run(algo, reducer=reducer, buckets=2, overlap=True)
    _assert_same_run(inline, piped)
    if "reducer" in inline[1].comm:
        # the reducer-state chain runs one call ahead of the inline layout
        ahead = _run(algo, reducer=reducer, buckets=2, steps=STEPS + 1)
        assert P.bitwise(ahead[1].comm["reducer"],
                         piped[1].comm["reducer"])


@pytest.mark.parametrize("reducer", ["mean_allreduce", "topk"])
def test_overlap_composes_with_the_fused_tail_bitwise(reducer):
    _assert_same_run(
        _run(reducer=reducer, buckets=2, use_kernels=True),
        _run(reducer=reducer, buckets=2, use_kernels=True, overlap=True))


def test_overlap_dynamic_ssp_stateless_reducer_bitwise():
    """A skew of 6 > 4 observed after step 1 revokes step 2's window: the
    landed value is discarded for the pull to the worker mean."""
    skew = {1: [1, 7, 2, 3]}
    inline = _run(staleness="dynamic_ssp", buckets=2, skew=skew)
    piped = _run(staleness="dynamic_ssp", buckets=2, overlap=True,
                 skew=skew)
    assert [h["ssp_admit"] for h in inline[2]] == [1, 1, 0, 1, 1]
    _assert_same_run(inline, piped)


# --- rejections, priming, the state contract -------------------------------


def test_overlap_requires_buckets():
    with pytest.raises(ValueError, match="bucketed wire"):
        treg.make("dc_s3gd", TConfig(**HP), n_workers=W, buckets=0,
                  overlap=True)


def test_overlap_rejected_for_ssgd():
    with pytest.raises(ValueError, match="blocking"):
        treg.make("ssgd", TConfig(**HP), n_workers=W, buckets=2,
                  overlap=True)


def test_overlap_rejects_dynamic_ssp_with_a_stateful_reducer():
    with pytest.raises(ValueError, match="stateful staleness"):
        treg.make("dc_s3gd", TConfig(**HP), n_workers=W, buckets=2,
                  overlap=True, staleness="dynamic_ssp", reducer="topk")


@pytest.mark.parametrize("reducer", ["mean_allreduce", "hierarchical"])
def test_init_primes_the_pipeline(reducer):
    """init issues step 0's reduce: of the zero payload (mean-style, so
    the landed buffers are zero) or of the packed initial weights."""
    alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=W, buckets=2,
                    overlap=True, reducer=reducer)
    wp = params_from_numpy(P.init(), device="cpu")
    state = alg.init(wp)
    plan = alg._plan(state.params)
    landed = PL.landed(state.comm)
    lead = W if reducer == "hierarchical" else 1
    assert [tuple(x.shape) for x in landed] == \
        [(lead, n) for n in plan.bucket_sizes]
    assert all(x.dtype == torch.float32 for x in landed)
    assert P.bitwise(landed, alg.reducer(plan.pack(state.params))
                     if lead == W else plan.zeros(torch.float32, (1,)))


def test_checkpoint_metadata_round_trips_overlap(tmp_path):
    from repro_torch.launch.engine import Engine, algorithm_for_checkpoint
    alg, state, _ = _run(reducer="topk", buckets=2, overlap=True, steps=2)
    engine = Engine(P.Model(P.t_loss), alg)
    path = engine.save(tmp_path / "ckpt", state, step=2)
    assert engine.ckpt_meta()["overlap"] is True
    rebuilt, resolved = algorithm_for_checkpoint(path)
    assert resolved["overlap"] is True and rebuilt.overlap is True
    template = rebuilt.init(params_from_numpy(P.init(), device="cpu"))
    assert P.bitwise(engine.restore(path, template), state)


# --- elastic resize: drain / keep ------------------------------------------


def test_resize_stateless_drains_to_a_fresh_reduce():
    """The drained buffers are bitwise a fresh reduce of the resized
    delta_prev, and the run continues at the new W."""
    alg, state, _ = _run(buckets=2, overlap=True, steps=3)
    state = alg.resize_state(state, 3)
    assert P.bitwise(PL.landed(state.comm),
                     alg.reducer(state.comm["delta_prev"]))
    alg = rebuild_algorithm(alg, 3)
    for t in range(3, 5):
        state, m = alg.step(state, P.t_batch(t, 3), loss_fn=P.t_loss)
    assert np.isfinite(float(m["loss"]))
    assert tuple(state.params["w"].shape) == (3, P.N)


def test_resize_stateful_keeps_the_landed_payload():
    alg, state, _ = _run(reducer="topk", buckets=2, overlap=True, steps=3)
    before = [x.clone() for x in PL.landed(state.comm)]
    state = alg.resize_state(state, 3)
    assert P.bitwise(before, PL.landed(state.comm))
    alg = rebuild_algorithm(alg, 3)
    for t in range(3, 6):
        state, m = alg.step(state, P.t_batch(t, 3), loss_fn=P.t_loss)
    assert np.isfinite(float(m["loss"]))
    plan = alg._plan(state.params)
    assert [tuple(x.shape) for x in PL.landed(state.comm)] == \
        [(1, n) for n in plan.bucket_sizes]
    assert all(r.shape[0] == 3 for r in state.comm["reducer"]["residual"])


# --- against the reference's pipeline --------------------------------------


def _jax_run(reducer, steps=STEPS, **kw):
    alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=W, reducer=reducer,
                    **kw)
    step = jax.jit(lambda s, b: alg.step(s, b, loss_fn=P.j_loss))
    state = alg.init(jax.tree.map(jnp.asarray, P.init()))
    history = []
    for t in range(steps):
        state, m = step(state, P.j_batch(t, W))
        history.append({k: float(v) for k, v in m.items()})
    return state, history


@pytest.mark.parametrize("reducer", ["mean_allreduce", "topk",
                                     "hierarchical"])
def test_overlap_trajectory_matches_the_reference(reducer):
    j_state, j_hist = _jax_run(reducer, buckets=2, overlap=True)
    _, t_state, t_hist = _run(reducer=reducer, buckets=2, overlap=True)
    for a, b in zip(T.leaves(t_state.params), jax.tree.leaves(j_state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for th, jh in zip(t_hist, j_hist):
        for k in METRICS:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    for a, b in zip(PL.landed(t_state.comm),
                    j_state.comm["pipeline"]["reduced"]):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-30))

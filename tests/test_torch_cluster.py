"""Elastic membership (`repro_torch.cluster`, ``resize_state``,
`DenseWindowReduce`, ``Engine.fit(membership=...)``) against the
reference's ``tests/test_cluster.py`` cases and against the reference
itself on the numpy least-squares probe (``tests/torch_problems.py``).

Within the port, bitwise: ``eval_params`` across every resize (the
anchor-form consensus is a fixed point of the collapse and restack), the
rows after the barrier, randk's counter and powersgd's warm start.
Against the reference's ``resize_state`` on the same state: every leaf
rtol 1e-6 / atol 1e-7 of the leaf's largest magnitude (the two packages
sum the W rows in different orders).  The error-feedback mass per bucket
is conserved within ``W·2^-24·Σ|r|`` (one f32 rounding of each row sum
and of its division by the new count).  Fault schedules and transition
logs are pure Python and equal the reference's exactly, dict for dict.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_problems as P
from repro.cluster import ClusterSpec as JSpec
from repro.cluster import FaultSchedule as JFaults
from repro.cluster import Membership as JMembership
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.launch.engine import Engine as JEngine
from repro_torch import tree as T
from repro_torch.checkpoint import restore_pytree
from repro_torch.cluster import (ClusterEvent, ClusterSpec, FaultSchedule,
                                 Membership, rebuild_algorithm)
from repro_torch.core import registry as treg
from repro_torch.core.compress import DenseWindowReduce, TopKReduce
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine, algorithm_for_checkpoint

HP = dict(learning_rate=0.1, momentum=0.9, lambda0=0.2, weight_decay=0.0,
          total_steps=1)
CFG = TConfig(**HP)
DENSITY = 1e-3      # 33 of each 32,768-element bucket: a real residual


def _topk():
    return treg.make_reducer("topk", CFG, density=DENSITY)


def _trained(algo, W, steps=5, **kw):
    alg = treg.make(algo, CFG, n_workers=W, **kw)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    for t in range(steps):
        state, _ = alg.step(state, P.t_batch(t, W), loss_fn=P.t_loss)
    return alg, state


def _mass(state):
    """Per bucket: the residual's total in f64, and its bound
    W·2^-24·Σ|r| for one f32 rounding per row sum and division."""
    out = []
    for r in state.comm["reducer"]["residual"]:
        r = r.double()
        out.append((float(r.sum()),
                    r.shape[0] * 2.0 ** -24 * float(r.abs().sum())))
    return out


def _assert_mass_conserved(before, after):
    for (a, bound), (b, _) in zip(before, after):
        assert abs(a - b) <= bound, (a, b, bound)


def _assert_close_to_reference(ours, theirs):
    for x, y in zip(T.leaves(P.to_numpy(ours)), jax.tree.leaves(theirs)):
        y = np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        np.testing.assert_allclose(
            x, y, rtol=1e-6, atol=1e-7 * max(float(np.abs(y).max()), 1e-30))


# --- ClusterSpec, against the reference's ----------------------------------


def test_spec_uniform_and_views_match_the_reference():
    ours, theirs = ClusterSpec.uniform(8, pods=2), JSpec.uniform(8, pods=2)
    assert ours.ids == theirs.ids == tuple(f"w{i}" for i in range(8))
    assert ours.pods() == theirs.pods()
    assert ours.index("w5") == 5
    with pytest.raises(KeyError):
        ours.index("nope")
    with pytest.raises(ValueError, match="pods"):
        ClusterSpec.uniform(6, pods=4)


def test_spec_transitions_are_pure_and_ids_never_reused():
    spec = ClusterSpec.uniform(4)
    smaller = spec.without("w1")
    assert spec.n_workers == 4 and smaller.ids == ("w0", "w2", "w3")
    grown = smaller.joined(2)
    assert grown.ids == ("w0", "w2", "w3", "w4", "w5")
    assert grown.without("w4").joined(1).ids[-1] == "w6"
    j = JSpec.uniform(4).without("w1").joined(2).without("w4").joined(1)
    assert grown.without("w4").joined(1).ids == j.ids


def test_spec_meta_round_trips_as_the_reference():
    ours = ClusterSpec.uniform(4, pods=2).without("w1").joined(1, pod=1)
    theirs = JSpec.uniform(4, pods=2).without("w1").joined(1, pod=1)
    assert ours.as_meta() == theirs.as_meta()
    assert json.loads(json.dumps(ours.as_meta())) == ours.as_meta()


# --- the collapse-to-consensus resize ---------------------------------------


@pytest.mark.parametrize("algo", ["dc_s3gd", "ssgd"])
@pytest.mark.parametrize("w_new", [6, 4, 11])
def test_resize_keeps_eval_params_bitwise_and_conserves_residual(algo,
                                                                 w_new):
    """W = 8 -> {6, 4, 11} over topk with 4 buckets: eval_params bitwise,
    the residual's mass conserved, every leaf as the reference's
    resize_state of the same state, and training goes on."""
    alg, state = _trained(algo, 8, reducer=_topk(), buckets=4)
    pre_avg, pre_mass = alg.eval_params(state), _mass(state)
    resized = alg.resize_state(state, w_new)
    alg2 = rebuild_algorithm(alg, w_new)
    assert alg2.n_workers == w_new
    assert P.bitwise(pre_avg, alg2.eval_params(resized))
    _assert_mass_conserved(pre_mass, _mass(resized))
    j_alg = jreg.make(algo, JConfig(**HP), n_workers=8, buckets=4,
                      reducer=jreg.make_reducer("topk", JConfig(**HP),
                                                density=DENSITY))
    _assert_close_to_reference(resized,
                               j_alg.resize_state(P.to_jax(state), w_new))
    for t in range(5, 8):
        resized, m = alg2.step(resized, P.t_batch(t, w_new),
                               loss_fn=P.t_loss)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("extra", [
    {}, {"buckets": 2}, {"buckets": 2, "use_kernels": True},
    {"local_optimizer": "adam"}, {"buckets": 2, "reducer": "gossip"}],
    ids=["per_leaf", "bucketed", "fused", "adam", "gossip"])
def test_resize_matches_the_reference_and_is_a_barrier(extra):
    """After the resize every row holds the consensus (contiguous, so an
    in-place update writes one worker), Adam's 0-d ``t`` is kept, and the
    next step's D is ~0 (Algorithm 1's prologue after the barrier)."""
    alg, state = _trained("dc_s3gd", 8, **extra)
    resized = alg.resize_state(state, 6)
    for leaf in T.leaves(resized.params) + T.leaves(resized.opt):
        if leaf.dim():
            assert leaf.is_contiguous()
            assert all(torch.equal(leaf[0], leaf[i]) for i in range(6))
    if "t" in state.opt:
        assert torch.equal(resized.opt["t"], state.opt["t"])
    j_kw = {k: v for k, v in extra.items() if k != "use_kernels"}
    j_alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=8, **j_kw)
    _assert_close_to_reference(resized,
                               j_alg.resize_state(P.to_jax(state), 6))
    _, m = rebuild_algorithm(alg, 6).step(resized, P.t_batch(9, 6),
                                          loss_fn=P.t_loss)
    assert float(m["distance_norm"]) < 1e-6


def test_resize_grows_from_the_consensus():
    alg, state = _trained("dc_s3gd", 4)
    resized = alg.resize_state(state, 7)
    assert P.bitwise(alg.eval_params(state),
                     rebuild_algorithm(alg, 7).eval_params(resized))
    m = resized.opt["m"]["w"]
    assert m.shape[0] == 7 and all(torch.equal(m[0], m[i])
                                   for i in range(1, 7))


def test_resize_staleness_counters_collapse_to_the_leader():
    alg, state = _trained("dc_s3gd", 4, staleness="dynamic_ssp")
    state = alg.observe_progress(state, [3, 9, 5, 7])
    steps = alg.resize_state(state, 3).comm["staleness"]["worker_steps"]
    assert steps.dtype == np.int32 and steps.tolist() == [9, 9, 9]


@pytest.mark.parametrize("name,carried", [("randk", "step"),
                                          ("powersgd", "q")])
def test_resize_keeps_randk_counter_and_powersgd_warm_start(name, carried):
    red = treg.make_reducer(name, CFG, density=DENSITY) \
        if name == "randk" else treg.make_reducer(name, CFG, rank=2)
    alg, state = _trained("ssgd", 8, reducer=red, buckets=4)
    before = state.comm["reducer"][carried]
    resized = alg.resize_state(state, 6)
    assert P.bitwise(before, resized.comm["reducer"][carried])
    assert all(r.shape[0] == 6 for r in resized.comm["reducer"]["residual"])


def test_resize_updates_topk_exact_worker_count():
    red = treg.make_reducer("topk_exact", CFG, density=DENSITY)
    alg, state = _trained("ssgd", 8, reducer=red, buckets=4)
    sizes = list(alg._plan(state.params).bucket_sizes)
    wire8 = red.wire_bytes(sizes)
    alg.resize_state(state, 4)
    assert red._n_workers == 4 and red.wire_bytes(sizes) <= wire8


def test_membership_rejects_dc_asgd():
    alg = treg.make("dc_asgd", CFG, n_workers=4)
    state = alg.init(params_from_numpy(P.init(), device="cpu"))
    with pytest.raises(TypeError, match="resize_state"):
        Membership(alg).apply([ClusterEvent("leave", worker="w0")], state,
                              step=0)


# --- elastic resume through a checkpoint ------------------------------------


@pytest.mark.parametrize("algo", ["dc_s3gd", "ssgd"])
def test_elastic_resume_from_a_checkpoint(tmp_path, algo):
    alg, state = _trained(algo, 8, reducer=_topk(), buckets=4)
    path = Engine(None, alg).save(tmp_path / "ckpt.npz", state, step=5)
    restored_alg, resolved = algorithm_for_checkpoint(path, dc_cfg=CFG)
    assert resolved["n_workers"] == 8 and resolved["buckets"] == 4
    restored = restore_pytree(path, restored_alg.init(
        params_from_numpy(P.init(), device="cpu")))
    assert P.bitwise(state, restored)
    resized = restored_alg.resize_state(restored, 6)
    alg2 = rebuild_algorithm(restored_alg, 6)
    assert P.bitwise(restored_alg.eval_params(restored),
                     alg2.eval_params(resized))
    _assert_mass_conserved(_mass(restored), _mass(resized))
    for t in range(5, 7):
        resized, m = alg2.step(resized, P.t_batch(t, 6), loss_fn=P.t_loss)
    assert np.isfinite(float(m["loss"]))


def test_worker_count_mismatch_names_the_cure(tmp_path):
    alg, state = _trained("dc_s3gd", 8, steps=1)
    path = Engine(None, alg).save(tmp_path / "w8.npz", state, step=1)
    wrong = treg.make("dc_s3gd", CFG, n_workers=6).init(
        params_from_numpy(P.init(), device="cpu"))
    with pytest.raises(ValueError, match="worker-count change"):
        restore_pytree(path, wrong)


# --- fault schedules ---------------------------------------------------------


SCHEDULE = {"seed": 7, "events": [
    {"step": 2, "kind": "leave"},
    {"step": 5, "kind": "join", "count": 2, "pod": 1},
    {"step": 6, "kind": "slowdown", "factor": 8.0, "duration": 3},
    {"step": 7, "kind": "eject"},
]}


def test_fault_schedule_round_trip_and_determinism(tmp_path):
    p = tmp_path / "faults.json"
    p.write_text(json.dumps(SCHEDULE))
    a, b = FaultSchedule.from_json(p), FaultSchedule.from_json(SCHEDULE)
    spec = ClusterSpec.uniform(4)
    for step in range(10):
        assert a.membership_events(step, spec) == \
            b.membership_events(step, spec)
        assert a.slowdown_factors(step, spec) == \
            b.slowdown_factors(step, spec)
    (leave,) = a.membership_events(2, spec)
    assert leave.kind == "leave" and leave.worker in spec.ids
    with pytest.raises(ValueError, match="fault kind"):
        FaultSchedule.from_json({"events": [{"step": 1, "kind": "crash"}]})


@pytest.mark.parametrize("seed", [0, 7, 11, 12345])
def test_fault_victims_equal_the_reference(seed):
    """Unnamed victims come from stdlib random keyed on (seed << 20) ^
    step, resolved against the membership of the moment: the same events
    as the reference's, step by step, over a shrinking roster."""
    src = {"seed": seed, "events": [
        {"step": s, "kind": k} for s, k in
        ((1, "leave"), (2, "slowdown"), (3, "eject"), (3, "leave"),
         (4, "join"), (6, "leave"))]}
    ours, theirs = FaultSchedule.from_json(src), JFaults.from_json(src)
    spec, jspec = ClusterSpec.uniform(8), JSpec.uniform(8)
    for step in range(8):
        evs, jevs = ours.membership_events(step, spec), \
            theirs.membership_events(step, jspec)
        assert [vars(e) for e in evs] == [vars(e) for e in jevs]
        assert ours.slowdown_factors(step, spec) == \
            theirs.slowdown_factors(step, jspec)
        for e in evs:
            if e.kind in ("leave", "eject") and e.worker in spec.ids:
                spec, jspec = spec.without(e.worker), \
                    jspec.without(e.worker)
            elif e.kind == "join":
                spec, jspec = spec.joined(e.count), jspec.joined(e.count)
    assert spec.ids == jspec.ids


def test_fault_schedule_victim_gone_is_dropped():
    fs = FaultSchedule.from_json(
        {"events": [{"step": 3, "kind": "leave", "worker": "w1"}]})
    spec = ClusterSpec.uniform(4).without("w1")
    assert fs.membership_events(3, spec) == []
    assert fs.slowdown_factors(3, spec) is None


def test_slowdown_factors_follow_spec_order():
    fs = FaultSchedule.from_json(
        {"events": [{"step": 0, "kind": "slowdown", "worker": "w2",
                     "factor": 4.0, "duration": 2}]})
    spec = ClusterSpec.uniform(3)
    assert fs.slowdown_factors(0, spec) == [1.0, 1.0, 4.0]
    assert fs.slowdown_factors(1, spec) == [1.0, 1.0, 4.0]
    assert fs.slowdown_factors(2, spec) is None


# --- live elastic training through Engine.fit ------------------------------


def _fit(schedule, *, W=4, steps=12, staleness="fixed", measure=False,
         probe=None, eject=None, patience=2, min_workers=2, buckets=0,
         reducer=None, dense_after_join=0):
    kw = {"staleness": staleness, "buckets": buckets}
    if reducer is not None:
        kw["reducer"] = reducer
    alg = treg.make("dc_s3gd", CFG, n_workers=W, **kw)
    held = {}
    ms = Membership(alg, faults=FaultSchedule.from_json(schedule)
                    if schedule else None, eject_threshold=eject,
                    eject_patience=patience, min_workers=min_workers,
                    dense_after_join=dense_after_join)
    held["ms"] = ms
    state, history, _ = Engine(P.Model(P.t_loss), alg).fit(
        alg.init(params_from_numpy(P.init(), device="cpu")), P.t_batch,
        steps=steps, log_every=1, membership=ms, measure_skew=measure,
        skew_probe=probe and (lambda it, dt: probe(held["ms"], it, dt)))
    return ms, state, history


def _jax_fit(schedule, *, W=4, steps=12, measure=False, eject=None,
             patience=2, buckets=0, reducer=None, dense_after_join=0):
    kw = {"buckets": buckets}
    if reducer is not None:
        kw["reducer"] = jreg.make_reducer(reducer, JConfig(**HP),
                                          density=DENSITY)
    alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=W, **kw)
    ms = JMembership(alg, faults=JFaults.from_json(schedule),
                     eject_threshold=eject, eject_patience=patience,
                     dense_after_join=dense_after_join)
    JEngine(P.Model(P.j_loss), alg).fit(
        alg.init(jax.tree.map(jnp.asarray, P.init())), P.j_batch,
        steps=steps, log_every=1, verbose=False, membership=ms,
        measure_skew=measure)
    return ms.log


def test_fit_live_leave_and_join():
    ms, state, history = _fit(
        {"events": [{"step": 3, "kind": "leave", "worker": "w1"},
                    {"step": 7, "kind": "join", "count": 1}]},
        W=4, steps=10, staleness="dynamic_ssp", buckets=4, reducer=_topk())
    assert [e["kind"] for e in ms.log] == ["leave", "join"]
    assert ms.spec.ids == ("w0", "w2", "w3", "w4")
    assert state.params["w"].shape[0] == 4
    assert [h["n_workers"] for h in history] == [4] * 3 + [3] * 4 + [4] * 3
    assert all(np.isfinite(h["loss"]) for h in history)
    assert state.comm["staleness"]["worker_steps"].shape == (4,)


def test_fit_same_count_swap_still_applies_the_barrier():
    ms, state, _ = _fit(
        {"events": [{"step": 4, "kind": "leave", "worker": "w0"},
                    {"step": 4, "kind": "join", "count": 1}]},
        W=3, steps=5)
    assert ms.spec.ids == ("w1", "w2", "w3") and len(ms.log) == 2


def test_dense_after_join_window_zeroes_the_residual():
    """Inside the window the reducer is dense: the carried residual is
    exactly zero (the run ends inside it) and B3's wrapper is not run."""
    ms, state, history = _fit(
        {"events": [{"step": 3, "kind": "join", "count": 1}]},
        W=3, steps=6, buckets=4, dense_after_join=10,
        reducer=treg.make_reducer("topk", CFG, density=1e-4))
    assert isinstance(ms.alg.reducer, DenseWindowReduce)
    assert [e["kind"] for e in ms.log] == ["join", "dense_window_start"]
    assert not any(bool(r.any()) for r in state.comm["reducer"]["residual"])
    assert all(np.isfinite(h["loss"]) for h in history)


def test_dense_after_join_window_elapses_and_compression_resumes():
    ms, state, history = _fit(
        {"events": [{"step": 3, "kind": "join", "count": 1}]},
        W=3, steps=10, buckets=4, dense_after_join=2,
        reducer=treg.make_reducer("topk", CFG, density=1e-4))
    assert isinstance(ms.alg.reducer, TopKReduce)
    assert [e["kind"] for e in ms.log] == \
        ["join", "dense_window_start", "dense_window_end"]
    assert ms.log[2]["step"] == ms.log[1]["step"] + 2
    assert any(bool(r.any()) for r in state.comm["reducer"]["residual"])
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("comm_dtype", ["bfloat16", "int8"])
def test_dense_window_reduce_matches_the_reference(comm_dtype):
    """One dense-window call on a random wire and residual: the mean and
    the new residual as the reference's (zero on a float wire; the
    quantization error on an int8 one)."""
    from repro.core.compress import DenseWindowReduce as JDense
    rng = np.random.default_rng(0)
    wire = [rng.standard_normal((3, 64)).astype(np.float32)]
    res = [1e-2 * rng.standard_normal((3, 64)).astype(np.float32)]
    ours = DenseWindowReduce(treg.make_reducer("topk", CFG,
                                               comm_dtype=comm_dtype))
    theirs = JDense(jreg.make_reducer("topk", JConfig(**HP),
                                      comm_dtype=comm_dtype))
    out, st = ours(params_from_numpy(wire, device="cpu"),
                   {"residual": params_from_numpy(res, device="cpu")})
    j_out, j_st = theirs([jnp.asarray(w) for w in wire],
                         {"residual": [jnp.asarray(r) for r in res]})
    np.testing.assert_allclose(out[0].numpy(), np.asarray(j_out[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st["residual"][0].numpy(),
                               np.asarray(j_st["residual"][0]), atol=1e-7)
    assert ours.name == "topk" and ours.hparams["comm_dtype"] == comm_dtype


def test_fit_ejects_a_persistent_straggler():
    def probe(ms, it, dt):
        durs = [dt] * ms.n_workers
        if "w0" in ms.spec.ids:
            durs[ms.spec.index("w0")] = 4 * dt
        return durs

    ms, state, history = _fit(None, W=4, steps=10, measure=True,
                              probe=probe, eject=2.0)
    assert [e["kind"] for e in ms.log] == ["eject"]
    assert ms.log[0]["worker"] == "w0" and "lag" in ms.log[0]["reason"]
    assert ms.n_workers == 3 and state.params["w"].shape[0] == 3
    assert all(np.isfinite(h["loss"]) for h in history)


def test_fit_ejection_respects_min_workers():
    ms, _, _ = _fit(None, W=2, steps=6, measure=True, eject=1.0,
                    patience=1, probe=lambda ms, it, dt: [4 * dt, dt])
    assert ms.log == [] and ms.n_workers == 2


# the card's elastic schedule (chip_smoke.py): the seeded victims at steps
# 2 and 4 are w0 and w2, so W runs 8 -> 6 -> 4 -> 5
ELASTIC = {"seed": 0, "events": [
    {"step": 2, "kind": "leave"}, {"step": 2, "kind": "leave",
                                   "worker": "w5"},
    {"step": 4, "kind": "leave"}, {"step": 4, "kind": "leave",
                                   "worker": "w6"},
    {"step": 6, "kind": "join", "count": 1}]}
EJECTION = {"seed": 11, "events": [
    {"step": 3, "kind": "leave"},
    {"step": 6, "kind": "join", "count": 1},
    {"step": 8, "kind": "slowdown", "factor": 16.0, "duration": 6}]}


@pytest.mark.parametrize("schedule,kw,kinds", [
    (EJECTION, dict(W=4, steps=16, measure=True, eject=3.0),
     ["leave", "join", "eject", "eject"]),
    (ELASTIC, dict(W=8, steps=8, buckets=4, reducer="topk",
                   dense_after_join=1),
     ["leave"] * 4 + ["join", "dense_window_start", "dense_window_end"]),
], ids=["ejection", "leave_join_dense"])
def test_transition_logs_equal_the_reference(schedule, kw, kinds):
    """Two fresh port runs and the reference's run of one seeded schedule
    give the same log, dict for dict."""
    t_kw = dict(kw, reducer=_topk()) if kw.get("reducer") else kw
    logs = [_fit(schedule, **t_kw)[0].log for _ in range(2)]
    assert logs[0] == logs[1] == _jax_fit(schedule, **kw)
    assert [e["kind"] for e in logs[0]] == kinds
    if schedule is ELASTIC:
        assert [e["n_workers"] for e in logs[0][:5]] == [7, 6, 5, 4, 5]
        assert [e["worker"] for e in logs[0][:5]] == \
            ["w0", "w5", "w2", "w6", "w8"]

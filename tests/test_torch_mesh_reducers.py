"""The paper's worker axis across ranks for every reducer, ``dynamic_ssp``,
DC-ASGD and elastic resize, on gloo ranks spawned on the CPU
(`tests/torch_mesh_worker.py`, one spawn per world size, a ``file://``
store under ``tmp_path``); JAX runs only in this, the parent, process.

* Reducer-level parity: one call of each reducer on a (W, n) wire and
  residual made from a numpy seed, at 2 and 4 ranks against the
  one-process call.  gossip and hierarchical (every layout: groups that
  lie inside a rank, align with ranks or span 2 or 4 of them) are
  bitwise: no sum crosses rows, and a spanning group adds its gathered
  members in worker order; groups that cut through a rank's rows (12
  workers: 3 or 6 groups over 2 or 4 ranks) gather their rows from both
  ranks' shares.  The means add per-rank partial sums, an f32
  rounding away from the one-process row order: within ``TOL_MESH``.
  The residuals of the selecting wires are bitwise (each rank selects on
  its own rows; topk_exact's union is the all-reduced OR); powersgd's
  hold the cross-rank means, so within ``TOL_MESH``.  What must be the
  same on every rank (a mean, powersgd's warm start) is.
* Trajectories: 3 steps at 2 and 4 ranks on the reduced qwen3 and the
  reduced ResNet for each reducer, ``dynamic_ssp`` (a scripted straggler
  revokes step 2 on every rank), ``dc_asgd`` and elastic resizes.  The
  gathered params, opt and comm of gossip, hierarchical and dc_asgd runs
  are bitwise one process; every other run holds each leaf within
  ``TOL_MESH`` of its largest one-process magnitude, the metrics within
  ``RTOL_MESH``, identical on every rank.  An error-feedback residual is
  what compression left of the payload Δw + residual, so its own largest
  value is about the selection threshold (5.7e-5 in the CNN's third
  bucket, whose carried deltas reach 0.054): it is held at its bucket's
  payload scale, the carried delta's (`torch_mesh_worker._compare_comm`).
  No selection flips in these runs (the reducer-level residuals are
  bitwise).
* Elastic: each resize keeps ``eval_params`` bitwise on the mesh and the
  transition log equals one process's.  After a resize to a W whose mean
  of W identical rows is inexact (6), dc_s3gd's next D is rounding
  noise, which Eq. 17's λ scales to a correction of λ0‖g‖: another sum
  order is another noise, so that trajectory leaves one process's at
  O(λ0).  8 → 6 → 4 is therefore held to one process under ``stale``
  (λ0 = 0) and 8 → 4 (→ 2) under dc_s3gd, where the mean is exact.
  On the step right after a resize, where D is that noise, the
  ``distance_norm`` metric is held at 1e-6 of the step's ``delta_norm``
  (the scale of the deltas whose mean it rounds).
* Against JAX: 2-rank gossip and topk runs at `tests/test_torch_dc_s3gd.
  py`'s ``TOL`` / ``RTOL_METRICS``; gossip from per-worker weights 1e-2
  apart, as `tests/test_torch_training_pieces.py` runs it (from equal
  workers gossip's first D is the rounding noise of (3w)/3).
* Overlap == inline bitwise at 2 ranks for gossip and topk.
* B3's cross-rank modes on the CPU (partial x reciprocal, rounded, is
  the full mean; a mask equal to the local OR is ``union=True``), and
  the kernel against its plain version on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import registry as j_registry
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models.transformer import Model as JModel

import torch_mesh_worker as MW
from torch_threads import one_torch_thread  # noqa: F401

TOL_MESH = 1e-5
RTOL_MESH = 1e-5
TOL, RTOL_METRICS = 1e-4, 1e-5        # tests/test_torch_dc_s3gd.py's
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")

F = {"buckets": 2, "use_kernels": True}
DENSITY = {"cfg": {"compress_density": 0.02}}
SSP = {"staleness": "dynamic_ssp", "cfg": {"ssp_threshold": 1},
       "skew": (3.0, 1.0)}


def _leave(step, *ids):
    return [{"step": step, "kind": "leave", "worker": w} for w in ids]


E864 = _leave(1, "w1", "w5") + _leave(2, "w2", "w6")
E842 = _leave(1, "w1", "w3", "w5", "w7") + _leave(2, "w2", "w6")
E84 = _leave(1, "w1", "w3", "w5", "w7")

# (id, model, spec, W, what is held): "bitwise" holds params, opt and comm
# bitwise (eval_params within TOL_MESH: it all-reduces); "tol" every part
# within TOL_MESH; "pins" only the elastic pins (see the module docstring)
R2 = [
    ("lm-gossip", "lm", {**F, "reducer": "gossip"}, 4, "bitwise"),
    ("lm-gossip-overlap", "lm", {**F, "reducer": "gossip", "overlap": True},
     4, "bitwise"),
    ("lm-topk", "lm", {**F, "reducer": "topk", **DENSITY}, 4, "tol"),
    ("lm-topk-overlap", "lm", {**F, "reducer": "topk", **DENSITY,
                               "overlap": True}, 4, "tol"),
    ("lm-gossip-spread", "lm", {**F, "reducer": "gossip", "spread": True},
     4, "bitwise"),
    ("lm-hierarchical-spans", "lm", {**F, "reducer": "hierarchical",
                                     "reducer_opts": {"groups": 1}}, 4,
     "bitwise"),
    ("lm-topk_exact", "lm", {**F, "reducer": "topk_exact"}, 4, "tol"),
    ("lm-randk", "lm", {**F, "reducer": "randk"}, 4, "tol"),
    ("lm-powersgd", "lm", {**F, "reducer": "powersgd"}, 4, "tol"),
    ("lm-stale-hierarchical", "lm", {"algo": "stale", **F,
                                     "reducer": "hierarchical"}, 4,
     "bitwise"),
    ("lm-ssgd-gossip-k2", "lm", {"algo": "ssgd", "reducer": "gossip",
                                 "reducer_opts": {"neighbors": 2}}, 4, "tol"),
    ("lm-ssgd-topk_exact", "lm", {"algo": "ssgd", "buckets": 2,
                                  "reducer": "topk_exact"}, 4, "tol"),
    ("lm-dynamic_ssp", "lm", {**F, **SSP}, 4, "tol"),
    ("lm-dc_asgd", "lm", {"algo": "dc_asgd"}, 4, "bitwise"),
    ("cnn-gossip", "cnn", {**F, "reducer": "gossip"}, 8, "bitwise"),
    ("cnn-hierarchical-inside", "cnn", {**F, "reducer": "hierarchical",
                                        "reducer_opts": {"groups": 4}}, 8,
     "bitwise"),
    ("cnn-topk", "cnn", {**F, "reducer": "topk"}, 8, "tol"),
    ("cnn-topk_exact", "cnn", {**F, "reducer": "topk_exact"}, 8, "tol"),
    ("cnn-randk", "cnn", {"buckets": 2, "reducer": "randk"}, 8, "tol"),
    ("cnn-powersgd", "cnn", {**F, "reducer": "powersgd"}, 8, "tol"),
    ("cnn-stale-gossip-int8", "cnn", {
        "algo": "stale", **F, "reducer": "gossip",
        "reducer_opts": {"comm_dtype": "int8"}}, 8, "bitwise"),
    ("cnn-ssgd-hierarchical", "cnn", {"algo": "ssgd",
                                      "reducer": "hierarchical"}, 8, "tol"),
    ("cnn-ssgd-powersgd", "cnn", {"algo": "ssgd", "buckets": 2,
                                  "reducer": "powersgd"}, 8, "tol"),
    ("cnn-dynamic_ssp", "cnn", {**F, **SSP}, 8, "tol"),
    ("cnn-dc_asgd", "cnn", {"algo": "dc_asgd"}, 8, "bitwise"),
    ("cnn-stale-elastic-8-6-4", "cnn", {"algo": "stale", **F,
                                        "elastic": E864}, 8, "tol"),
    ("cnn-elastic-8-6-4", "cnn", {**F, "elastic": E864}, 8, "pins"),
    ("cnn-elastic-8-4-2", "cnn", {**F, "elastic": E842}, 8, "tol"),
    ("cnn-ssgd-topk-elastic-8-6-4", "cnn", {
        "algo": "ssgd", "buckets": 2, "reducer": "topk", "elastic": E864},
     8, "tol"),
    # 3 groups over 2 ranks of 3 rows: group 1 lies across both ranks
    ("lm-hierarchical-cut-int8", "lm", {
        **F, "reducer": "hierarchical",
        "reducer_opts": {"groups": 3, "comm_dtype": "int8"}}, 6, "bitwise"),
]
# 4 ranks laid out as pods (2, 2, 1): the lm at W = 4 (one row a rank),
# the CNN at W = 8 (two)
R4 = [
    ("lm-gossip", "lm", {**F, "reducer": "gossip"}, 4, "bitwise"),
    ("lm-hierarchical-spans", "lm", {**F, "reducer": "hierarchical"}, 4,
     "bitwise"),
    ("lm-topk", "lm", {**F, "reducer": "topk"}, 4, "tol"),
    ("lm-topk_exact", "lm", {**F, "reducer": "topk_exact"}, 4, "tol"),
    ("lm-randk", "lm", {**F, "reducer": "randk"}, 4, "tol"),
    ("lm-powersgd", "lm", {**F, "reducer": "powersgd"}, 4, "tol"),
    ("lm-stale-topk_exact", "lm", {"algo": "stale", **F,
                                   "reducer": "topk_exact"}, 4, "tol"),
    ("lm-ssgd-gossip", "lm", {"algo": "ssgd", "reducer": "gossip"}, 4,
     "tol"),
    ("lm-dynamic_ssp", "lm", {**F, **SSP}, 4, "tol"),
    ("lm-dc_asgd", "lm", {"algo": "dc_asgd"}, 4, "bitwise"),
    ("cnn-gossip-k2", "cnn", {**F, "reducer": "gossip",
                              "reducer_opts": {"neighbors": 2}}, 8,
     "bitwise"),
    ("cnn-hierarchical-spans-4", "cnn", {
        **F, "reducer": "hierarchical", "reducer_opts": {"groups": 1}}, 8,
     "bitwise"),
    ("cnn-hierarchical-aligned", "cnn", {
        **F, "reducer": "hierarchical", "reducer_opts": {"groups": 4}}, 8,
     "bitwise"),
    ("cnn-topk", "cnn", {**F, "reducer": "topk"}, 8, "tol"),
    ("cnn-randk", "cnn", {**F, "reducer": "randk"}, 8, "tol"),
    ("cnn-powersgd", "cnn", {**F, "reducer": "powersgd"}, 8, "tol"),
    ("cnn-ssgd-topk", "cnn", {"algo": "ssgd", "buckets": 2,
                              "reducer": "topk"}, 8, "tol"),
    ("cnn-dynamic_ssp", "cnn", {**F, **SSP}, 8, "tol"),
    ("cnn-dc_asgd", "cnn", {"algo": "dc_asgd"}, 8, "bitwise"),
    ("cnn-elastic-8-4", "cnn", {**F, "elastic": E84}, 8, "tol"),
    # 3 groups of 4 over 4 ranks of 3 rows
    ("cnn-hierarchical-cut-w12", "cnn", {
        **F, "reducer": "hierarchical", "reducer_opts": {"groups": 3}}, 12,
     "bitwise"),
]

# one call of each reducer: name -> (registry name, constructor knobs)
REDUCERS = {
    "gossip": ("gossip", {}),
    "gossip-k2": ("gossip", {"neighbors": 2}),
    "gossip-k3": ("gossip", {"neighbors": 3}),
    "gossip-int8": ("gossip", {"comm_dtype": "int8"}),
    "gossip-bf16": ("gossip", {"comm_dtype": "bfloat16"}),
    "hierarchical-g1": ("hierarchical", {"groups": 1}),
    "hierarchical-g2": ("hierarchical", {"groups": 2}),
    "hierarchical-g4": ("hierarchical", {"groups": 4}),
    "hierarchical-g8": ("hierarchical", {"groups": 8}),
    "hierarchical-g2-fp8": ("hierarchical", {"groups": 2,
                                             "comm_dtype": "fp8"}),
    "mean_allreduce": ("mean_allreduce", {}),
    "mean_allreduce-int8": ("mean_allreduce", {"comm_dtype": "int8"}),
    "topk": ("topk", {"density": 0.05}),
    "topk-kernel": ("topk", {"density": 0.05, "use_kernels": True}),
    "topk-kernel-bf16": ("topk", {"density": 0.05, "use_kernels": True,
                                  "comm_dtype": "bfloat16"}),
    "topk-int8": ("topk", {"density": 0.05, "comm_dtype": "int8"}),
    "topk_exact": ("topk_exact", {"density": 0.05}),
    "topk_exact-kernel": ("topk_exact", {"density": 0.05,
                                         "use_kernels": True}),
    "randk": ("randk", {"density": 0.05}),
    "powersgd": ("powersgd", {"rank": 2}),
}
BITWISE_OUT = ("gossip", "hierarchical")
REDUCER_KW = dict(W=8, sizes=(1000, 96), seed=0)
# hierarchical groups that cut through a rank's rows, at W = 12 (groups
# of 4 or 2 over ranks of 6 or 3 rows; 6 groups of 2 on 2 ranks nest)
CUT = {
    "g3": ("hierarchical", {"groups": 3}),
    "g3-k2": ("hierarchical", {"groups": 3, "neighbors": 2}),
    "g3-int8": ("hierarchical", {"groups": 3, "comm_dtype": "int8"}),
    "g6": ("hierarchical", {"groups": 6}),
    "g6-bf16": ("hierarchical", {"groups": 6, "comm_dtype": "bfloat16"}),
}
CUT_KW = dict(W=12, sizes=(1000, 96), seed=1)

GROUPS = {"r2": (2, dict(runs=R2, layout="data", keep=(0, 1, 2, 3, 4))),
          "r4": (4, dict(runs=R4, layout="pods"))}
SPREAD_W = 4


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _spread_weights():
    """Per-worker weights (W, ...): the init plus 1e-2 x a per-worker
    standard normal draw (numpy, seed 5)."""
    rng = np.random.default_rng(5)
    return jax.tree.map(
        lambda p: (p[None] + 1e-2 * rng.standard_normal((SPREAD_W,)
                                                        + p.shape))
        .astype(np.float32), _weights())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world size's spawned results (the reducer calls and the
    runs), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            world, kw = GROUPS[name]
            tmp = tmp_path_factory.mktemp(name)
            kw = dict(kw, runs=[r[1:4] for r in kw["runs"]],
                      weights=_weights(), reducers=REDUCERS,
                      reducer_kw=REDUCER_KW, spread=_spread_weights(),
                      cut=(CUT, CUT_KW))
            cache[name] = MW.spawn(world, "suite", kw, tmp, timeout=600.0)
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# one reducer call
# ---------------------------------------------------------------------------

RCASES = [(g, k) for g in GROUPS for k in REDUCERS]


@pytest.mark.parametrize("group,key", RCASES,
                         ids=[f"{g}-{k}" for g, k in RCASES])
def test_reducer_call_matches_one_process(ranks, group, key):
    res = ranks(group)
    got = res[0]["reducers"][key]
    # a mean and a warm start are the same bits on every rank
    assert all(r["reducers"][key]["shared"] == got["shared"]
               for r in res[1:])
    name = REDUCERS[key][0]
    if name in BITWISE_OUT:
        assert got["out"] == (0.0, True), got["out"]
    else:
        assert got["out"][0] <= TOL_MESH, got["out"]
    if "res" in got:
        if name == "powersgd":
            # a - P̂Qᵀ, and P̂Qᵀ holds the cross-rank means
            assert got["res"][0] <= TOL_MESH, got["res"]
            assert got["q"][0] <= TOL_MESH, got["q"]
        else:
            assert got["res"] == (0.0, True), got["res"]


CUT_CASES = [(g, k) for g in GROUPS for k in CUT]


@pytest.mark.parametrize("group,key", CUT_CASES,
                         ids=[f"{g}-{k}" for g, k in CUT_CASES])
def test_hierarchical_groups_across_ranks_are_bitwise(ranks, group, key):
    """Groups that cut through a rank's rows: each rank takes the mean of
    every group its rows touch over the rows gathered from the ranks that
    hold them, added in worker order, and the ring between the group
    means runs over the ranks' overlapping ranges of groups: bitwise the
    one-process call, values and scales on a quantized wire."""
    got = ranks(group)[0]["cut"][key]
    assert got["out"] == (0.0, True), got["out"]


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

TCASES = [(g, i) for g in GROUPS for i in range(len(GROUPS[g][1]["runs"]))]


def _run_of(group, i):
    return GROUPS[group][1]["runs"][i]


@pytest.mark.parametrize("group,i", TCASES,
                         ids=[f"{g}-{_run_of(g, i)[0]}" for g, i in TCASES])
def test_trajectory_matches_one_process(ranks, group, i):
    res = ranks(group)
    what = _run_of(group, i)[4]
    # the gathered state and the metrics are the same on every rank
    for r in res[1:]:
        assert r["runs"][i]["digest"] == res[0]["runs"][i]["digest"]
        assert r["runs"][i]["hist"] == res[0]["runs"][i]["hist"]
    got = res[0]["runs"][i]
    assert len(got["hist"]) == len(got["hist_one"]) == MW.STEPS
    if got["pins"] is not None:
        # eval_params bitwise across every resize, on the mesh; the same
        # transitions as one process
        assert got["pins"] and all(got["pins"]), got["pins"]
        assert got["log"] == got["log_one"]
        assert [h.get("n_workers") for h in got["hist"]] == \
            [h.get("n_workers") for h in got["hist_one"]]
    if what == "pins":
        return
    for part in MW.PARTS:
        if what == "bitwise" and part != "eval":
            assert got["diff"][part] == (0.0, True), (part, got["diff"][part])
        else:
            assert got["diff"][part][0] <= TOL_MESH, (part, got["diff"][part])
    live = [h.get("n_workers") for h in got["hist_one"]]
    for t, (hg, hw) in enumerate(zip(got["hist"], got["hist_one"])):
        assert hg.keys() == hw.keys()
        for k in hg:
            if what == "bitwise" and k not in METRICS:
                assert hg[k] == hw[k], k
            # D is rounding noise right after a resize (module docstring)
            noise = k == "distance_norm" and t and live[t] != live[t - 1]
            np.testing.assert_allclose(
                hg[k], hw[k], rtol=0 if noise else RTOL_MESH,
                atol=1e-6 * hw["delta_norm"] if noise else 1e-12,
                err_msg=k)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_dynamic_ssp_revokes_the_same_step_on_every_rank(ranks, group):
    """worker 0 runs 3x slower than the rest from step 1: at threshold 1
    step 2's window is revoked, on every rank as in one process (the
    revoked pull is a collective: a rank deciding otherwise would hang)."""
    res = ranks(group)
    for i, run in enumerate(GROUPS[group][1]["runs"]):
        if "skew" not in run[2]:
            continue
        for r in res:
            assert [h["ssp_admit"] for h in r["runs"][i]["hist"]] == \
                [1.0, 1.0, 0.0]
        assert [h["measured_skew"] for h in res[0]["runs"][i]["hist"]] == \
            [h["measured_skew"] for h in res[0]["runs"][i]["hist_one"]]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_dc_asgd_is_bitwise_one_process(ranks, group):
    """The transaction of worker ``step mod W`` runs on the rank that
    holds its batch row and is broadcast: every metric is one process's
    too."""
    res = ranks(group)
    for i, run in enumerate(GROUPS[group][1]["runs"]):
        if run[2].get("algo") != "dc_asgd":
            continue
        got = res[0]["runs"][i]
        assert all(got["diff"][p] == (0.0, True) for p in MW.PARTS)
        assert got["hist"] == got["hist_one"]


def test_elastic_rows_follow_the_live_count(ranks):
    res = ranks("r2")
    i = [r[0] for r in R2].index("cnn-stale-elastic-8-6-4")
    assert [h["n_workers"] for h in res[0]["runs"][i]["hist"]] == [8, 6, 4]


# ---------------------------------------------------------------------------
# against JAX, and overlap == inline
# ---------------------------------------------------------------------------


def _jax_run(W, reducer, spread=False, **hp):
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    model = JModel(cfg, remat=False)
    alg = j_registry.make("dc_s3gd", JConfig(**MW.HP, **hp), n_workers=W,
                          reducer=reducer, buckets=2)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    if spread:
        state = state._replace(params=jax.tree.map(jnp.asarray,
                                                   _spread_weights()))
    data = JData(cfg.vocab_size, MW.SEQ, seed=0)
    hist = []
    for t in range(MW.STEPS):
        state, m = step(state, j_worker_batches(data, t, W, MW.BPW))
        hist.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state), hist


def _assert_close(a, b, tol, what, base=None):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    base = [0.0] * len(la) if base is None else jax.tree.leaves(base)
    assert len(la) == len(lb), what
    for x, y, z in zip(la, lb, base):
        x, y = np.asarray(x, np.float64) - z, np.asarray(y, np.float64) - z
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=tol * float(np.abs(y).max()),
                                   err_msg=what)


@pytest.mark.parametrize("i,reducer,hp", [
    (4, "gossip", {"spread": True}), (2, "topk", {"compress_density": 0.02})],
    ids=["gossip", "topk"])
def test_two_ranks_match_jax(ranks, i, reducer, hp):
    """The 2-rank fused bucketed run (W = 4) against the reference's
    bucketed trajectory at the parity tests' tolerances (topk: the
    residuals too, as `tests/test_torch_dc_s3gd.py` holds them)."""
    got = ranks("r2")[0]["runs"][i]["state"]
    j_state, j_hist = _jax_run(4, reducer, **hp)
    _assert_close(got["params"], j_state.params, TOL, "params",
                  base=_spread_weights() if hp.get("spread")
                  else _weights())
    _assert_close(got["opt"]["m"], j_state.opt["m"], TOL, "opt.m")
    assert sorted(got["comm"]) == sorted(
        k for k in j_state.comm if k != "pipeline")
    if "reducer" in j_state.comm:
        _assert_close(got["comm"]["reducer"]["residual"],
                      j_state.comm["reducer"]["residual"], TOL, "residual")
        _assert_close(got["comm"]["delta_prev"], j_state.comm["delta_prev"],
                      TOL, "delta_prev")
    for hg, hj in zip(got["hist"], j_hist):
        for k in METRICS:
            np.testing.assert_allclose(hg[k], hj[k], rtol=RTOL_METRICS,
                                       err_msg=k)


@pytest.mark.parametrize("inline,overlap", [(0, 1), (2, 3)],
                         ids=["gossip", "topk"])
def test_overlap_equals_inline_bitwise_on_two_ranks(ranks, inline, overlap):
    """A weight-mixing or stateful reducer issues synchronously at the end
    of a step: the same calls on the same inputs as inline."""
    res = ranks("r2")
    a, b = (res[0]["runs"][i]["state"] for i in (inline, overlap))
    # (the pipelined reducer state is one call ahead: `parallel.pipeline`)
    for part in ("params", "opt", "eval", "delta_prev"):
        x, y = (s["comm"].get(part, {}) if part == "delta_prev"
                else s[part] for s in (b, a))
        for x, y in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            assert x.dtype == y.dtype and np.array_equal(x, y), part
    for r in res:
        assert r["runs"][overlap]["hist"] == r["runs"][inline]["hist"]


# ---------------------------------------------------------------------------
# B3's cross-rank modes
# ---------------------------------------------------------------------------

WIRES = (torch.float32, torch.bfloat16, torch.float16)


def _b3_inputs(W, n, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal((W, n))
                          * rng.random((W, n)) ** 4).astype(np.float32))
    from repro_torch.core.compress import magnitude_threshold
    return a, magnitude_threshold(a.abs(), max(1, n // 50))


@pytest.mark.parametrize("wire", WIRES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("union", [False, True])
def test_select_ef_mean_partial_finishes_to_the_full_mean(W, wire, union):
    """The partial row sum, finished by `finish_mean` (the division or
    the f32 reciprocal multiply, rounded to the wire), is bitwise the
    full mode's mean, and the residual is the same."""
    from repro_torch.kernels import compress as KC
    a, t = _b3_inputs(W, 1031)
    full, res = KC.select_ef_mean(a, t, comm_dtype=wire, union=union)
    part, res_p = KC.select_ef_mean(a, t, comm_dtype=wire, union=union,
                                    partial=True)
    assert torch.equal(KC.finish_mean(part, W, wire), full)
    assert torch.equal(res_p, res)
    # split over two "ranks" (own supports): the halves' partials add up
    # to the whole's, up to the order of the f32 sum
    if not union:
        h = W // 2
        p0, _ = KC.select_ef_mean(a[:h], t[:h], comm_dtype=wire,
                                  union=False, partial=True)
        p1, _ = KC.select_ef_mean(a[h:], t[h:], comm_dtype=wire,
                                  union=False, partial=True)
        scale = float(part.abs().max())
        assert float((p0 + p1 - part).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("wire", WIRES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("partial", [False, True])
def test_select_ef_mean_mask_of_the_local_or_is_union(wire, partial):
    from repro_torch.core.reduce import LOCAL
    from repro_torch.kernels import compress as KC
    a, t = _b3_inputs(4, 1031, seed=1)
    mask = LOCAL.any_rows(a.abs() >= t.reshape(-1, 1))
    assert mask.dtype == torch.uint8 and mask.shape == (1, 1031)
    want = KC.select_ef_mean(a, t, comm_dtype=wire, union=True,
                             partial=partial)
    got = KC.select_ef_mean(a, t, comm_dtype=wire, union=True, mask=mask,
                            partial=partial)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # a wider mask keeps more: every column it names is delivered
    wide = torch.ones_like(mask)
    m, r = KC.select_ef_mean(a, t, comm_dtype=torch.float32, union=True,
                             mask=wide)
    assert torch.equal(r, torch.zeros_like(r))
    with pytest.raises(ValueError, match="union"):
        KC.select_ef_mean_plain(a, t, comm_dtype=wire, union=False,
                                mask=mask)


def test_select_ef_mean_cost_counts_the_mask_and_the_partial_cast():
    from repro_torch.kernels import compress as KC
    a, t = _b3_inputs(2, 100)
    mask = torch.ones((1, 100), dtype=torch.uint8)
    full = KC.select_ef_mean_cost(a, t, comm_dtype=torch.bfloat16,
                                  union=True)
    part = KC.select_ef_mean_cost(a, t, comm_dtype=torch.bfloat16,
                                  union=True, mask=mask, partial=True)
    assert part["bytes_read"] == full["bytes_read"] + 100
    assert full["casts"][0][2] == 3 * 100 and part["casts"][0][2] == 2 * 100


@pytest.mark.gpu
def test_cuda_select_ef_mean_modes_bitwise_the_plain_version():
    """B3's partial and external-mask modes on the card against the plain
    version, at a 16-byte-aligned n and an odd one; one launch counted
    per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    from repro_torch.kernels import compress as KC
    for W in (2, 4, 8):
        for n in (4096, 1031):
            a, t = _b3_inputs(W, n, seed=W)
            a, t = a.cuda(), t.cuda()
            mask = (a.abs() >= t.reshape(-1, 1)).any(0, keepdim=True) \
                .to(torch.uint8)
            for wire in WIRES:
                for kw in ({"union": False, "partial": True},
                           {"union": True, "mask": mask},
                           {"union": True, "mask": mask, "partial": True}):
                    before = KC.select_ef_mean.launches
                    got = KC.select_ef_mean(a, t, comm_dtype=wire, **kw)
                    assert KC.select_ef_mean.launches == before + 1
                    want = KC.select_ef_mean_plain(a, t, comm_dtype=wire,
                                                   **kw)
                    for x, y in zip(got, want):
                        assert torch.equal(x, y), (W, n, wire, kw)
                full = KC.select_ef_mean(a, t, comm_dtype=wire, union=True)
                part = KC.select_ef_mean(a, t, comm_dtype=wire, union=True,
                                         mask=mask, partial=True)
                assert torch.equal(KC.finish_mean(part[0], W, wire),
                                   full[0])

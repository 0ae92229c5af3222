"""The worker axis over real process groups: `repro_torch.launch.mesh`,
the Engine's mesh seam and the algorithms' worker seam
(`repro_torch.core.reduce.ProcessWorkers`), on gloo ranks spawned on the
CPU (`tests/torch_mesh_worker.py`; one torch thread each, a ``file://``
store under ``tmp_path``).  JAX runs only in this, the parent, process.

* A 1 x 1 mesh is bitwise ``mesh=None`` (the twin of the reference's
  ``test_small_mesh_end_to_end_jit``): the same row order, the same
  division by W.
* 2 and 4 ranks at W = 4 / 8 for ``dc_s3gd``, ``stale`` and ``ssgd`` on
  the reduced qwen3 and the reduced ResNet: every leaf of the gathered
  params, opt, comm and consensus weights within ``TOL_MESH`` of its own
  largest one-process magnitude, the metrics within ``RTOL_MESH``, and
  identical on every rank.  Across ranks the worker mean adds per-rank
  partial sums, an f32 rounding away from the one-process row order;
  the worst cases measured here are 4.1e-7 (params, about 3 ulps),
  1.1e-6 (opt), 8.8e-7 (comm) and 1.7e-7 (metrics).
* One 2-rank run against the JAX trajectory at `tests/test_torch_dc_s3gd.
  py`'s ``TOL`` and ``RTOL_METRICS``.
* Overlap == inline bitwise at 2 ranks.
* The worker-axis pieces that were refused across ranks until the slice
  that ported them (gossip, hierarchical, topk, dynamic_ssp, dc_asgd,
  elastic resize, hierarchical groups that cut through a rank's rows)
  now construct on a stand-in mesh of 2 ranks and run on spawned ones
  (`tests/test_torch_mesh_reducers.py` holds each to one process).  Over
  a 'model' axis the compressed and quantized wires, the overlap
  pipeline, gossip and dynamic_ssp construct too
  (`tests/test_torch_tp_wires.py` runs them).
* Hierarchical groups that cut through a rank's rows (W = 6, 3 groups
  over 2 ranks): bitwise one process, and within ``TOL_MESH`` of the
  reference's own GSPMD step on the (2, 1) mesh its ``mesh_for_spec``
  lays 6 workers on from 4 forced host devices.
* A membership over fewer ranks than the world (`SUBMESH`, 4 ranks): 8
  workers on all 4, 6 on the first 2, 5 on the first 1, 8 on all 4
  again, each mesh from ``mesh_for_spec`` (the first one reused at the
  end); the ranks outside a mesh take no step.  Over a 'model' axis of
  2 the reduced qwen3 goes 4 → 3 → 4 workers, (2, 2) → (1, 2) → (2, 2),
  within ``TOL_MESH`` of one process.  Under ``stale`` and
  under dc_s3gd through power-of-two counts (8 → 2 → 1 → 8) the
  gathered state is within ``TOL_MESH`` of one process through the same
  transitions; dc_s3gd through 6, 5 and back to 8 is held to its
  ``eval_params`` pins and transition log only: after a resize to 6 (or
  to 8: a sum of 8 equal f32 rows in row order is inexact for 44 % of
  values, in pairs over 4 ranks it is exact) its D is the rounding noise
  of a mean of equal rows, which Eq. 17's λ scales to λ0‖g‖
  (`tests/test_torch_mesh_reducers.py`), so 8 → 2 → 1 → 4 holds it.
* What stays refused names the reference's own limit: a resize to a W
  the live ranks cannot split without the seam of the mesh that carries
  it, ``fit`` through such a transition (both name
  ``launch.mesh.mesh_for_spec``), and a mesh larger than the world.
"""
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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

FUSED = {"buckets": 2, "use_kernels": True}
# (model, algorithm spec, W) of each run a group of ranks makes
R1 = [("lm", FUSED, 2), ("lm", {**FUSED, "overlap": True}, 2),
      ("lm", {"algo": "ssgd"}, 2)]
ELASTIC_RUN = ("cnn", {"algo": "stale", **FUSED, "elastic": [
    {"step": s, "kind": "leave", "worker": w}
    for s, w in ((1, "w1"), (1, "w5"), (2, "w2"), (2, "w6"))]}, 8)
R2 = [("lm", FUSED, 4), ("lm", {**FUSED, "overlap": True}, 4),
      ("lm", {"algo": "stale", **FUSED}, 4),
      ("lm", {"algo": "ssgd", "buckets": 2}, 4), ("lm", {}, 4),
      ("cnn", FUSED, 8), ("cnn", {"algo": "stale", **FUSED}, 8),
      ("cnn", {"algo": "ssgd"}, 8)]
R4 = [("lm", FUSED, 8), ("lm", {"algo": "stale"}, 8),
      ("lm", {"algo": "ssgd"}, 8), ("lm", FUSED, 4), ("cnn", FUSED, 8)]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


SPREAD_W = 6


@functools.lru_cache(maxsize=None)
def _spread_weights():
    """Per-worker weights (6, ...): the init plus 1e-2 x a per-worker
    standard normal draw (numpy, seed 5).  From equal workers the first
    mix of 3 group means is the rounding noise of (3w)/3, which Eq. 17's
    λ scales to λ0‖g‖ (gossip's case, ROADMAP queue C)."""
    rng = np.random.default_rng(5)
    return jax.tree.map(
        lambda p: (p[None] + 1e-2 * rng.standard_normal((SPREAD_W,)
                                                        + p.shape))
        .astype(np.float32), _weights())


# the spawned run of `ranks("r2")` each lifted piece is held by here (the
# reducers and dc_asgd: `tests/test_torch_mesh_reducers.py`)
LIFTED_RUN = {"gossip": ("lm", {**FUSED, "reducer": "gossip"}, 4),
              "hierarchical": ("lm", {**FUSED, "reducer": "hierarchical"},
                               4),
              "hierarchical_layout": ("lm", {**FUSED,
                                             "reducer": "hierarchical",
                                             "reducer_opts": {"groups": 3},
                                             "spread": True}, 6),
              "topk": ("lm", {**FUSED, "reducer": "topk"}, 4),
              "dynamic_ssp": ("lm", {**FUSED, "staleness": "dynamic_ssp",
                                     "cfg": {"ssp_threshold": 1},
                                     "skew": (3.0, 1.0)}, 4),
              "dc_asgd": ("lm", {"algo": "dc_asgd"}, 4)}
LIFTED = list(LIFTED_RUN.values()) + [ELASTIC_RUN]


def _leave(step, *ids):
    return [{"step": step, "kind": "leave", "worker": w} for w in ids]


# elastic runs over the meshes `mesh_for_spec` lays each membership on (4
# ranks: 8 on all, 6 on 2, 5 on 1, 8 on all; 8 on all, 2 on 2, 1 on 1, 4
# on all), 2 steps a membership; (id, algorithm spec, events, what is
# held): dc_s3gd's 8 → 2 → 1 → 4 with the overlap pipeline (re-issued on
# each new mesh), SSGD with topk (a worker's residual share handed over);
# and the lm over 'model' = 2: 4 workers on (2, 2), 3 on (1, 2) (ranks 2
# and 3 outside), 4 again (each model coordinate's shards handed over)
E8658 = _leave(2, "w1", "w5") + _leave(4, "w2") + [
    {"step": 6, "kind": "join", "count": 3}]
E8214 = _leave(2, *(f"w{i}" for i in range(1, 7))) + _leave(4, "w7") + [
    {"step": 6, "kind": "join", "count": 3}]
E434 = _leave(2, "w1") + [{"step": 4, "kind": "join", "count": 1}]
SUBMESH_RUNS = [
    ("stale-8-6-5-8", "cnn", {"algo": "stale", **FUSED}, 8, E8658, "tol"),
    ("dc_s3gd-8-6-5-8", "cnn", FUSED, 8, E8658, "pins"),
    ("dc_s3gd-overlap-8-2-1-4", "cnn", {**FUSED, "overlap": True}, 8,
     E8214, "tol"),
    ("ssgd-topk-8-6-5-8", "cnn", {"algo": "ssgd", "buckets": 2,
                                  "reducer": "topk"}, 8, E8658, "tol"),
    ("stale-model2-4-3-4", "lm", {"algo": "stale", **FUSED, "model": 2}, 4,
     E434, "tol")]
SUBMESH_STEPS = 8
SUBMESH = [(m, {**spec, "elastic": ev, "relayout": True,
                "steps": SUBMESH_STEPS}, W)
           for _, m, spec, W, ev, _ in SUBMESH_RUNS]


def _segments(events) -> list:
    """The steps of each membership of an elastic run."""
    bounds = [0] + sorted({e["step"] for e in events}) + [SUBMESH_STEPS]
    return [b - a for a, b in zip(bounds, bounds[1:])]

CUT_RUN = len(R2) + list(LIFTED_RUN).index("hierarchical_layout")

# world size and runs of each group; the 4 ranks lay out as pods (2, 2, 1)
GROUPS = {"r1": (1, dict(runs=R1)),
          "r2": (2, dict(runs=R2 + LIFTED, keep=(0, 1, CUT_RUN))),
          "r4": (4, dict(runs=R4 + SUBMESH, layout="pods"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each group's spawned results, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            world, kw = GROUPS[name]
            tmp = tmp_path_factory.mktemp(name)
            kw = dict(kw, weights=_weights(), ckpt_dir=str(tmp),
                      spread=_spread_weights())
            cache[name] = MW.spawn(world, "runs", kw, tmp)
        return cache[name]
    return get


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_bitwise(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert np.array_equal(x, y), what


def _assert_close(a, b, tol, what, base=None):
    la, lb = _leaves(a), _leaves(b)
    base = [0.0] * len(la) if base is None else _leaves(base)
    assert len(la) == len(lb), what
    for x, y, z in zip(la, lb, base):
        x, y = np.asarray(x, np.float64) - z, np.asarray(y, np.float64) - z
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=tol * float(np.abs(y).max()),
                                   err_msg=what)


@pytest.mark.parametrize("i", range(len(R1)))
def test_one_rank_mesh_is_bitwise_one_process(ranks, i):
    (res,) = ranks("r1")
    got = res["runs"][i]
    for part in MW.PARTS:
        assert got["diff"][part] == (0.0, True), part
    assert got["hist"] == got["hist_one"]


# (the lifted pieces' runs in "r2" are read by the refusal tests)
CASES = [(g, i) for g, runs in (("r2", R2), ("r4", R4))
         for i in range(len(runs))]


@pytest.mark.parametrize("group,i", CASES,
                         ids=[f"{g}-{GROUPS[g][1]['runs'][i][0]}-{i}" for g, i in CASES])
def test_ranks_match_one_process(ranks, group, i):
    res = ranks(group)
    # the gathered state is the same on every rank, and so are the
    # metrics: one all-reduce of the step's sums
    for r in res[1:]:
        assert r["runs"][i]["digest"] == res[0]["runs"][i]["digest"]
        assert r["runs"][i]["hist"] == res[0]["runs"][i]["hist"]
    got = res[0]["runs"][i]
    for part in MW.PARTS:
        assert got["diff"][part][0] <= TOL_MESH, (part, got["diff"][part])
    assert len(got["hist"]) == len(got["hist_one"]) == MW.STEPS
    for hg, hw in zip(got["hist"], got["hist_one"]):
        assert hg.keys() == hw.keys()
        for k in hg:
            np.testing.assert_allclose(hg[k], hw[k], rtol=RTOL_MESH,
                                       atol=1e-12, err_msg=k)


def test_worker_rows_are_pod_major(ranks):
    res = ranks("r4")
    assert [r["worker_index"] for r in res] == [0, 1, 2, 3]
    assert res[0]["mesh"] == {"pod": 2, "data": 2, "model": 1}


def _jax_run(W, buckets, kernels):
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    model = JModel(cfg, remat=False)
    alg = j_registry.make("dc_s3gd", JConfig(**MW.HP), n_workers=W,
                          buckets=buckets, use_kernels=kernels)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    data = JData(cfg.vocab_size, MW.SEQ, seed=0)
    hist = []
    for t in range(MW.STEPS):
        state, m = step(state, j_worker_batches(data, t, W, MW.BPW))
        hist.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state), hist


def test_two_ranks_match_jax(ranks):
    """The 2-rank fused bucketed run (W = 4) against the reference's
    trajectory at the parity tests' tolerances."""
    got = ranks("r2")[0]["runs"][0]["state"]
    j_state, j_hist = _jax_run(4, 2, True)
    _assert_close(got["params"], j_state.params, TOL, "params",
                  base=_weights())
    _assert_close(got["opt"]["m"], j_state.opt["m"], TOL, "opt.m")
    _assert_close(got["comm"]["delta_prev"], j_state.comm["delta_prev"], TOL,
                  "delta_prev")
    for hg, hj in zip(got["hist"], j_hist):
        for k in METRICS:
            np.testing.assert_allclose(hg[k], hj[k], rtol=RTOL_METRICS,
                                       err_msg=k)


def test_overlap_equals_inline_bitwise_on_two_ranks(ranks):
    """The pipelined issue is an asynchronous all-reduce the next step
    waits on: bitwise the inline schedule's wait before D."""
    res = ranks("r2")
    inline, overlap = (res[0]["runs"][i]["state"] for i in (0, 1))
    for part in ("params", "opt", "eval"):
        _assert_bitwise(overlap[part], inline[part], part)
    _assert_bitwise(overlap["comm"]["delta_prev"],
                    inline["comm"]["delta_prev"], "delta_prev")
    for r in res:
        assert r["runs"][1]["hist"] == r["runs"][0]["hist"]


@pytest.mark.parametrize("i", [0, 1], ids=["inline", "overlap"])
def test_checkpoint_round_trip_on_two_ranks(ranks, i):
    """`Engine.save` on a mesh waits for an in-flight overlap reduce,
    gathers and lets worker rank 0 write; `Engine.restore` gives each rank
    its shards back bit for bit."""
    res = ranks("r2")
    assert [r["runs"][i]["restored"] for r in res] == [True, True]


ROOT = Path(__file__).resolve().parents[1]

_REFERENCE_CUT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.cluster import ClusterSpec
from repro.configs import get_config, reduced
from repro.core import registry
from repro.core.types import DCS3GDConfig
from repro.data import SyntheticLMDataset, worker_batches
from repro.launch.engine import Engine
from repro.launch.mesh import mesh_for_spec
from repro.models.transformer import Model
mesh = mesh_for_spec(ClusterSpec.uniform(6))
assert dict(mesh.shape) == {{"data": 2, "model": 1}}, mesh.shape
cfg = reduced(get_config("qwen3-0.6b"))
model = Model(cfg, remat=False)
dc = DCS3GDConfig(**{hp})
alg = registry.make("dc_s3gd", dc, n_workers=6, buckets=2,
                    reducer=registry.make_reducer("hierarchical", dc,
                                                  groups=3))
engine = Engine(model, alg, mesh=mesh)
params = model.init(jax.random.PRNGKey(0))
data = SyntheticLMDataset(cfg.vocab_size, {seq}, seed=0)
step = engine.jit_train_step(alg.init(params), worker_batches(data, 0, 6, {bpw}),
                             donate=False)
spread = np.load(sys.argv[2])
state = alg.init(params)
state = state._replace(params=jax.tree.unflatten(
    jax.tree.structure(params),
    [spread[f"l{{i}}"] for i in range(len(spread.files))]))
losses = []
for t in range({steps}):
    state, m = step(state, worker_batches(data, t, 6, {bpw}))
    losses.append(float(m["loss"]))
leaves = jax.tree.leaves(state.params) + jax.tree.leaves(state.opt) + \\
    jax.tree.leaves(state.comm)
np.savez(sys.argv[1], losses=np.asarray(losses),
         **{{f"l{{i}}": np.asarray(x) for i, x in enumerate(leaves)}})
"""


def test_hierarchical_groups_across_ranks_match_the_reference_mesh(
        ranks, tmp_path):
    """3 hierarchical groups of 2 over 2 ranks of 3 rows (group 1 is rank
    0's row 2 and rank 1's row 0), fused bucketed, 3 steps from spread
    per-worker weights: bitwise one process, and within the parity
    tests' ``TOL`` of the reference's own GSPMD step (its unfused tail)
    on the (2, 1) mesh its ``mesh_for_spec`` lays 6 workers on from 4
    forced host devices (bitwise its own one-process step there), each
    leaf at its own largest magnitude (the params' moves from the
    weights): 1.8e-5 measured, XLA's rounding against torch's, as in
    every parity test."""
    got = ranks("r2")[0]["runs"][CUT_RUN]
    for part in ("params", "opt", "comm"):
        assert got["diff"][part] == (0.0, True), (part, got["diff"][part])
    out = tmp_path / "ref.npz"
    np.savez(tmp_path / "spread.npz", **{
        f"l{i}": x for i, x in enumerate(_leaves(_spread_weights()))})
    code = _REFERENCE_CUT.format(hp=repr(MW.HP), seq=MW.SEQ, bpw=MW.BPW,
                                 steps=MW.STEPS)
    r = subprocess.run([sys.executable, "-c", code, str(out),
                        str(tmp_path / "spread.npz")],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    state = got["state"]
    mine = _leaves(state["params"]) + _leaves(state["opt"]) + \
        _leaves(state["comm"])
    assert len(ref.files) == len(mine) + 1
    theirs = [ref[f"l{i}"] for i in range(len(mine))]
    n = len(_leaves(state["params"]))
    _assert_close(mine[:n], theirs[:n], TOL, "params",
                  base=_spread_weights())
    _assert_close(mine[n:], theirs[n:], TOL, "opt, delta_prev")
    np.testing.assert_allclose([h["loss"] for h in got["hist"]],
                               ref["losses"], rtol=RTOL_METRICS)


# ---------------------------------------------------------------------------
# refusals, at Engine construction (a stand-in mesh: no process group)
# ---------------------------------------------------------------------------


class _Mesh:
    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


# name -> (algorithm spec, stand-in mesh, None where the piece now
# constructs across ranks, or MODEL where it constructs over a 'model'
# axis)
MODEL = "model"
REFUSED = {
    # a 'model' axis above 1 trains every family under every piece, the
    # compressed and quantized wires too (they reduce the whole buckets)
    "model_axis": ({"overlap": True, "buckets": 2,
                    "cfg": {"comm_dtype": "int8"}}, dict(data=2, model=2),
                   MODEL),
    "model_axis_topk": ({"reducer": "topk", "buckets": 2},
                        dict(data=1, model=2), MODEL),
    "model_axis_gossip": ({"reducer": "gossip",
                           "cfg": {"comm_dtype": "fp8"}},
                          dict(data=1, model=2), MODEL),
    "model_axis_dynamic_ssp": ({"staleness": "dynamic_ssp",
                                "reducer": "randk", "buckets": 2},
                               dict(data=1, model=2), MODEL),
    # hierarchical groups that cut through a rank's rows (3 groups over 2)
    "hierarchical_layout": ({"reducer": "hierarchical",
                             "reducer_opts": {"groups": 3}},
                            dict(data=2, model=1), None),
    # ported across the worker ranks: they construct, and run spawned
    "gossip": ({"reducer": "gossip", "buckets": 2}, dict(data=2, model=1),
               None),
    "hierarchical": ({"reducer": "hierarchical"}, dict(data=2, model=1),
                     None),
    "topk": ({"reducer": "topk", "buckets": 2}, dict(data=2, model=1), None),
    "dynamic_ssp": ({"staleness": "dynamic_ssp"}, dict(data=2, model=1),
                    None),
    "dc_asgd": ({"algo": "dc_asgd"}, dict(data=2, model=1), None),
}
def _stand_in_workers(monkeypatch):
    from repro_torch.core.reduce import ProcessWorkers
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(M, "make_workers", lambda mesh: ProcessWorkers(
        None, rank=0, size=M.n_workers(mesh)))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_raise_at_construction(ranks, monkeypatch, name):
    """What was refused until the worker-axis slices constructs on 2
    ranks, and its spawned 2-rank run (`LIFTED_RUN`) tracks one process;
    what was refused over 'model' constructs there and binds to the
    axis."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.parallel.tensor import ModelAxis
    spec, shape, words = REFUSED[name]
    _stand_in_workers(monkeypatch)
    model = types.SimpleNamespace(loss=None, cfg=None)
    if words == MODEL:
        monkeypatch.setattr(M, "model_axis", lambda mesh: ModelAxis(
            None, rank=0, size=M.model_size(mesh)))
        eng = Engine(model, MW._make(spec, 4), mesh=_Mesh(**shape))
        assert eng.alg.model_axis is eng.model_axis
        assert eng.model_axis.size == 2
        return
    assert words is None
    eng = Engine(model, MW._make(spec, 4), mesh=_Mesh(**shape))
    assert eng.workers.size == 2 and eng.alg.workers is eng.workers
    run = ranks("r2")[0]["runs"][
        GROUPS["r2"][1]["runs"].index(LIFTED_RUN[name])]
    for part in MW.PARTS:
        assert run["diff"][part][0] <= TOL_MESH, (part, run["diff"])


def test_elastic_fit_and_resize_refused_across_ranks(ranks, monkeypatch):
    """Elastic resize runs across ranks (the spawned 8 → 6 → 4 run of
    `ranks("r2")`: ``eval_params`` bitwise across each resize) and onto
    the mesh that carries a W the live ranks cannot split (`SUBMESH`).
    Without that mesh's seam such a resize is refused, and so is ``fit``
    through such a transition, before any state changes: both name
    ``launch.mesh.mesh_for_spec``, the reference's own advice."""
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch.engine import Engine
    _stand_in_workers(monkeypatch)
    alg = MW._make({}, 4)
    engine = Engine(types.SimpleNamespace(loss=None), alg,
                    mesh=_Mesh(data=2, model=1))
    with pytest.raises(ValueError, match="mesh_for_spec") as e:
        alg.resize_state(None, 3)
    assert "workers=launch.mesh.make_workers(mesh)" in str(e.value)
    mem = Membership(alg, faults=FaultSchedule.from_json(
        {"seed": 0, "events": _leave(0, "w1")}))
    with pytest.raises(ValueError, match="mesh_for_spec") as e:
        engine.fit("state", lambda it, w: None, steps=2, membership=mem)
    assert "3 workers does not split over this mesh's 2" in str(e.value)
    assert mem.n_workers == 4 and mem.log == [] and engine.alg is alg
    run = ranks("r2")[0]["runs"][GROUPS["r2"][1]["runs"].index(ELASTIC_RUN)]
    assert run["pins"] == [True, True]
    assert [h["n_workers"] for h in run["hist"]] == [8, 6, 4]
    assert run["log"] == run["log_one"]
    for part in MW.PARTS:
        assert run["diff"][part][0] <= TOL_MESH, (part, run["diff"])
    sub = ranks("r4")[0]["runs"][len(R4)]
    assert [h["n_workers"] for h in sub["hist"]] == [8, 8, 6, 6, 5, 5, 8, 8]
    # a model axis above 1 keeps its specs for the dry-run
    Engine(types.SimpleNamespace(loss=None, cfg=None), MW._make({}, 4),
           mesh=_Mesh(data=2, model=2), specs_only=True)


@pytest.mark.parametrize("i", range(len(SUBMESH_RUNS)),
                         ids=[r[0] for r in SUBMESH_RUNS])
def test_membership_over_fewer_ranks_matches_one_process(ranks, i):
    """Each membership on the ranks ``mesh_for_spec`` lays it on: the
    same metrics on every rank that took the step, ``eval_params``
    bitwise across every resize (the hand-over of the consensus to the
    ranks that rejoin included), the transition log one process's, and
    the gathered state within ``TOL_MESH`` of one process's (see the
    module docstring for dc_s3gd through 6 workers)."""
    res = ranks("r4")
    events, what = SUBMESH_RUNS[i][4:]
    j = len(R4) + i
    got = res[0]["runs"][j]
    for r in res:
        mine = r["runs"][j]["hist"]
        taken = {h["step"] for h in mine}
        assert mine == [h for h in got["hist"] if h["step"] in taken]
        assert r["runs"][j]["digest"] == got["digest"]
    assert len(got["hist"]) == len(got["hist_one"]) == SUBMESH_STEPS
    assert got["pins"] == [True] * (len(_segments(events)) - 1), got["pins"]
    assert got["log"] == got["log_one"]
    assert [h["n_workers"] for h in got["hist"]] == \
        [h["n_workers"] for h in got["hist_one"]]
    if what == "pins":
        return
    for part in MW.PARTS:
        assert got["diff"][part][0] <= TOL_MESH, (part, got["diff"][part])


@pytest.mark.parametrize("i", range(len(SUBMESH_RUNS)),
                         ids=[r[0] for r in SUBMESH_RUNS])
def test_ranks_outside_the_mesh_take_no_step(ranks, i):
    """Per membership, the ranks ``mesh_for_spec`` leaves outside the
    mesh hold no rows, take no step and launch neither A1 nor A2 (their
    counters stay 0; on the CPU no kernel launches anywhere, the card's
    run counts them); the ranks inside take every step."""
    from repro_torch.cluster import ClusterSpec
    from repro_torch.launch.mesh import shape_for_spec
    res = ranks("r4")
    j = len(R4) + i
    tp = SUBMESH_RUNS[i][2].get("model", 1)
    lengths = _segments(SUBMESH_RUNS[i][4])
    for rank, r in enumerate(res):
        segs = r["runs"][j]["segments"]
        assert len(segs) == len(lengths)
        for (W, steps, a1, a2, holds, shape, _), n in zip(segs, lengths):
            used = int(np.prod(shape_for_spec(ClusterSpec.uniform(W),
                                              model=tp,
                                              n_devices=len(res))[0]))
            assert holds == (rank < used), (rank, W)
            assert steps == (n if holds else 0), (rank, W, steps)
            if not holds:
                assert a1 == a2 == 0, (rank, W, a1, a2)


def test_mesh_module_touches_no_process_group():
    import torch.distributed as dist
    import repro_torch.launch.mesh as M
    assert not dist.is_initialized()
    assert M.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    with pytest.raises(RuntimeError, match="process group"):
        M.make_debug_mesh(1, 1, device_type="cpu")


@pytest.mark.parametrize("W,pods,devices,want", [
    (8, 1, 4, ((4, 1), ("data", "model"))),
    (8, 2, 4, ((2, 2, 1), ("pod", "data", "model"))),
    (6, 2, 4, ((2, 1, 1), ("pod", "data", "model"))),
    (6, 1, 4, ((2, 1), ("data", "model"))),
    (32, 2, 512, ((2, 16, 1), ("pod", "data", "model"))),
])
def test_shape_for_spec_follows_the_reference_arithmetic(W, pods, devices,
                                                         want):
    from repro_torch.cluster import ClusterSpec
    from repro_torch.launch.mesh import shape_for_spec
    assert shape_for_spec(ClusterSpec.uniform(W, pods=pods),
                          n_devices=devices) == want


def test_mesh_for_spec_refuses_a_mesh_that_misses_ranks(ranks):
    """A membership is laid over the first ranks of the world (4 ranks: 6
    workers on a (2, 1) mesh of ranks 0 and 1, 5 on rank 0 alone), the
    others outside it; a mesh that comes back is the one built before.  A
    mesh larger than the world is refused, naming the numbers (here 2
    model ranks asked of a one-rank world)."""
    import torch.distributed as dist
    from repro_torch.cluster import ClusterSpec
    from repro_torch.launch.mesh import mesh_for_spec
    segs = [r["runs"][len(R4)]["segments"] for r in ranks("r4")]
    assert [s[:2] + s[4:] for s in segs[0]] == [
        [8, 2, True, {"data": 4, "model": 1}, False],
        [6, 2, True, {"data": 2, "model": 1}, False],
        [5, 2, True, {"data": 1, "model": 1}, False],
        [8, 2, True, {"data": 4, "model": 1}, True]]
    assert [[s[4] for s in r] for r in segs] == [
        [True, True, True, True], [True, True, False, True],
        [True, False, False, True], [True, False, False, True]]
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="= 2 ranks; the world has 1"):
        mesh_for_spec(ClusterSpec.uniform(4), model=2, device_type="cpu")

"""The compressed and quantized wires over the mesh's 'model' axis: topk,
topk_exact, randk and powersgd (error-feedback, bucketed) and the int8 /
fp8 ``comm_dtype`` (bucketed and per leaf) reduce the reference's whole
buckets (whole leaves) on every model rank, gathered over the axis and
cut back after the reduce (`repro_torch.parallel.tensor.WholeWire`).
Gloo ranks spawned on the CPU (`tests/torch_tp_worker.py`, one spawn a
mesh), the reduced qwen3 (falcon-mamba for the per-leaf fp8 wire) at
W = 2, 3 steps, each against its ``mesh=None`` twin from the same
weights.

* Gathered sharded gradients differ from one process's in their last
  bits (the tensor-parallel partial sums add in another order), so a
  coordinate at a selection threshold or a quantum boundary may flip.
  Each run is held to a count: at most ``FLIPS`` of the params' and of
  the optimizer state's coordinates more than ``TW.TOL`` of their leaf's
  scale off (a weight's update, for params; 0 and 0 for the compressed
  wires, 32 and 2 for the bucketed int8 one, 20 and 0 for the per-leaf
  fp8 one measured here), and the carried wire state (deltas, residuals,
  randk's counter, powersgd's warm start) within it too.  SSGD's
  per-leaf int8 wire quantizes each step's gradients themselves: 1,090
  coordinates of its update flip here (``FLIPS_SSGD_INT8``), one quantum
  of a gradient each, where a rank that scaled its own shards would move
  most of them.
* The losses within ``RTOL_METRICS``; ``comm["reducer"]`` (residuals in
  the whole plan's layout, randk's counter and the coordinates of its
  last draw, powersgd's warm start) and the replicated leaves bitwise
  alike on the model ranks of a worker after every step.
* ``dc_s3gd`` fused and plain, ``stale`` fused and plain, ``ssgd``,
  bucketed and per leaf, on (1, 2); topk and int8 also on (2, 2).  The
  overlap pipeline under topk is bitwise the inline run; ``dynamic_ssp``
  under topk revokes its third window as one process does (its payload
  back in the residual); an elastic leave (4 -> 3 workers) resizes the
  whole-layout residual alike on both model ranks; a (1, 2) topk
  checkpoint restores under ``mesh=None`` bitwise.
"""
import numpy as np
import pytest

import torch_mesh_worker as MW
import torch_tp_jax as TJ
from torch_threads import one_torch_thread  # noqa: F401

FUSED = {"buckets": 2, "use_kernels": True}
TOPK = {**FUSED, "reducer": "topk"}
INT8 = {**FUSED, "cfg": {"comm_dtype": "int8"}}
# name -> (config, algorithm spec, W) of each (1, 2) run
RUNS = {
    "topk": ("qwen3", TOPK, 2),
    "topk_exact": ("qwen3", {**FUSED, "reducer": "topk_exact"}, 2),
    "randk_stale": ("qwen3", {**FUSED, "algo": "stale", "reducer": "randk"},
                    2),
    # the plain (unfused) tail
    "powersgd": ("qwen3", {"buckets": 2, "reducer": "powersgd"}, 2),
    "int8": ("qwen3", INT8, 2),
    # per leaf, the plain tail
    "fp8_leaves": ("mamba", {"cfg": {"comm_dtype": "fp8"}}, 2),
    "int8_stale_leaves": ("qwen3", {"algo": "stale",
                                    "cfg": {"comm_dtype": "int8"}}, 2),
    "overlap": ("qwen3", {**TOPK, "overlap": True}, 2),
    "dynamic_ssp": ("qwen3", {"reducer": "topk", "buckets": 2,
                              "staleness": "dynamic_ssp",
                              "skew": (8.0, 1.0)}, 2),
    "resize": ("qwen3", {**TOPK, "elastic": [
        {"step": 1, "kind": "leave", "worker": "w1"}]}, 4),
    "ssgd_topk": ("qwen3", {"algo": "ssgd", "reducer": "topk",
                            "buckets": 2}, 2),
    "ssgd_int8_leaves": ("qwen3", {"algo": "ssgd",
                                   "cfg": {"comm_dtype": "int8"}}, 2),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MESH_RUNS = {"1x2": list(RUNS), "2x2": ["topk", "int8"]}
RTOL_METRICS = 1e-5
# flipped coordinates a 3-step run may hold (tests/test_torch_tp_
# reference.py's bound against the reference)
FLIPS = 300
FLIPS_SSGD_INT8 = 3000
REVOKED = [1.0, 1.0, 0.0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's spawned results, computed once; the (1, 2) topk run
    also goes through a checkpoint."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape = MESHES[mesh]
            tmp = tmp_path_factory.mktemp(mesh)
            runs = [RUNS[k] for k in MESH_RUNS[mesh]]
            kw = dict(shape=shape, runs=runs,
                      keep=(0,) if mesh == "1x2" else (),
                      weights={n: TJ.weights(n) for n, _, _ in runs},
                      ckpt_dir=str(tmp))
            cache[mesh] = MW.spawn(shape[0] * shape[1], "tp", kw, tmp,
                                   module="torch_tp_worker")
        return cache[mesh]
    return get


CASES = [(m, k) for m in MESHES for k in MESH_RUNS[m]]


def _run(ranks, mesh, name):
    res = ranks(mesh)
    return res, MESH_RUNS[mesh].index(name)


@pytest.mark.parametrize("mesh,name", CASES,
                         ids=[f"{m}-{k}" for m, k in CASES])
def test_wire_tracks_one_process(ranks, mesh, name):
    res, i = _run(ranks, mesh, name)
    got = res[0]["runs"][i]
    bound = FLIPS_SSGD_INT8 if name == "ssgd_int8_leaves" else FLIPS
    flips = got["flips"]
    assert max(flips["params"], flips["opt"], flips["comm"]) <= bound, flips
    assert len(got["hist"]) == len(got["hist_one"]) == MW.STEPS
    for hg, hw in zip(got["hist"], got["hist_one"]):
        assert hg.keys() == hw.keys()
        for k in hg:
            np.testing.assert_allclose(hg[k], hw[k], rtol=RTOL_METRICS,
                                       atol=1e-12, err_msg=k)
    # every rank gathers the same state and reports the same metrics
    for r in res[1:]:
        assert r["runs"][i]["digest"] == got["digest"]
        assert r["runs"][i]["hist"] == got["hist"]


@pytest.mark.parametrize("mesh,name", CASES,
                         ids=[f"{m}-{k}" for m, k in CASES])
def test_wire_state_bitwise_across_model_ranks(ranks, mesh, name):
    """The reducer's whole-layout state (and randk's draws), the
    replicated leaves and their deltas: the same bits on both model
    ranks of a worker after every step."""
    res, i = _run(ranks, mesh, name)
    spec = RUNS[name][1]
    # a run under one `Engine.fit` (a straggler, a leave) digests once
    n = 1 if "skew" in spec or "elastic" in spec else MW.STEPS
    by_worker = {}
    for r in res:
        by_worker.setdefault(r["worker_index"], []).append(
            r["runs"][i]["digests"])
    for digests in by_worker.values():
        assert len(digests) == 2 and len(digests[0]) == n
        assert digests[0] == digests[1]


def test_overlap_is_bitwise_inline_under_topk(ranks):
    runs = ranks("1x2")[0]["runs"]
    assert runs[MESH_RUNS["1x2"].index("overlap")]["trajectory"] \
        == runs[MESH_RUNS["1x2"].index("topk")]["trajectory"]


def test_dynamic_ssp_revokes_the_compressed_window(ranks):
    res, i = _run(ranks, "1x2", "dynamic_ssp")
    for r in res:
        assert [h["ssp_admit"] for h in r["runs"][i]["hist"]] == REVOKED
        assert r["runs"][i]["worker_steps"] \
            == res[0]["runs"][i]["worker_steps_one"]
    assert [h["ssp_admit"] for h in res[0]["runs"][i]["hist_one"]] \
        == REVOKED


def test_resize_spreads_the_whole_residual(ranks):
    res, i = _run(ranks, "1x2", "resize")
    for r in res:
        assert [h["n_workers"] for h in r["runs"][i]["hist"]] == [4, 3, 3]
    assert [h["n_workers"] for h in res[0]["runs"][i]["hist_one"]] \
        == [4, 3, 3]


def test_topk_checkpoint_restores_under_mesh_none(ranks):
    """Saved under (1, 2), the whole-layout residual as it is: restored
    with ``mesh=None`` bitwise the gathered state, and by each rank bit
    for bit."""
    res, i = _run(ranks, "1x2", "topk")
    assert res[0]["runs"][i]["ckpt_bitwise"]
    assert all(r["runs"][i]["restored"] for r in res)

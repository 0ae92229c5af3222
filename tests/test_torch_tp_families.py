"""Tensor parallelism over 'model' for the families beyond dense and MoE:
gloo ranks spawned on the CPU (`tests/torch_tp_worker.py`, one torch
thread each) train the reduced falcon-mamba (Mamba: ``w_in``'s x / z
halves on different ranks), recurrentgemma (RG-LRU + windowed attention
on one KV head), minicpm3 (MLA: latents whole, heads sharded), whisper
(bidirectional encoder, cross-attention over it), qwen2-vl (the
column-parallel patch projection, M-RoPE; each batch carries its
patches) and olmoe under the all-experts oracle (``moe_dense``) at W = 2
through the fused bucketed tail, 3 steps, on (1, 2) and (2, 2) meshes.

* Every leaf of the gathered params, opt and carried deltas lies within
  ``TOL_TP`` of its own largest one-process magnitude; worker 0's
  gradients and logits of the first batch within ``TOL_GRAD``; the
  metrics within ``RTOL_METRICS_TP``.  recurrentgemma's RG-LRU leaves
  (``conv_b``, ``w_gate``: measured 5.5e-6 / 7.2e-6 from the reference's
  weights, where its gradients lie 2.6e-6 apart, the scale olmoe's
  gradients lie apart) are held leaf by leaf to the larger of
  ``TOL_TP`` and twice the one-process run's own move when every weight
  starts one ulp up (the nudge rule of `tests/test_torch_training_
  pieces.py`), that move itself within ``NUDGE_CAP`` of the leaf's
  scale, so the bound stays tight.
* The replicated leaves are bitwise equal across the model ranks after
  every step, each rank holds exactly the shards `local_slices` cuts,
  and a checkpoint saved under the mesh restores under ``mesh=None`` to
  the gathered state bitwise.
* The (1, 2) states against the JAX package's ``mesh=None`` trajectory
  from the same weights and batches, at the parity tolerances (a
  weight's update to one ulp of it, as `tests/test_torch_ssm_train.py`
  holds ``a_log``'s).
* `ModelAxis.gather_reduce`, the edge for ranks that read different
  slices of a gathered tensor, equals one-process autograd; the
  narrow-only `ModelAxis.gather` is wrong there.
"""
import jax
import numpy as np
import pytest

import torch_mesh_worker as MW
import torch_tp_jax as TJ
import torch_tp_worker as TW
from torch_threads import one_torch_thread  # noqa: F401

TOL_TP = 5e-6
TOL_GRAD = 5e-6
RTOL_METRICS_TP = 2e-6
# a nudged run's move stays this far inside its leaf's scale, so that
# twice the move is no vacuous bound
NUDGE_CAP = 1e-3
TOL, RTOL_METRICS = 1e-4, 1e-5        # tests/test_torch_dc_s3gd.py's

FUSED = {"buckets": 2, "use_kernels": True}
NAMES = ("mamba", "rgemma", "minicpm", "whisper", "qwen2vl", "olmoe_dense")
# recurrentgemma is held by the nudge rule (module docstring)
RUNS = [(n, {**FUSED, "nudge": True} if n == "rgemma" else FUSED, 2)
        for n in NAMES]
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# (1, 2) keeps every state (JAX, checkpoints); (2, 2) checkpoints mamba's
KEEP = {"1x2": tuple(range(len(NAMES))), "2x2": (0,)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape = MESHES[mesh]
            tmp = tmp_path_factory.mktemp(mesh)
            kw = dict(shape=shape, runs=RUNS, keep=KEEP[mesh],
                      weights={n: TJ.weights(n) for n in NAMES},
                      ckpt_dir=str(tmp))
            cache[mesh] = MW.spawn(shape[0] * shape[1], "tp", kw, tmp,
                                   module="torch_tp_worker")
        return cache[mesh]
    return get


def within_tolerance(run: dict, tol: float) -> None:
    """A run's gathered state against the one-process run's: each part
    within ``tol`` of its largest leaf magnitude, or, for a nudged run,
    each leaf within the larger of that and twice its move under the
    nudge; the metrics alike."""
    if "moves" not in run:
        for part, (worst, _) in run["diff"].items():
            assert worst <= tol, (part, worst)
        bound = [{k: 0.0 for k in h} for h in run["hist_one"]]
    else:
        for part, leaves in run["leaf_diff"].items():
            for j, ((d, scale), move) in enumerate(zip(
                    leaves, run["moves"][part])):
                # the nudge stays well inside the leaf: a bound tight
                # enough to catch a wrong shard
                assert move <= NUDGE_CAP * scale, (part, j, move, scale)
                assert d <= max(tol * scale, 2 * move), (part, j, d, scale,
                                                         move)
        bound = [{k: 2 * v for k, v in h.items()}
                 for h in run["hist_moves"]]
    assert len(run["hist"]) == len(run["hist_one"])
    for hg, hw, b in zip(run["hist"], run["hist_one"], bound):
        assert hg.keys() == hw.keys()
        for k in hg:
            np.testing.assert_allclose(hg[k], hw[k], rtol=RTOL_METRICS_TP,
                                       atol=max(1e-12, b.get(k, 0.0)),
                                       err_msg=k)


CASES = [(m, i) for m in MESHES for i in range(len(RUNS))]
IDS = [f"{m}-{RUNS[i][0]}" for m, i in CASES]


@pytest.mark.parametrize("mesh,i", CASES, ids=IDS)
def test_tracks_one_process(ranks, mesh, i):
    res = ranks(mesh)
    got = res[0]["runs"][i]
    within_tolerance(got, TOL_TP)
    assert got["grad_diff"] <= TOL_GRAD, got["grad_diff"]
    assert got["logits_diff"] <= TOL_GRAD, got["logits_diff"]
    assert got["grad_loss"] == pytest.approx(got["grad_loss_one"],
                                             rel=RTOL_METRICS_TP)
    assert got["hist"][-1]["lambda"] > 0
    for r in res[1:]:
        assert r["runs"][i]["digest"] == got["digest"]
        assert r["runs"][i]["hist"] == got["hist"]


@pytest.mark.parametrize("mesh,i", CASES, ids=IDS)
def test_replicated_leaves_bitwise_across_model_ranks(ranks, mesh, i):
    res = ranks(mesh)
    by_worker = {}
    for r in res:
        by_worker.setdefault(r["worker_index"], []).append(
            r["runs"][i]["digests"])
    for digests in by_worker.values():
        assert len(digests) == 2 and len(digests[0]) == MW.STEPS
        assert digests[0] == digests[1]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_rank_holds_its_local_slices(ranks, mesh):
    for r in ranks(mesh):
        for run in r["runs"]:
            assert run["local_shapes_ok"]
            assert run["n_sharded"] > 0


CKPT = [(m, i) for m in MESHES for i in KEEP[m]]


@pytest.mark.parametrize("mesh,i", CKPT,
                         ids=[f"{m}-{RUNS[i][0]}" for m, i in CKPT])
def test_checkpoint_under_model_ranks_restores_under_mesh_none(ranks, mesh,
                                                               i):
    res = ranks(mesh)
    assert res[0]["runs"][i]["ckpt_bitwise"]
    assert all(r["runs"][i]["restored"] for r in res)


def assert_parity(got, ref, base, what):
    """`TJ.assert_close` at the parity tolerance ``TOL``, a weight's
    update known to one ulp of the weight it moved."""
    la, lb = jax.tree.leaves(got), jax.tree.leaves(ref)
    lz = [None] * len(la) if base is None else jax.tree.leaves(base)
    assert len(la) == len(lb), what
    for j, (x, y, z) in enumerate(zip(la, lb, lz)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        ulp = 0.0
        if z is not None:
            x, y = x - z, y - z
            ulp = float(np.spacing(np.abs(np.asarray(z)).max()))
        np.testing.assert_allclose(
            x, y, rtol=0, atol=max(TOL * float(np.abs(y).max()), ulp),
            err_msg=f"{what} {j}")


@pytest.mark.parametrize("name", NAMES)
def test_two_model_ranks_match_jax(ranks, name):
    """The (1, 2) run against the reference's mesh=None trajectory from
    the same weights and batches."""
    run = ranks("1x2")[0]["runs"][NAMES.index(name)]
    got = run["state"]
    j_state, j_hist = TJ.jax_run(name, 2)
    assert_parity(got["params"], j_state.params, TJ.weights(name), "params")
    assert_parity(got["opt"]["m"], j_state.opt["m"], None, "opt.m")
    assert_parity(got["comm"]["delta_prev"], j_state.comm["delta_prev"],
                  None, "delta_prev")
    for hg, hj in zip(run["hist"], j_hist):
        for k in TJ.METRICS:
            np.testing.assert_allclose(hg[k], hj[k], rtol=RTOL_METRICS,
                                       atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def edge(tmp_path_factory):
    """`TW.case_edge` on two spawned ranks."""
    return MW.spawn(2, "edge", {}, tmp_path_factory.mktemp("edge"),
                    module="torch_tp_worker")


def test_gather_reduce_equals_one_process_autograd(edge):
    """Two ranks each gather a (B, S, 2e) product of their column block
    and keep their channels of both halves, as the Mamba block does:
    `ModelAxis.gather_reduce`'s gradients of the input and of each
    rank's weight block equal one-process autograd's."""
    for r in edge:
        assert r["gather_reduce"] <= 1e-6, r


def test_narrow_only_gather_is_wrong_for_sliced_consumers(edge):
    """The same graph through the narrow-only `ModelAxis.gather`: each
    rank keeps only its own share of the gradient of the slices the
    other rank read, so its gradients are far from one process's."""
    for r in edge:
        assert r["gather"] > 1e-2, r

"""Tensor parallelism over 'model' under the training pieces beyond
momentum with global λ, on the reduced qwen3 at W = 2, 3 steps, gloo
ranks spawned on the CPU (`tests/torch_tp_worker.py`): nesterov, adam
and LARS (its per-leaf norms summed over the axis in one collective),
per-tensor λ (each leaf's Eq. 17 norms alike), the overlap pipeline,
gossip and hierarchical (the packed local params mixed within the
worker group of each 'model' coordinate), ``dynamic_ssp`` under a
scripted straggler (worker 0 eight times slower, so the window is
revoked at step 2), DC-ASGD, SSGD under LARS and DC-ASGD under LARS with
per-tensor λ (both of its transaction's per-leaf norm sums), on a
(1, 2) mesh; gossip, hierarchical, DC-ASGD and the overlap pipeline
also on (2, 2).

* Each run tracks its ``mesh=None`` twin: every leaf of the gathered
  params, opt and comm within ``TOL_TP`` of its part's largest
  magnitude, the metrics within ``RTOL_METRICS_TP``.  Adam runs at
  ``eps = 1``: at its default 1e-8 its first step is lr·sign(g), a
  gradient at the rounding floor flips its sign, and the trajectory
  leaves any rounding-order twin (0.63 of the largest weight here; a
  one-ulp nudge of the weights does not bound it either), while at
  ``eps = 1`` its update's derivative in g is at most 1 / eps and the
  gradients' 1.5e-6 stay at their scale; the run still goes through
  its m / v / t slots, their shards and their gathering.  At its
  default eps Adam takes one step on (1, 2), held coordinate by
  coordinate to what its first update's slope allows
  (`test_adam_default_eps_first_step`).  DC-ASGD
  (Eq. 17's λ reaches 1.7e4 here) and the weight-mixing reducers (D =
  R(w) − w cancels down to the weights' last bits) are ill-conditioned
  in one process already: they are held leaf by leaf to the larger of
  ``TOL_TP`` and twice the one-process run's own move when every weight
  starts one ulp up, the nudge rule of `tests/test_torch_training_
  pieces.py` (measured without it: DC-ASGD 2.1e-5 on a q-norm momentum,
  gossip 1.1e-5 on a norm scale's), the move itself within
  ``NUDGE_CAP`` of the leaf's scale.
* The (1, 2) runs of per-tensor λ, SSGD under LARS and the two DC-ASGD
  runs against the reference's own GSPMD step on a (1, 2) mesh of two
  forced host devices (`TJ.reference_mesh`): every leaf within the
  larger of ``TOL_REF`` of its largest reference magnitude (of the
  weights' moves for params), one ulp of the weight, and twice the
  reference's own larger move from weights one ulp up or one ulp down
  (which of a leaf's elements a nudge flips is chance: on the card one
  direction alone missed DC-ASGD's mesh difference; that move within
  ``NUDGE_CAP`` of the scale); the losses within ``RTOL_REF``.  LARS
  under DC-S3GD is left out: the reference takes its norms over the
  worker-stacked leaf (`tests/test_torch_training_pieces.py`).
* The replicated leaves are bitwise across the model ranks after every
  step; overlap is bitwise the inline run over 'model' (params, opt and
  the carried deltas); ``dynamic_ssp``'s admits and counters are equal
  on every rank and equal the one-process run's; checkpoints of the
  overlap, gossip and ``dynamic_ssp`` runs restore under ``mesh=None``
  bitwise.
"""
import jax
import numpy as np
import pytest

from repro_torch.optim.local import Adam

import torch_mesh_worker as MW
import torch_tp_jax as TJ
from test_torch_tp_families import NUDGE_CAP, within_tolerance
from torch_threads import one_torch_thread  # noqa: F401

TOL_TP = 5e-6
FUSED = {"buckets": 2, "use_kernels": True}
PIECES = {
    "inline": FUSED,
    "nesterov": {"local_optimizer": "nesterov"},
    # eps = 1: see the module docstring
    "adam": {"local_optimizer": Adam(eps=1.0)},
    "lars": {"local_optimizer": "lars"},
    # bucketed as the reference's step is (its carried deltas compared)
    "per_tensor": {"buckets": 2, "cfg": {"lambda_norm": "per_tensor"}},
    "overlap": {**FUSED, "overlap": True},
    "gossip": {"reducer": "gossip", "buckets": 2, "nudge": True},
    "hierarchical": {"reducer": "hierarchical", "nudge": True},
    "dynamic_ssp": {"staleness": "dynamic_ssp", "skew": (8.0, 1.0)},
    "dc_asgd": {"algo": "dc_asgd", "nudge": True},
    # LARS's per-leaf norms under SSGD (no worker axis) and under DC-ASGD
    # with per-tensor λ, the transaction's two per-leaf norm sums
    "ssgd_lars": {"algo": "ssgd", "buckets": 2,
                  "cfg": {"local_optimizer": "lars"}},
    "dc_asgd_lars": {"algo": "dc_asgd", "nudge": True,
                     "cfg": {"local_optimizer": "lars",
                             "lambda_norm": "per_tensor"}},
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ON = {"1x2": tuple(PIECES),
      "2x2": ("inline", "overlap", "gossip", "hierarchical", "dc_asgd")}
CKPT = {"1x2": ("overlap", "gossip", "dynamic_ssp"), "2x2": ("overlap",)}
# the (1, 2) runs also held against the reference's own GSPMD step, by
# algorithm; the reference takes LARS's norms over the worker-stacked
# leaf under DC-S3GD (`tests/test_torch_training_pieces.py`), so LARS is
# held to it where the tree has no worker axis: SSGD and DC-ASGD
REF = {"per_tensor": "dc_s3gd", "ssgd_lars": "ssgd", "dc_asgd": "dc_asgd",
       "dc_asgd_lars": "dc_asgd"}
# Adam at its default eps, one step on (1, 2): its own test
# (`test_adam_default_eps_first_step`)
ADAM = {"local_optimizer": Adam(), "steps": 1}
TOL_REF, RTOL_REF = 1e-4, 1e-5      # tests/test_torch_tp_reference.py's


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape = MESHES[mesh]
            tmp = tmp_path_factory.mktemp(mesh)
            names = ON[mesh] + (("adam_default",) if mesh == "1x2"
                                else ())
            specs = {**PIECES, "adam_default": ADAM}
            kw = dict(shape=shape,
                      runs=[("qwen3", specs[n], 2) for n in names],
                      keep=tuple(names.index(n) for n in CKPT[mesh]),
                      states=tuple(names.index(n)
                                   for n in (*REF, "adam_default")
                                   if mesh == "1x2"),
                      weights={"qwen3": TJ.weights("qwen3")},
                      ckpt_dir=str(tmp))
            res = MW.spawn(shape[0] * shape[1], "tp", kw, tmp,
                           module="torch_tp_worker")
            cache[mesh] = [{**r, "runs": dict(zip(names, r["runs"]))}
                           for r in res]
        return cache[mesh]
    return get


CASES = [(m, n) for m in MESHES for n in ON[m]]
IDS = [f"{m}-{n}" for m, n in CASES]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_tracks_one_process(ranks, mesh, name):
    res = ranks(mesh)
    got = res[0]["runs"][name]
    within_tolerance(got, TOL_TP)
    if PIECES[name].get("algo") != "ssgd":
        assert got["hist"][-1]["lambda"] > 0
    for r in res[1:]:
        assert r["runs"][name]["digest"] == got["digest"]
        assert r["runs"][name]["hist"] == got["hist"]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_replicated_leaves_bitwise_across_model_ranks(ranks, mesh, name):
    by_worker = {}
    for r in ranks(mesh):
        by_worker.setdefault(r["worker_index"], []).append(
            r["runs"][name]["digests"])
    for digests in by_worker.values():
        assert len(digests) == 2 and digests[0] == digests[1]
        assert len(digests[0]) == (1 if name == "dynamic_ssp"
                                   else MW.STEPS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_overlap_is_bitwise_the_inline_run(ranks, mesh):
    for r in ranks(mesh):
        runs = r["runs"]
        assert runs["overlap"]["trajectory"] == runs["inline"]["trajectory"]
        assert runs["overlap"]["hist"] == runs["inline"]["hist"]


def test_dynamic_ssp_decides_alike_on_every_rank(ranks):
    res = ranks("1x2")
    run = res[0]["runs"]["dynamic_ssp"]
    admits = [h["ssp_admit"] for h in run["hist"]]
    assert admits == [1.0, 1.0, 0.0], admits
    for r in res:
        assert [h["ssp_admit"] for h in r["runs"]["dynamic_ssp"]["hist"]] \
            == admits
        assert r["runs"]["dynamic_ssp"]["worker_steps"] == \
            run["worker_steps_one"]
    assert [h["ssp_admit"] for h in run["hist_one"]] == admits


CK = [(m, n) for m in MESHES for n in CKPT[m]]


@pytest.mark.parametrize("mesh,name", CK, ids=[f"{m}-{n}" for m, n in CK])
def test_checkpoint_under_model_ranks_restores_under_mesh_none(ranks, mesh,
                                                               name):
    res = ranks(mesh)
    assert res[0]["runs"][name]["ckpt_bitwise"]
    assert all(r["runs"][name]["restored"] for r in res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Per `REF` piece, the reference's (1, 2) GSPMD run and its runs
    from weights one ulp up and one ulp down (`TJ.reference_mesh`)."""
    tmp = tmp_path_factory.mktemp("ref")
    return dict(zip(REF, TJ.reference_mesh(
        [("qwen3", PIECES[n].get("cfg", {}), algo, True)
         for n, algo in REF.items()], tmp)))


@pytest.mark.parametrize("name", sorted(REF))
def test_matches_the_reference_step_on_a_two_device_mesh(ranks, reference,
                                                         name):
    """Every leaf of the (1, 2) run's params (their moves), opt and comm
    within the larger of ``TOL_REF`` of the reference's largest
    magnitude, one ulp of the weight, and twice the reference's own
    larger move when its weights start one ulp up or one ulp down
    (DC-ASGD's λ and per-tensor λ are ill-conditioned in the reference
    itself); the losses within ``RTOL_REF``."""
    rec = ranks("1x2")[0]["runs"][name]
    ref, nudged = reference[name]
    for j, (x, y, ulp, _), *zs in zip(
            range(len(ref.files)), TJ.moves(rec, ref, "qwen3"),
            *(TJ.moves(rec, n, "qwen3") for n in nudged)):
        scale = float(np.abs(y).max())
        move = max(float(np.abs(y - z[1]).max()) for z in zs)
        assert move <= max(NUDGE_CAP * scale, ulp), (j, move, scale)
        np.testing.assert_allclose(
            x, y, rtol=0, atol=max(TOL_REF * scale, ulp, 2 * move),
            err_msg=f"leaf {j}")
    np.testing.assert_allclose([h["loss"] for h in rec["hist"]],
                               ref["losses"], rtol=RTOL_REF)


def test_adam_default_eps_first_step(ranks):
    """Adam at eps 1e-8, one step on (1, 2) against ``mesh=None``: the
    slots m, v (the gradient's first step: (1 − b1)·g, (1 − b2)·g²)
    within ``TOL_TP`` of each leaf's scale, t = 1 on both; each weight's
    update lr·g / (|g| + eps) within ``TOL_TP`` of its leaf's scale
    plus what the coordinate's own gradient difference δ (from m) can
    move it: at most lr·δ·eps / (max(|g| − δ, 0) + eps)², the map's
    largest slope within δ of g (a gradient at the rounding floor may
    flip its sign, the reason the trajectory runs use eps 1)."""
    run = ranks("1x2")[0]["runs"]["adam_default"]
    got, want = run["state"], run["state_one"]
    b1, eps, lr = 0.9, 1e-8, MW.HP["learning_rate"]
    assert int(got["opt"]["t"]) == int(want["opt"]["t"]) == 1
    for slot in ("m", "v"):
        for x, y in zip(jax.tree.leaves(got["opt"][slot]),
                        jax.tree.leaves(want["opt"][slot])):
            np.testing.assert_allclose(
                x, y, rtol=0, atol=TOL_TP * float(np.abs(y).max()))
    for p, q, mg, mw in zip(*(jax.tree.leaves(t) for t in (
            got["params"], want["params"], got["opt"]["m"],
            want["opt"]["m"]))):
        g = np.abs(np.asarray(mw, np.float64)) / (1 - b1)
        dg = np.abs(np.asarray(mg, np.float64) - mw) / (1 - b1)
        bound = TOL_TP * float(np.abs(q).max()) \
            + lr * dg * eps / (np.maximum(g - dg, 0.0) + eps) ** 2
        d = np.abs(np.asarray(p, np.float64) - q)
        assert (d <= bound).all(), float((d - bound).max())

"""Tensor parallelism over the mesh's 'model' axis
(`repro_torch.parallel.tensor`, `Engine(mesh=...)` with ``model > 1``):
gloo ranks spawned on the CPU (`tests/torch_tp_worker.py`, through
`tests/torch_mesh_worker.spawn`; one torch thread each, a ``file://``
store under ``tmp_path``).  JAX runs only in this, the parent, process
and in one subprocess of its own.

* ``(1, 2)`` and ``(2, 2)`` meshes train the reduced qwen3 (qk norm,
  GQA), granite (one KV head: k / v whole on every rank), stablelm
  (layernorm) and olmoe (routed experts, two a rank) at W = 2 through
  the fused bucketed tail: every leaf of the gathered params, opt and
  carried deltas within ``TOL_TP`` of its own largest one-process
  magnitude after 3 steps; worker 0's per-leaf gradients and logits
  (gathered over the vocabulary) of the first batch within
  ``TOL_GRAD``; the losses, λ and the ``distance_norm`` /
  ``delta_norm`` metrics within ``RTOL_METRICS_TP``.  The worst cases
  measured here: 3.1e-6 (state: qwen3's momentum), 2.7e-6 (gradients:
  olmoe), 9.2e-7 (metrics).  The partial products, the logsumexp and
  the norms add their shards in another order than one process does.
* On (1, 2) also ``stale``, ``ssgd``, the unfused per-leaf ``dc_s3gd``,
  and the reduced qwen3 at bf16 compute, the published configs' (the
  embedding's rows enter the first block in bf16): its state within
  ``TOL_TP_BF16`` (measured 9.9e-4 on `tok` and the first norm: 2 of
  the 7,680 elements of its first `tok` gradient differ, by one bf16
  ulp; every other leaf within 1e-5), its metrics within
  ``RTOL_METRICS_BF16`` (3.1e-5).
* The replicated leaves (norms, q / k norms, granite's k / v, the
  router) and their optimizer slots and deltas are bitwise equal across
  the model ranks after every step; each rank holds exactly the shards
  `sharding.local_slices` cuts.  The paper's CNN (no `ModelConfig`) runs
  replicated over 'model', bitwise the one-process run.
* The (1, 2) states against the JAX package's ``mesh=None`` trajectory
  at the parity tests' ``TOL`` / ``RTOL_METRICS``, and the qwen3 run
  against the reference's own step on a (1, 2) mesh of two forced host
  devices (GSPMD), in a subprocess.
* Vocab-parallel `chunked_xent` equals the one-process loss, padded
  columns included; a checkpoint saved under (1, 2) or (2, 2) restores
  under ``mesh=None`` to the gathered state bitwise; the compressed and
  quantized wires construct over 'model' for ``dc_s3gd``, ``stale`` and
  ``ssgd``, bucketed and per leaf (they run in
  `tests/test_torch_tp_wires.py`); what stays refused over 'model' (an
  indivisible dim) raises at `Engine` construction, naming its ROADMAP
  item; an Engine without an algorithm binds the model to the axis
  (serving: `tests/test_torch_tp_serve.py`), and the paged serving seam
  (a paged layout, its decode ops, chunked prefill, the Scheduler) is
  refused over 'model', naming the reference's one-process serving.
"""
import functools
import os
import json
import subprocess
import sys
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
import torch_tp_worker as TW
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL_TP = 5e-6
# under bf16 compute the embedding's rows enter the first block in bf16:
# the gradients reaching `tok` and that block's norm are rounded to bf16,
# and a per-rank f32 sum that lands on the other side of a rounding
# boundary than the one-process product's flips one bf16 ulp (2^-8)
TOL_TP_BF16 = 2e-3
RTOL_METRICS_BF16 = 1e-4
TOL_GRAD = 5e-6
RTOL_METRICS_TP = 2e-6
TOL, RTOL_METRICS = 1e-4, 1e-5        # tests/test_torch_dc_s3gd.py's
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")

FUSED = {"buckets": 2, "use_kernels": True}
# the dense and MoE families (the others: tests/test_torch_tp_families.py)
NAMES = ("qwen3", "granite", "stablelm", "olmoe")
# (config, algorithm spec, W) of each run a mesh makes
RUNS = [(n, FUSED, 2) for n in NAMES] + [
    ("qwen3_bf16", FUSED, 2),
    ("qwen3", {"algo": "stale", **FUSED}, 2),
    ("granite", {"algo": "ssgd", "buckets": 2}, 2),
    ("olmoe", {}, 2)]
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
# the (2, 2) mesh repeats the fused runs of the four configurations
MESH_RUNS = {"1x2": RUNS, "2x2": RUNS[:len(NAMES)]}


@functools.lru_cache(maxsize=None)
def _weights(name):
    cfg = j_reduced(j_get_config(TW.ARCHS[name.partition("_")[0]]))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's spawned results, computed once; on (1, 2) the fused
    runs come back whole and through a checkpoint."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            shape = MESHES[mesh]
            tmp = tmp_path_factory.mktemp(mesh)
            keep = tuple(range(len(NAMES))) if mesh == "1x2" else (0,)
            kw = dict(shape=shape, runs=MESH_RUNS[mesh], keep=keep,
                      weights={n: _weights(n) for n, _, _ in RUNS},
                      ckpt_dir=str(tmp))
            cache[mesh] = MW.spawn(shape[0] * shape[1], "tp", kw, tmp,
                                   module="torch_tp_worker")
        return cache[mesh]
    return get


CASES = [(m, i) for m in MESHES for i in range(len(MESH_RUNS[m]))]
IDS = [f"{m}-{RUNS[i][0]}-{RUNS[i][1].get('algo', 'dc_s3gd')}"
       f"{'-fused' if RUNS[i][1].get('use_kernels') else ''}"
       for m, i in CASES]


@pytest.mark.parametrize("mesh,i", CASES, ids=IDS)
def test_tracks_one_process(ranks, mesh, i):
    res = ranks(mesh)
    got = res[0]["runs"][i]
    tol = TOL_TP_BF16 if RUNS[i][0].endswith("_bf16") else TOL_TP
    for part, (worst, _) in got["diff"].items():
        assert worst <= tol, (part, worst)
    tol = TOL_TP_BF16 if RUNS[i][0].endswith("_bf16") else TOL_GRAD
    assert got["grad_diff"] <= tol, got["grad_diff"]
    # worker 0's logits of the first batch, gathered over the vocabulary
    assert got["logits_diff"] <= TOL_GRAD, got["logits_diff"]
    rtol = RTOL_METRICS_BF16 if RUNS[i][0].endswith("_bf16") \
        else RTOL_METRICS_TP
    assert got["grad_loss"] == pytest.approx(got["grad_loss_one"],
                                             rel=rtol)
    assert len(got["hist"]) == len(got["hist_one"]) == MW.STEPS
    for hg, hw in zip(got["hist"], got["hist_one"]):
        assert hg.keys() == hw.keys()
        for k in hg:
            np.testing.assert_allclose(hg[k], hw[k], rtol=rtol,
                                       atol=1e-12, err_msg=k)
    # every rank gathers the same state and reports the same metrics
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
    assert sorted(r["model_index"] for r in res) == \
        sorted(list(range(2)) * (len(res) // 2))
    for digests in by_worker.values():
        assert len(digests) == 2 and len(digests[0]) == MW.STEPS
        assert digests[0] == digests[1]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_rank_holds_its_local_slices(ranks, mesh):
    for r in ranks(mesh):
        for run in r["runs"]:
            assert run["local_shapes_ok"]
            assert run["n_sharded"] > 0


def _jax_run(name, W, buckets, kernels):
    cfg = j_reduced(j_get_config(TW.ARCHS[name]))
    model = JModel(cfg, remat=False)
    alg = j_registry.make("dc_s3gd", JConfig(**MW.HP), n_workers=W,
                          buckets=buckets, use_kernels=kernels)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights(name)))
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


@pytest.mark.parametrize("name", NAMES)
def test_two_model_ranks_match_jax(ranks, name):
    """The (1, 2) fused bucketed run against the reference's mesh=None
    trajectory from the same weights, at the parity tests' tolerances.
    The reference takes its unfused tail (the same arithmetic; its Pallas
    kernels in interpret mode cost 4x the jit time here)."""
    i = RUNS.index((name, FUSED, 2))
    got = ranks("1x2")[0]["runs"][i]["state"]
    j_state, j_hist = _jax_run(name, 2, 2, False)
    _assert_close(got["params"], j_state.params, TOL, "params",
                  base=_weights(name))
    _assert_close(got["opt"]["m"], j_state.opt["m"], TOL, "opt.m")
    _assert_close(got["comm"]["delta_prev"], j_state.comm["delta_prev"], TOL,
                  "delta_prev")
    for hg, hj in zip(ranks("1x2")[0]["runs"][i]["hist"], j_hist):
        for k in METRICS:
            np.testing.assert_allclose(hg[k], hj[k], rtol=RTOL_METRICS,
                                       err_msg=k)


_REFERENCE_MESH = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.configs import get_config, reduced
from repro.core import registry
from repro.core.types import DCS3GDConfig
from repro.data import SyntheticLMDataset, worker_batches
from repro.launch.engine import Engine
from repro.models.transformer import Model
cfg = reduced(get_config("qwen3-0.6b"))
model = Model(cfg, remat=False)
# the classic constructor: GSPMD's automatic axes (jax.make_mesh's default
# axis types are explicit in this jax, which its vmap refuses here)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 2),
                         ("data", "model"))
alg = registry.make("dc_s3gd", DCS3GDConfig(**{hp}), n_workers=2,
                    buckets=2)
engine = Engine(model, alg, mesh=mesh)
state = alg.init(model.init(jax.random.PRNGKey(0)))
data = SyntheticLMDataset(cfg.vocab_size, {seq}, seed=0)
batch = worker_batches(data, 0, 2, {bpw})
step = engine.jit_train_step(state, batch, donate=False)
losses = []
for t in range({steps}):
    state, m = step(state, worker_batches(data, t, 2, {bpw}))
    losses.append(float(m["loss"]))
assert len(jax.devices()) == 2
leaves = jax.tree.leaves(state.params) + jax.tree.leaves(state.opt) + \\
    jax.tree.leaves(state.comm)
np.savez(sys.argv[1], losses=np.asarray(losses),
         **{{f"l{{i}}": np.asarray(x) for i, x in enumerate(leaves)}})
"""


def test_matches_the_reference_step_on_a_two_device_mesh(ranks, tmp_path):
    """The reference's own GSPMD step on a (1, 2) mesh of two forced host
    CPU devices (its partition rules: heads, FFN and vocab over 'model';
    its unfused tail) against the port's (1, 2) ranks, qwen3 fused
    bucketed."""
    out = tmp_path / "ref.npz"
    code = _REFERENCE_MESH.format(hp=repr(MW.HP), seq=MW.SEQ, bpw=MW.BPW,
                                  steps=MW.STEPS)
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    run = ranks("1x2")[0]["runs"][RUNS.index(("qwen3", FUSED, 2))]
    got = run["state"]
    mine = jax.tree.leaves(got["params"]) + jax.tree.leaves(got["opt"]) + \
        jax.tree.leaves(got["comm"])
    theirs = [ref[f"l{i}"] for i in range(len(mine))]
    assert len(ref.files) == len(mine) + 1
    n = len(jax.tree.leaves(got["params"]))
    _assert_close(mine[:n], theirs[:n], TOL, "params",
                  base=jax.tree.leaves(_weights("qwen3")))
    _assert_close(mine[n:], theirs[n:], TOL, "opt, delta_prev")
    np.testing.assert_allclose([h["loss"] for h in run["hist"]],
                               ref["losses"], rtol=RTOL_METRICS)


def test_vocab_parallel_xent_equals_one_process(tmp_path):
    """Vocabulary 500 pads to 512: the padded columns' logits enter the
    logsumexp on the rank that holds them, as the one-process loss
    takes them; a chunk of 5 positions splits the 7."""
    res = MW.spawn(2, "xent", dict(vocab=500, d=16, chunk=5), tmp_path,
                   module="torch_tp_worker")
    for r in res:
        assert r["loss"] == pytest.approx(r["loss_one"], rel=1e-6)
        assert r["gx"] <= 1e-6 and r["gw"] <= 1e-6, r
    assert res[0]["loss"] == res[1]["loss"]


CKPT = [("1x2", i) for i in range(len(NAMES))] + [("2x2", 0)]


@pytest.mark.parametrize("mesh,i", CKPT,
                         ids=[f"{m}-{RUNS[i][0]}" for m, i in CKPT])
def test_checkpoint_under_model_ranks_restores_under_mesh_none(ranks, mesh,
                                                               i):
    """`Engine.save` on (1, 2) and (2, 2) gathers both axes and writes the
    one-process state: ``mesh=None`` restores it bitwise the gathered
    state, and the mesh restores each rank's shards bit for bit."""
    res = ranks(mesh)
    assert res[0]["runs"][i]["ckpt_bitwise"]
    assert all(r["runs"][i]["restored"] for r in res)


# ---------------------------------------------------------------------------
# refusals, at Engine construction (a stand-in mesh: no process group)
# ---------------------------------------------------------------------------


class _Mesh:
    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


# name -> (architecture, algorithm spec, the words the refusal names,
# the limit it names: the reference's own).  Every family, local optimizer, λ mode,
# reducer (the compressed and quantized wires too), staleness policy,
# DC-ASGD and the overlap pipeline train over 'model'
# (tests/test_torch_tp_families.py, tests/test_torch_tp_pieces.py,
# tests/test_torch_tp_wires.py), and every family serves over it
# (tests/test_torch_tp_serve.py); what stays refused is an indivisible
# dim.
REFUSED = {
    "indivisible": ("qwen3-0.6b", {}, "does not divide",
                    "the reference's GSPMD refuses the same sharding"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_raise_at_construction(monkeypatch, name):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.reduce import ProcessWorkers
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    arch, spec, words, item = REFUSED[name]
    monkeypatch.setattr(M, "make_workers", lambda mesh: ProcessWorkers(
        None, rank=0, size=M.n_workers(mesh)))
    model = Model(reduced(get_config(arch)))
    alg = MW._make(spec, 4)
    # the reduced vocabulary (512 rows of `tok`) does not divide over 1024
    with pytest.raises(ValueError, match=item) as e:
        Engine(model, alg, mesh=_Mesh(data=1, model=1024))
    assert words in str(e.value)
    # the same algorithm and model with mesh=None are accepted
    Engine(model, MW._make(spec, 4))


# name -> (architecture, algorithm spec): the compressed and quantized
# wires, refused over 'model' until they reduced the reference's whole
# buckets, for each algorithm with a reducer, bucketed and per leaf
WIRES = {
    "topk": ("qwen3-0.6b", {"reducer": "topk", "buckets": 2}),
    "topk_exact": ("qwen3-0.6b", {"reducer": "topk_exact", "buckets": 2}),
    "randk": ("qwen3-0.6b", {"reducer": "randk", "buckets": 2}),
    "powersgd": ("qwen3-0.6b", {"reducer": "powersgd", "buckets": 2}),
    "int8": ("qwen3-0.6b", {"cfg": {"comm_dtype": "int8"}, **FUSED}),
    "fp8": ("falcon-mamba-7b", {"cfg": {"comm_dtype": "fp8"}}),
    "stale_topk": ("qwen3-0.6b", {"algo": "stale", "reducer": "topk",
                                  "buckets": 2}),
    "stale_int8_leaves": ("qwen3-0.6b", {"algo": "stale",
                                         "cfg": {"comm_dtype": "int8"}}),
    "ssgd_powersgd": ("qwen3-0.6b", {"algo": "ssgd", "reducer": "powersgd",
                                     "buckets": 2}),
    "ssgd_fp8_leaves": ("qwen3-0.6b", {"algo": "ssgd",
                                       "cfg": {"comm_dtype": "fp8"}}),
}


@pytest.mark.parametrize("name", sorted(WIRES))
def test_wires_accepted_at_construction(monkeypatch, name):
    """Each wire constructs over a 'model' axis of 2 and binds the
    algorithm to it: its wire then reduces the whole buckets (leaves),
    whose plan the reducer's state takes."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.reduce import layout_bound
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    arch, spec = WIRES[name]
    _stand_in_axes(monkeypatch)
    engine = Engine(Model(reduced(get_config(arch))), MW._make(spec, 4),
                    mesh=_Mesh(data=1, model=2))
    assert engine.alg.model_axis is engine.model_axis
    assert engine.model_axis.size == 2
    assert layout_bound(engine.alg.reducer)


def _stand_in_axes(monkeypatch):
    """`launch.mesh`'s worker seam and 'model' axis over a stand-in mesh
    (no process group)."""
    from repro_torch.core.reduce import ProcessWorkers
    from repro_torch.launch import mesh as M
    from repro_torch.parallel.tensor import ModelAxis
    monkeypatch.setattr(M, "make_workers", lambda mesh: ProcessWorkers(
        None, rank=0, size=M.n_workers(mesh)))
    monkeypatch.setattr(M, "model_axis", lambda mesh: ModelAxis(
        None, rank=0, size=M.model_size(mesh)))


def test_serving_binds_the_model_axis_without_an_algorithm(monkeypatch):
    """An Engine built only to serve binds the model to the 'model' axis
    (and still refuses an indivisible dim)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    _stand_in_axes(monkeypatch)
    model = Model(reduced(get_config("qwen3-0.6b")))
    engine = Engine(model, mesh=_Mesh(data=1, model=2))
    assert engine.model.tp.size == 2 and engine.model_axis.size == 2
    with pytest.raises(ValueError,
                       match="the reference's GSPMD refuses the same"):
        Engine(model, mesh=_Mesh(data=1, model=1024))


_REFERENCE_UNEVEN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config, reduced
from repro.models.transformer import Model
from repro.parallel.sharding import param_specs
cfg = reduced(get_config("olmoe-1b-7b"))
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 8),
                         ("data", "model"))
params = jax.eval_shape(Model(cfg, remat=False).init, jax.random.PRNGKey(0))
specs = param_specs(cfg, params, model_size=8)
out = []
for (path, x), spec in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                           jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
                               s, jax.sharding.PartitionSpec))):
    names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    try:
        jax.device_put(np.zeros(x.shape, x.dtype), NamedSharding(mesh, spec))
    except ValueError as e:
        out.append({"path": [str(n) for n in names], "shape": list(x.shape),
                    "error": str(e)})
print(json.dumps(out))
"""


def test_reference_refuses_the_same_indivisible_leaf(monkeypatch, tmp_path):
    """The reduced olmoe's experts (4) over 'model' = 8: the reference's
    own partition rules place ``moe/w_down``, ``w_gate`` and ``w_up`` on
    a (1, 8) mesh of eight forced host devices and JAX refuses each
    sharding; the port's rules find the same leaves indivisible and no
    other, and its refusal names the first with that limit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import specs as S
    from repro_torch.launch.engine import Engine
    from repro_torch.models.transformer import Model
    from repro_torch.parallel import sharding as shd
    r = subprocess.run([sys.executable, "-c", _REFERENCE_UNEVEN],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    refused = json.loads(r.stdout.strip().splitlines()[-1])
    assert all("should be divisible by 8, but it is equal to 4" in x["error"]
               for x in refused)
    cfg = reduced(get_config("olmoe-1b-7b"))
    model = Model(cfg)
    params = S.abstract_params(model)
    specs = shd.param_specs(cfg, params, model_size=8)
    mine = [[str(k) for k in path] for (path, x), (_, sp) in zip(
        shd.leaves_with_path(params), shd.flat_specs(specs, params))
        if shd.model_dim(sp) is not None
        and x.shape[shd.model_dim(sp)] % 8]
    assert [x["path"] for x in refused] == mine
    assert [x[-2:] for x in mine] == [["moe", "w_down"], ["moe", "w_gate"],
                                      ["moe", "w_up"]]
    _stand_in_axes(monkeypatch)
    with pytest.raises(ValueError,
                       match="the reference's GSPMD refuses the same") as e:
        Engine(model, mesh=_Mesh(data=1, model=8))
    assert "moe/w_down" in str(e.value)
    assert str(tuple(refused[0]["shape"])) in str(e.value)


def _paged(model):
    from repro_torch.models.cache import PagedLayout
    return PagedLayout(model, n_slots=2, num_pages=4, page_size=8,
                       max_pages=2)


def _scheduler(model):
    from repro_torch.serve.scheduler import Scheduler
    return Scheduler(model, None)


# the paged serving seam, one process's in the reference
# (repro.launch.serve builds Engine(model) without a mesh): each entry
# point given a model over a 'model' axis of 2
PAGED = {
    "cache_ops": lambda model: model.decode_step(
        None, None, {"pos": None}, cache_ops=object()),
    "prefill_chunk": lambda model: model.prefill_chunk(
        None, None, {}, positions=None, cache_ops=None),
    "paged_layout": _paged,
    "scheduler": _scheduler,
}


@pytest.mark.parametrize("what", sorted(PAGED))
def test_paged_serving_refused_over_model(what):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import Model
    from repro_torch.parallel.tensor import ModelAxis
    model = Model(reduced(get_config("qwen3-0.6b"))).with_model_axis(
        ModelAxis(None, rank=0, size=2))
    with pytest.raises(ValueError, match="one process only") as e:
        PAGED[what](model)
    assert "repro.launch.serve" in str(e.value)


def test_the_cnn_runs_replicated_over_model(tmp_path):
    """The CNN (no `ModelConfig`) is replicated over 'model': both model
    ranks run the same compute, bitwise alike, and at one worker rank the
    state is bitwise the one-process run's (the norms' sharded sum is an
    all-reduce of zeros)."""
    res = MW.spawn(2, "cnn", dict(spec=FUSED, W=4), tmp_path,
                   module="torch_tp_worker")
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["hist"] == res[1]["hist"] == res[0]["hist_one"]
    for part, diff in res[0]["diff"].items():
        assert diff == (0.0, True), part

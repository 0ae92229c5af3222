"""The analysis layer's accounting against the reference's: parameter and
model-FLOP counts, the reducers' wire models, the bucket-plan cache key
and ``plan_block``, the findings schema, and the op trace (`optrace`)
that replaces the reference's HLO parsing.

* ``n_params`` / ``n_active_params`` / ``model_flops_per_step``: the
  reference's integers for all ten configs, full and reduced.
* ``wire_model`` / ``_accounted_bytes``: the reference's integers for
  every reducer x comm dtype (f32, bf16, int8, fp8) x layout (per-leaf
  sizes, bucketed sizes).
* the plan cache keys on ``block`` and the wire dtype; ``plan_buckets(
  block=2·BLOCK)`` pads as the reference's does; dc_s3gd and ssgd runs
  with ``plan_block=2·BLOCK`` are bitwise the default runs within the
  port and within the trajectory tolerances (metrics rtol 1e-5, each
  leaf 1e-4 of its scale) of the reference's runs with the same block.
* ``findings_report`` / ``render_findings``: the reference's output for
  the same findings.
* the op trace's dot FLOPs of the lint toy step and of the reduced qwen3
  step equal the reference's ``analyze_hlo(...).dot_flops`` exactly: the
  port's eager step runs the same matmuls (forward, and the backward
  products of the params only), so the measured gap is 0 and the pin is
  equality.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import report as j_report
from repro.analysis import roofline as j_roofline
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import compress as j_compress
from repro.core import registry as jreg
from repro.core.types import INPUT_SHAPES as J_SHAPES
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models.transformer import Model as JModel
from repro.parallel import buckets as JB
from repro_torch import instrument
from repro_torch import tree as T
from repro_torch.analysis import optrace, report, roofline
from repro_torch.configs import get_config, reduced
from repro_torch.core import compress, registry
from repro_torch.core.types import INPUT_SHAPES, DCS3GDConfig, InputShape
from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dc_update as K
from repro_torch.models.transformer import Model
from repro_torch.parallel import buckets as B
from torch_threads import one_torch_thread  # noqa: F401

ARCH_NAMES = sorted(J_ARCHS)

# ---------------------------------------------------------------------------
# parameter and model-FLOP counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_model_flop_counts_match_reference(arch, cut):
    ours, theirs = get_config(arch), j_get_config(arch)
    if cut == "reduced":
        ours, theirs = reduced(ours), j_reduced(theirs)
    assert ours.n_params() == theirs.n_params()
    assert ours.n_active_params() == theirs.n_active_params()
    assert set(INPUT_SHAPES) == set(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert shape.tokens_per_step == J_SHAPES[name].tokens_per_step
        for chips in (1, 4, 256):
            assert roofline.model_flops_per_step(ours, shape, chips) == \
                j_roofline.model_flops_per_step(theirs, J_SHAPES[name],
                                                chips)


# ---------------------------------------------------------------------------
# wire models
# ---------------------------------------------------------------------------

REDUCERS = ("mean_allreduce", "gossip", "hierarchical", "topk", "topk_exact",
            "randk", "powersgd", "dense_window")
WIRES = ("float32", "bfloat16", "int8", "fp8")
W = 4
LAYOUTS = {"per_leaf": [256, 1024, 16, 4096, 3],
           "bucketed": [B.BLOCK, 2 * B.BLOCK, B.BLOCK]}


class _Plan:
    def __init__(self, sizes):
        self.bucket_sizes = tuple(sizes)


def _pair(name, wire, sizes):
    """(port reducer, reference reducer), both initialized at W workers
    where their accounting needs the count."""
    inner = "topk" if name == "dense_window" else name
    cfg_t, cfg_j = DCS3GDConfig(comm_dtype=wire), JConfig(comm_dtype=wire)
    ours = registry.make_reducer(inner, cfg_t)
    theirs = jreg.make_reducer(inner, cfg_j)
    if not getattr(ours, "stateless", True):
        ours.init(W, _Plan(sizes))
        theirs.init(W, _Plan(sizes))
    if name == "dense_window":
        ours = compress.DenseWindowReduce(ours)
        theirs = j_compress.DenseWindowReduce(theirs)
    return ours, theirs


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("name", REDUCERS)
def test_wire_model_matches_reference(name, wire):
    for layout, sizes in LAYOUTS.items():
        ours, theirs = _pair(name, wire, sizes)
        assert ours.wire_model(sizes, W) == theirs.wire_model(sizes, W), \
            layout
        assert ours.wire_bytes(sizes) == theirs.wire_bytes(sizes), layout
        if hasattr(theirs, "_accounted_bytes"):
            assert ours._accounted_bytes(sizes, W) == \
                theirs._accounted_bytes(sizes, W), layout
        # the hand accounting agrees with itself (the lint gate's premise)
        if name != "dense_window":
            assert ours.wire_model(sizes, W)["accounted_bytes"] == \
                ours.wire_bytes(sizes)


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", ["mean_allreduce", "gossip",
                                  "hierarchical"])
def test_dense_cast_bytes_are_the_traced_casts(name, wire):
    """The cast census of a dense reducer's call equals what its op trace
    casts to the wire dtype (the premise of the wire-accounting pass)."""
    red = registry.make_reducer(name, DCS3GDConfig(comm_dtype=wire))
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((W, 16, 4), generator=gen),
            "b": torch.randn((W, 33), generator=gen)}
    sizes = [64, 33]
    with optrace.trace() as tr:
        red(tree)
    dst = "bfloat16" if wire == "bfloat16" else "int8"
    got = sum(c.elements for c, _ in tr.casts() if c.dst == dst
              and c.src == "float32") * (2 if wire == "bfloat16" else 1)
    assert got == red.wire_model(sizes, W)["cast_bytes"]


# ---------------------------------------------------------------------------
# the plan cache and plan_block
# ---------------------------------------------------------------------------


def _tree():
    return {"w": torch.zeros((300, 200)), "b": torch.zeros((200,)),
            "e": torch.zeros((70_000,))}


def test_plan_cache_never_aliases_block_or_wire():
    cache = {}
    tree = _tree()
    a = B.cached_plan(cache, tree, 2)
    b = B.cached_plan(cache, tree, 2, block=2 * B.BLOCK)
    c = B.cached_plan(cache, tree, 2, wire_dtype="int8")
    d = B.cached_plan(cache, tree, 2, wire_dtype="bfloat16")
    assert len(cache) == 4
    assert a.block == B.BLOCK and b.block == 2 * B.BLOCK
    assert all(n % (2 * B.BLOCK) == 0 for n in b.bucket_sizes)
    assert a.bucket_sizes != b.bucket_sizes
    assert c is not d and c is not a
    assert B.cached_plan(cache, tree, 2, block=2 * B.BLOCK) is b
    assert len(cache) == 4


@pytest.mark.parametrize("n_buckets", [1, 2, 4])
def test_plan_block_pads_as_the_reference(n_buckets):
    tree = _tree()
    jtree = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), tree)
    ours = B.plan_buckets(tree, n_buckets, block=2 * B.BLOCK)
    theirs = JB.plan_buckets(jtree, n_buckets, block=2 * B.BLOCK)
    assert ours.bucket_sizes == tuple(theirs.bucket_sizes)
    assert [(s.bucket, s.offset, s.size) for s in ours.slots] == \
        [(s.bucket, s.offset, s.size) for s in theirs.slots]


STEPS, BPW, SEQ, NW = 3, 2, 16, 2
HP = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1)
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


def _torch_run(algo, plan_block, kernels=False):
    cfg = reduced(get_config("qwen3-0.6b"))
    model = Model(cfg)
    alg = registry.make(algo, DCS3GDConfig(**HP), n_workers=NW, buckets=2,
                        plan_block=plan_block, use_kernels=kernels)
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    data = SyntheticLMDataset(cfg.vocab_size, SEQ, seed=0)
    hist = []
    for t in range(STEPS):
        state, m = alg.step(state, worker_batches(data, t, NW, BPW,
                                                  device="cpu"),
                            loss_fn=model.loss)
        hist.append({k: float(m[k]) for k in METRICS if k in m})
    return alg, state, hist


def _jax_run(algo, plan_block):
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    model = JModel(cfg, remat=False)
    alg = jreg.make(algo, JConfig(**HP), n_workers=NW, buckets=2,
                    plan_block=plan_block)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    data = JData(cfg.vocab_size, SEQ, seed=0)
    hist = []
    for t in range(STEPS):
        state, m = step(state, j_worker_batches(data, t, NW, BPW))
        hist.append({k: float(m[k]) for k in METRICS if k in m})
    return jax.tree.map(np.asarray, state), hist


def _close(ours, theirs, what):
    for x, y in zip(T.leaves(ours), jax.tree.leaves(theirs)):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * float(np.abs(y).max()),
                                   err_msg=what)


@pytest.mark.parametrize("algo", ["dc_s3gd", "ssgd"])
def test_plan_block_trajectory(algo):
    """2·BLOCK padding changes no bit within the port (the padding is
    inert zeros), fused tail included for dc_s3gd, and stays within the
    trajectory tolerances of the reference run with the same block."""
    big = 2 * B.BLOCK
    alg, s1, h1 = _torch_run(algo, big)
    plan = alg._plan(s1.params)
    assert plan.block == big and all(n % big == 0
                                     for n in plan.bucket_sizes)
    _, s0, h0 = _torch_run(algo, None)
    for a, b in zip(T.leaves(s0.params), T.leaves(s1.params)):
        assert torch.equal(a, b)
    assert h0 == h1
    if algo == "dc_s3gd":
        assert all(r.shape[-1] % big == 0
                   for r in s1.comm["delta_prev"])
        _, s2, h2 = _torch_run(algo, big, kernels=True)
        for a, b in zip(T.leaves(s0.params), T.leaves(s2.params)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    j_state, j_hist = _jax_run(algo, big)
    _close(s1.params, j_state.params, "params")
    for th, jh in zip(h1, j_hist):
        for k in METRICS:
            if k in jh:
                np.testing.assert_allclose(th[k], jh[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)


def test_rebuild_algorithm_keeps_plan_block():
    from repro_torch.cluster import rebuild_algorithm
    alg = registry.make("dc_s3gd", DCS3GDConfig(), n_workers=4, buckets=2,
                        plan_block=2 * B.BLOCK)
    assert rebuild_algorithm(alg, 3).plan_block == 2 * B.BLOCK


# ---------------------------------------------------------------------------
# the findings schema
# ---------------------------------------------------------------------------

_FINDINGS = [
    dict(pass_name="dtype-drift", severity="error", program="dc_s3gd/x",
         op="convert->f16", location="a/b", message="m1"),
    dict(pass_name="ast.algo-branch", severity="warning", message="m2",
         location="core/x.py:3"),
    dict(pass_name="fence", severity="info", program="p", message="m3"),
    dict(pass_name="donation", severity="error", program="p2", message="m4"),
]


def test_findings_report_and_render_match_reference():
    ours = [report.Finding(**d) for d in _FINDINGS]
    theirs = [j_report.Finding(**d) for d in _FINDINGS]
    meta = {"grid": ["a", "b"]}
    assert json.dumps(report.findings_report(ours, meta)) == \
        json.dumps(j_report.findings_report(theirs, meta))
    assert report.render_findings(ours) == j_report.render_findings(theirs)
    assert report.render_findings([]) == j_report.render_findings([])
    doc = report.findings_report(ours, meta)
    back, m = report.parse_report(json.loads(json.dumps(doc)))
    assert back == sorted(ours, key=lambda f: ("ewi".index(
        f.severity[0]), f.pass_name, f.program, f.location)) and m == meta
    assert [f.key for f in back] == [f.key for f in
                                     j_report.parse_report(doc)[0]]
    with pytest.raises(ValueError):
        report.parse_report({"schema": "other"})


def test_baseline_roundtrip(tmp_path):
    f = report.Finding(pass_name="fence", severity="error", program="p",
                       message="drifting number 1")
    path = tmp_path / "b.json"
    path.write_text(json.dumps(report.findings_report([f])))
    base = report.load_baseline(path)
    g = report.Finding(pass_name="fence", severity="error", program="p",
                       message="drifting number 2")
    assert report.new_findings([g], base) == []
    assert report.load_baseline(tmp_path / "missing.json") == set()


def test_committed_baseline_is_empty():
    from repro_torch.analysis.lint import BASELINE
    findings, _ = report.parse_report(json.loads(BASELINE.read_text()))
    assert findings == []


# ---------------------------------------------------------------------------
# the op trace and the roofline
# ---------------------------------------------------------------------------


def test_kernel_wrapper_is_one_node_on_the_cpu():
    """The plain version's ops inside a wrapper are attributed to its
    node, not counted twice; its bytes are the kernel's bound's."""
    g, d = torch.randn((2, 1000)), torch.randn((2, 1000))
    before = K.dc_norms.launches
    with optrace.trace() as tr:
        K.dc_norms(g, d)
    assert [o.name for o in tr.ops] == ["kernel.dc_norms"]
    assert tr.ops[0].bytes == 8 * 2 * 1000 + 8 * 2
    assert K.dc_norms.launches == before    # the CPU ran the plain version
    assert optrace.count_ops(tr, "kernel.dc_norms") == 1


def test_paged_attention_node_counts_the_live_work():
    """B4's one cost function, which a trace records and ``chip_smoke.py``
    bounds the kernel with, counts each row's live tokens and pages (a
    table wider than the rows costs nothing), and `kernel_bound` prices
    it as the larger of its bytes over HBM and its flops at the f32
    peak."""
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_cost)
    rng = np.random.default_rng(0)
    Bq, KV, G, hd, ps = 3, 2, 4, 16, 8
    q = torch.from_numpy(rng.standard_normal((Bq, KV, G, hd))
                         .astype(np.float32))
    pool = torch.from_numpy(rng.standard_normal((12, ps, KV, hd))
                            .astype(np.float32))
    lens = torch.tensor([1, 9, 24], dtype=torch.int32)
    narrow = torch.tensor([[1, 0, 0], [2, 3, 0], [4, 5, 6]],
                          dtype=torch.int32)
    wide = torch.nn.functional.pad(narrow, (0, 5))
    tokens, pages = 34, 1 + 2 + 3
    want = {"flops": 4 * G * hd * KV * tokens,
            "bytes_read": 2 * tokens * KV * hd * 4 + 4 * pages
            + 4 * q.numel() + 4 * Bq,
            "bytes_written": 4 * q.numel()}
    for table in (narrow, wide):
        assert paged_attention_cost(q, pool, pool, table, lens) == want
        with optrace.trace() as tr:
            paged_attention(q, pool, pool, table, lens)
        (op,) = tr.ops
        assert op.name == "kernel.paged_attention" and op.flops == \
            want["flops"] and op.bytes == want["bytes_read"] \
            + want["bytes_written"]
    scaled = paged_attention_cost(q, pool, pool, narrow, lens,
                                  k_scale=lens, v_scale=lens)
    assert scaled["bytes_read"] == want["bytes_read"] + 2 * 4 * tokens
    ms, by = roofline.kernel_bound(want)
    byte_s = (want["bytes_read"] + want["bytes_written"]) / roofline.HBM_BW
    op_s = want["flops"] / roofline.PEAK_FLOPS_F32
    assert ms == pytest.approx(max(byte_s, op_s) * 1e3)
    assert by == ("operations" if op_s > byte_s else "bytes")
    assert roofline.kernel_bound({"dot_flops": 10 ** 12, "math": "bfloat16",
                                  "bytes_read": 1, "bytes_written": 1}) \
        == (pytest.approx(1e3 / roofline.PEAK_FLOPS_BF16 * 1e12),
            "operations")


def test_trace_records_flops_bytes_casts_and_scopes():
    a, b = torch.randn((4, 5)), torch.randn((5, 6))
    with optrace.trace() as tr:
        with instrument.scope("wire"):
            c = (a @ b).to(torch.bfloat16)
        c.t()
    assert optrace.count_ops(tr, "mm") == 1
    mm = tr.ops[0]
    assert mm.dot_flops == 2 * 4 * 5 * 6 and mm.math == "float32"
    assert mm.bytes == 4 * (20 + 30 + 24) and mm.scope == ("wire",)
    cast, op = tr.casts()[0]
    assert (cast.src, cast.dst, cast.elements) == ("float32", "bfloat16",
                                                   24)
    assert op.in_scope("wire") and tr.casts("model") == []
    assert tr.ops[-1].bytes == 0          # a view moves nothing
    assert [n for n, _ in tr.regions] == ["wire"]
    assert instrument.active() is None
    with instrument.scope("wire"):        # outside a trace: no records
        pass


def test_roofline_prices_each_op_at_its_math():
    a32, b32 = torch.randn((64, 64)), torch.randn((64, 64))
    with optrace.trace() as tr:
        a32 @ b32
        a32.to(torch.bfloat16) @ b32.to(torch.bfloat16)
    cfg = reduced(get_config("qwen3-0.6b"))
    r = roofline.analyze(tr, cfg, InputShape("t", 8, 2, "train"), 1)
    dots = 2 * 64 ** 3
    want = dots / roofline.PEAK_FLOPS_F32 + dots / roofline.PEAK_FLOPS_BF16 \
        + sum(o.elem_flops for o in tr.ops) / roofline.PEAK_FLOPS_F32
    assert r.compute_s == pytest.approx(want)
    assert r.flops == tr.flops and r.hbm_bytes == tr.bytes
    assert r.step_s == max(r.compute_s, r.memory_s)
    assert r.model_flops == 6 * cfg.n_active_params() * 16


def _toy_prog():
    from repro_torch.analysis.lint import GridPoint, Program
    return Program(GridPoint("dc_s3gd", "mean_allreduce", 4, False),
                   device="cpu")


def test_toy_step_dot_flops_match_reference():
    from repro.analysis.hlo import analyze_hlo
    from repro.analysis.lint import GridPoint as JPoint
    from repro.analysis.lint import Program as JProgram
    prog = _toy_prog()
    jprog = JProgram(JPoint("dc_s3gd", "mean_allreduce", 4, False))
    want = analyze_hlo(jprog.lowered.compile().as_text()).dot_flops
    assert prog.trace.dot_flops == want == 24576
    meta = prog.trace.meta
    # six 16 x 16 leaves, no two under the cap of ceil(1536 / 4)
    assert meta["wire"]["sizes"] == [B.BLOCK] * 6
    assert meta["wire"]["bytes"] == prog.alg.reducer.wire_bytes(
        meta["wire"]["sizes"])
    # the inline reduce comes before the model's forward and backward
    assert [n for n, _ in prog.trace.regions] == ["wire", "model"]


def test_reduced_qwen3_step_dot_flops_match_reference():
    """Measured gap 0: the port's step runs exactly the reference's
    matmuls (the attention's score and value products over the whole
    sequence, the projections, the loss head, and their backward products
    for the params), so the pin is equality."""
    from repro.analysis.hlo import analyze_hlo
    from repro.analysis.lint import GridPoint as JPoint
    from repro.analysis.lint import Program as JProgram
    from repro_torch.analysis.lint import GridPoint, Program
    prog = Program(GridPoint("dc_s3gd", "mean_allreduce", 4, False),
                   device="cpu", model="transformer")
    jprog = JProgram(JPoint("dc_s3gd", "mean_allreduce", 4, False),
                     model="transformer")
    want = analyze_hlo(jprog.lowered.compile().as_text()).dot_flops
    assert prog.trace.dot_flops == want
    r = roofline.analyze(prog.trace, prog.model.cfg,
                         InputShape("t", 32, 4, "train"), 1)
    # 6·N·D counts the embedding table's N too, which no matmul reads:
    # at the reduced widths the ratio comes out just above 1
    assert r.model_flops == 6 * prog.model.cfg.n_active_params() * 128
    assert 0.9 < r.useful_flops_ratio < 1.1
    assert r.bottleneck in ("compute", "memory")


def test_engine_retrace_stats_steady():
    prog = _toy_prog()
    state = prog.fresh_state()
    stats = prog.engine.retrace_stats()
    assert stats["fit_rejits"] == 0 and stats["plan_cache_size"] == 1
    for it in range(3):
        state, _ = prog.alg.step(state, prog.batch, loss_fn=prog.model.loss)
    assert prog.engine.retrace_stats() == stats

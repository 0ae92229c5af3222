"""The port's analyzer catches what it claims to catch
(`repro_torch.analysis.lint` over traced steps, `repro_torch.analysis.
astlint` over the source tree), mirroring ``tests/test_lint.py``:

* **clean grid**: every point of the port's grid gives zero findings on
  the toy model (the committed baseline is empty), and the port's source
  tree is astlint-clean;
* **seeded true positives**: every pass fires on a deliberately broken
  step (a step that keeps the old state alive, a host pull, a plan cache
  that grows every step, dtype drift, a leaked wire cast, an unfenced or
  duplicated pipeline reduce, a lying wire accounting), and every AST
  rule on one source fixture.
"""
import textwrap

import pytest
import torch

from repro_torch import tree as T
from repro_torch.analysis import astlint
from repro_torch.analysis import lint as L
from repro_torch.analysis.lint import (PASSES, DonationPass, DtypeDriftPass,
                                       FencePass, GridPoint, HostSyncPass,
                                       Program, RetracePass,
                                       WireAccountingPass, iter_grid,
                                       run_point)
from repro_torch.core.api import TrainState
from repro_torch.parallel import buckets as B
from repro_torch.parallel import pipeline as PL
from torch_threads import one_torch_thread  # noqa: F401

GRID = list(iter_grid())


def _by_pass(findings, name):
    return [f for f in findings if f.pass_name == name]


def _prog(reducer="mean_allreduce", overlap=False, wire="bfloat16",
          algo="dc_s3gd"):
    return Program(GridPoint(algo, reducer, 4, overlap, wire=wire),
                   device="cpu")


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def test_grid_enumeration_valid_points_only():
    names = [p.name for p in GRID]
    assert len(names) == len(set(names)) == 28
    for p in GRID:
        if p.reducer in L.COMPRESSED_REDUCERS:
            assert p.buckets
        if p.overlap:
            assert p.buckets and p.algo != "ssgd"
    assert GridPoint("dc_s3gd", "topk", 4, True) in GRID
    assert GridPoint("ssgd", "mean_allreduce", 0, False) in GRID
    assert GRID[-1].name == "dc_s3gd/topk/b4/in/int8"


@pytest.mark.parametrize("point", GRID, ids=[p.name for p in GRID])
def test_grid_point_has_zero_findings(point):
    assert run_point(Program(point, device="cpu")) == []


def test_cli_exits_zero_against_the_empty_baseline(capsys):
    assert L.main(["--device", "cpu", "--select", "mean_allreduce/b4",
                   "--baseline", str(L.BASELINE), "-q"]) == 0
    assert "no findings" in capsys.readouterr().out
    assert L.main(["--list"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 28


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The grid's default device is the card; without one the CLI raises
    rather than running on the CPU (``--list`` needs no device), and a
    `Program` takes its device from the caller."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.main(["--select", "mean_allreduce/b4", "-q"])
    assert L.main(["--list", "--select", "mean_allreduce/b4"]) == 0
    with pytest.raises(TypeError):
        Program(GridPoint("dc_s3gd", "mean_allreduce", 4, False))


# ---------------------------------------------------------------------------
# seeded true positives, one per pass
# ---------------------------------------------------------------------------


def test_donation_pass_catches_a_step_keeping_the_old_state():
    prog = _prog()
    step = prog.alg.step

    def hoarding_step(state, batch, *, loss_fn):
        prog.alg._last = state            # a cache beside the step
        return step(state, batch, loss_fn=loss_fn)

    prog.alg.step = hoarding_step
    found = _by_pass(DonationPass().run(prog), "donation")
    assert found and found[0].op == "weakref"
    assert "outlive the step" in found[0].message


def test_donation_pass_clean_on_a_plain_step():
    assert DonationPass().run(_prog()) == []


def test_host_sync_pass_catches_item_in_the_step():
    prog = _prog()
    step = prog.alg.step

    def pulling_step(state, batch, *, loss_fn):
        float(T.leaves(state.params)[0].sum())    # .item() in the step
        return step(state, batch, loss_fn=loss_fn)

    prog.alg.step = pulling_step
    found = HostSyncPass().run(prog)
    assert found and all(f.severity == "error" for f in found)
    assert any("_local_scalar_dense" in f.op for f in found)


def test_retrace_pass_catches_a_plan_cache_that_grows(monkeypatch):
    prog = _prog()
    real = B.cached_plan

    def keyed_on_identity(cache, tree, n, **kw):
        # the bug class: a cache key that changes every step (here the
        # tree's identity), so the plan is rebuilt every step
        key = id(tree)
        if key not in cache:
            cache[key] = real({}, tree, n, **kw)
        return cache[key]

    monkeypatch.setattr(B, "cached_plan", keyed_on_identity)
    found = _by_pass(RetracePass().run(prog), "recompile")
    assert found and found[0].op == "plan_cache_size"


def test_retrace_pass_clean_on_a_steady_loop():
    prog = _prog()
    assert RetracePass().run(prog) == []
    assert prog.engine.retrace_stats()["fit_rejits"] == 0


class _DriftAlg:
    """A stub algorithm whose step narrows or round-trips the params."""

    name = "driftalg"
    n_workers = 1

    def __init__(self, fn):
        self.fn = fn

    def init(self, params):
        return TrainState(params, {}, {}, 0)

    def step(self, state, batch, *, loss_fn):
        return TrainState(T.map(self.fn, state.params), state.opt,
                          state.comm, state.step + 1), {}


def _drift_prog(fn, wire="bfloat16"):
    prog = _prog(wire=wire)
    prog.alg = _DriftAlg(fn)
    prog.engine = L.Engine(prog.model, prog.alg)
    return prog


def test_dtype_drift_pass_catches_structural_drift():
    prog = _drift_prog(lambda p: p.to(torch.bfloat16))
    found = _by_pass(DtypeDriftPass().run(prog), "dtype-drift")
    assert any(f.op == "state-leaf" and "float32 in, bfloat16 out"
               in f.message for f in found)


def test_dtype_drift_pass_catches_forbidden_f16_cast():
    prog = _drift_prog(lambda p: p.to(torch.float16).to(p.dtype))
    found = _by_pass(DtypeDriftPass().run(prog), "dtype-drift")
    assert any(f.op == "convert->float16" for f in found), found


def test_dtype_drift_pass_catches_wire_cast_outside_wire_scope():
    prog = _drift_prog(lambda p: p.to(torch.bfloat16).to(p.dtype))
    found = _by_pass(DtypeDriftPass().run(prog), "dtype-drift")
    assert any("outside the 'wire' scope" in f.message for f in found)


def test_dtype_drift_pass_catches_quantize_outside_wire_scope():
    prog = _drift_prog(lambda p: (p * 100).to(torch.int8).to(p.dtype) / 100,
                       wire="int8")
    found = _by_pass(DtypeDriftPass().run(prog), "dtype-drift")
    assert any(f.op == "convert->int8" for f in found), found


def test_fence_pass_catches_unfenced_pipeline(monkeypatch):
    prog = _prog(overlap=True)
    red = prog.alg.reducer
    # the unfenced pipeline: the step reduces inline at its top instead of
    # consuming what the previous issue landed
    monkeypatch.setattr(PL, "landed", lambda comm: PL.issue(
        red, comm["delta_prev"])[0]["reduced"])
    found = _by_pass(FencePass().run(prog), "fence")
    ops = {f.op for f in found}
    assert {"issue", "consume", "reduce"} <= ops, found


def test_fence_pass_catches_a_duplicated_reduce(monkeypatch):
    prog = _prog(overlap=True)
    real = prog.alg.reducer.__class__.__call__

    def twice(self, tree):
        real(self, tree)
        return real(self, tree)

    monkeypatch.setattr(prog.alg.reducer.__class__, "__call__", twice)
    prog._run_traced()
    monkeypatch.undo()
    found = _by_pass(FencePass().run(prog), "fence")
    assert any(f.op == "reduce" and "duplicated or dropped" in f.message
               for f in found), found


def test_fence_pass_clean_on_real_pipeline():
    assert FencePass().run(_prog(overlap=True)) == []


def test_wire_accounting_catches_lying_wire_bytes():
    prog = _prog("topk")
    prog.alg.reducer.wire_bytes = lambda sizes: 1
    found = _by_pass(WireAccountingPass().run(prog), "wire-accounting")
    assert any(f.op == "wire-bytes" for f in found), found


def test_wire_accounting_catches_lying_cast_model():
    prog = _prog()
    red = prog.alg.reducer
    true_model = red.wire_model(prog.wire_sizes, prog.n_workers)
    red.wire_model = lambda sizes, n: {
        "cast_bytes": true_model["cast_bytes"] + 2,
        "accounted_bytes": true_model["accounted_bytes"]}
    found = _by_pass(WireAccountingPass().run(prog), "wire-accounting")
    assert any(f.op == "cast-census" for f in found), found


def test_wire_accounting_catches_inflating_compression():
    prog = _prog("topk")
    red = prog.alg.reducer
    dense = sum(prog.wire_sizes) * 2
    true_cast = type(red).wire_model(red, prog.wire_sizes,
                                     prog.n_workers)["cast_bytes"]
    red.wire_bytes = lambda sizes: dense * 10
    red.wire_model = lambda sizes, n: {"cast_bytes": true_cast,
                                       "accounted_bytes": dense * 10}
    found = _by_pass(WireAccountingPass().run(prog), "wire-accounting")
    assert any(f.op == "compression" for f in found), found


def test_wire_casts_sit_in_the_wire_scope():
    prog = _prog()
    casts = prog.trace.casts()
    assert [c for c, op in casts if op.in_scope("wire")]
    leaked = [c for c, op in casts if c.dst == "bfloat16"
              and not op.in_scope("wire")]
    assert leaked == []


def test_transformer_step_is_clean_on_the_cpu():
    """The reduced qwen3 (f32 compute at the reduced config) at the card
    subset's points: the same passes, zero findings."""
    for point in (GridPoint("dc_s3gd", "mean_allreduce", 4, True),
                  GridPoint("dc_s3gd", "topk", 4, False, wire="int8")):
        prog = Program(point, device="cpu", model="transformer",
                       use_kernels=True)
        assert run_point(prog, PASSES) == [], point.name


# ---------------------------------------------------------------------------
# AST lint: one fixture per rule + suppression + the port's tree is clean
# ---------------------------------------------------------------------------

_AST_FIXTURES = {
    "algo-branch": """
        def pick(algo):
            if algo == "dc_s3gd":
                return 1
            return 2
    """,
    "algo-import": """
        from repro_torch.core.dc_s3gd import DCS3GD
    """,
    "wallclock-cluster": """
        import time

        def transition_log():
            return time.time()
    """,
    "host-pull-in-traced": """
        def step_body(x):
            return x.sum().item()
    """,
    "trainstate-mutation": """
        def advance(state):
            state.step = state.step + 1
            return state
    """,
}

_AST_RULE_DIR = {
    "algo-branch": "repro_torch/launch",
    "algo-import": "repro_torch/launch",
    "wallclock-cluster": "repro_torch/cluster",
    "host-pull-in-traced": "repro_torch/core",
    "trainstate-mutation": "repro_torch/launch",
}


@pytest.mark.parametrize("rule", sorted(_AST_FIXTURES))
def test_astlint_catches_seeded_violation(rule, tmp_path):
    d = tmp_path / _AST_RULE_DIR[rule]
    d.mkdir(parents=True)
    (d / "fixture.py").write_text(textwrap.dedent(_AST_FIXTURES[rule]))
    findings = astlint.lint_paths(tmp_path)
    assert [f for f in findings if f.pass_name == f"ast.{rule}"], findings
    for f in findings:
        assert f.location.startswith(str(
            (d / "fixture.py").relative_to(tmp_path)))


@pytest.mark.parametrize("method", ["item", "tolist", "cpu"])
def test_astlint_host_pull_methods(method, tmp_path):
    d = tmp_path / "repro_torch" / "parallel"
    d.mkdir(parents=True)
    (d / "f.py").write_text(f"def f(x):\n    return x.{method}()\n")
    found = astlint.lint_paths(tmp_path)
    assert [f.pass_name for f in found] == ["ast.host-pull-in-traced"]


def test_astlint_suppression_comment(tmp_path):
    d = tmp_path / "repro_torch" / "launch"
    d.mkdir(parents=True)
    (d / "f.py").write_text(
        'def pick(algo):\n'
        '    return algo == "ssgd"  # lint: allow(algo-branch)\n')
    assert astlint.lint_paths(tmp_path) == []


def test_astlint_rules_scoped_to_their_packages(tmp_path):
    d = tmp_path / "repro_torch" / "launch"
    d.mkdir(parents=True)
    (d / "f.py").write_text(
        "import time\n\ndef t(x):\n    return time.time(), x.item()\n")
    assert astlint.lint_paths(tmp_path) == []


def test_astlint_registry_may_branch(tmp_path):
    d = tmp_path / "repro_torch" / "core"
    d.mkdir(parents=True)
    (d / "registry.py").write_text(
        'def make(name):\n    return name == "dc_s3gd"\n')
    assert astlint.lint_paths(tmp_path) == []


def test_astlint_port_source_tree_is_clean():
    assert L.run_ast() == []

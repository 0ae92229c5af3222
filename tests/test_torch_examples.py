"""The example twins (`repro_torch.examples.quickstart`, `serve_batched`,
`train_lm_100m`) against the repository's own examples, each run as
written (``examples/*.py``, JAX) with its weights and draws injected into
the twin: the reference draws from ``jax.random``, which torch cannot
match bit for bit (ROADMAP queue C), so the twins take them as arguments.

* quickstart: every logged metric within ``RTOL`` of the reference's
  printed value (plus half its last printed digit), the averaged-weight
  eval loss within ``RTOL``; the same lines printed.
* serve_batched: the greedy tokens of all six reduced archs equal, and
  the continuous-batching stream's requests equal in length and tokens.
* train_lm_100m at ``--layers 2``, 3 steps: the logged metrics as for
  quickstart; each checkpoint read back by the reference's
  ``restore_pytree`` equals the port's ``eval_params`` bit for bit, and
  the final one's update from the injected weights is within ``TOL`` of
  each leaf's largest update (plus one f32 unit of the leaf's largest
  value) in the reference's own final checkpoint.

The examples on the card: ``chip_smoke.py``'s example phase.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as j_restore_pytree
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.transformer import Model as JModel

from repro_torch import tree as T
from repro_torch.examples import quickstart, serve_batched, train_lm_100m
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
TOL = 1e-4          # of each leaf's largest update (test_torch_dc_s3gd.py's)


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *a, **kw):
    """(fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


_NUM = r"([-+0-9.e]+)"


def _close(printed: str, value: float, what) -> None:
    """``value`` within ``RTOL`` of a printed number, plus half a unit of
    its last printed digit."""
    mant = printed.split("e")[0]
    digits = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(printed.split("e")[1]) if "e" in printed else 0
    half = 0.5 * 10.0 ** (exp - digits)
    ref = float(printed)
    assert abs(value - ref) <= RTOL * abs(ref) + half, (what, value, printed)


def _shape(lines):
    """The printed lines with every number masked."""
    return [re.sub(r"[-+]?\d[\d.e+-]*", "#", ln) for ln in lines]


def test_quickstart_twin_matches_the_reference_example():
    """The reduced qwen3, W = 4, 60 steps, the reference's weights."""
    _, ref = _printed(_reference("quickstart").main)
    cfg = j_reduced(j_get_config("qwen3-0.6b"))
    weights = jax.tree.map(np.asarray, JModel(cfg, remat=False).init(
        jax.random.PRNGKey(0)))
    got, mine = _printed(quickstart.run, device="cpu", params=weights)
    assert _shape(mine) == _shape(ref)
    assert mine[0] == ref[0]
    rows = [re.match(rf"step\s+(\d+)\s+loss={_NUM}\s+lr={_NUM}\s+"
                     rf"lambda={_NUM}\s+\|D_i\|={_NUM}", ln)
            for ln in ref[1:-1]]
    assert len(rows) == len(got["history"]) == 7
    for m, h in zip(rows, got["history"]):
        assert int(m[1]) == h["step"]
        for k, v in zip(("loss", "lr", "lambda", "distance_norm"),
                        m.groups()[1:]):
            _close(v, h[k], (h["step"], k))
    ref_eval = float(ref[-1].split(":")[1])
    assert abs(got["eval_loss"] - ref_eval) <= RTOL * abs(ref_eval)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The reference example run as written, its `generate` and Scheduler
    recording the weights, prompts, extras and outputs of each call."""
    import repro.serve as j_serve
    ref = _reference("serve_batched")
    calls, streams = [], []
    real_generate = ref.generate

    def generate(model, params, prompts, **kw):
        ids = real_generate(model, params, prompts, **kw)
        calls.append({"arch": model.cfg.name, "params": params,
                      "prompts": np.asarray(prompts),
                      "extra": {k: np.asarray(v) for k, v in
                                (kw.get("extra_batch") or {}).items()},
                      "ids": np.asarray(ids)})
        return ids

    class Recording(j_serve.Scheduler):
        def __init__(self, model, params, **kw):
            super().__init__(model, params, **kw)
            streams.append({"params": params, "kw": kw})

        def run(self, reqs, *a, **kw):
            streams[-1]["prompts"] = [list(r.prompt) for r in reqs]
            done = super().run(reqs, *a, **kw)
            streams[-1]["out"] = {r.rid: list(r.out) for r in done}
            return done

    ref.generate = generate
    real_scheduler = j_serve.Scheduler
    j_serve.Scheduler = Recording
    try:
        _, lines = _printed(ref.main)
    finally:
        j_serve.Scheduler = real_scheduler
    return {"calls": calls, "stream": streams[0], "lines": lines}


@pytest.mark.parametrize("arch", serve_batched.ARCHS)
def test_serve_batched_greedy_tokens_match_the_reference(served, arch):
    """The twin's ``demo`` from the reference's weights, prompts and
    extras gives its greedy tokens, and prints the same line."""
    i = serve_batched.ARCHS.index(arch)
    call = served["calls"][i]
    ids, lines = _printed(
        serve_batched.demo, arch, device="cpu",
        params=jax.tree.map(np.asarray, call["params"]),
        prompts=call["prompts"], extra=call["extra"])
    np.testing.assert_array_equal(ids.numpy(), call["ids"])
    ref_line = served["lines"][1 + i]
    assert lines[0].split(" in ")[0] == ref_line.split(" in ")[0]
    assert lines[0].split("first: ")[1] == ref_line.split("first: ")[1]


def test_serve_batched_continuous_stream_matches_the_reference(served):
    """6 staggered requests over 2 slots, 48 pages of 8, bursts of 2: each
    request's length and tokens are the reference scheduler's, and the
    per-request lines are the same."""
    st = served["stream"]
    assert st["kw"] == {"slots": 2, "pages": 48, "page_size": 8,
                        "decode_burst": 2}
    done, lines = _printed(
        serve_batched.demo_continuous, device="cpu",
        params=jax.tree.map(np.asarray, st["params"]),
        prompts=st["prompts"])
    assert {r.rid: list(r.out) for r in done} == st["out"]
    assert [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)] == \
        [len(p) for p in st["prompts"]]
    assert lines[-6:] == served["lines"][-6:]


def test_train_lm_100m_twin_matches_the_reference_example(tmp_path,
                                                          monkeypatch):
    """``--layers 2 --steps 3`` (2 workers of 2 sequences of 32): the
    logged metrics, and the checkpoints at step 2 and the end read back
    by the reference's ``restore_pytree`` bitwise the port's
    ``eval_params``, and the final one's update within ``TOL`` of the
    reference's own final checkpoint, leaf by leaf."""
    argv = ["--steps", "3", "--layers", "2", "--seq", "32", "--workers",
            "2", "--batch-per-worker", "2", "--ckpt-every", "2"]
    ref = _reference("train_lm_100m")
    monkeypatch.setattr(sys, "argv", ["train_lm_100m.py", *argv, "--out",
                                      str(tmp_path / "ref")])
    _, ref_lines = _printed(ref.main)
    cfg = ref.config_100m(2)
    weights = jax.tree.map(np.asarray, JModel(cfg, remat=False).init(
        jax.random.PRNGKey(0)))
    got, lines = _printed(train_lm_100m.main,
                          [*argv, "--out", str(tmp_path / "port"),
                           "--device", "cpu"], params=weights)
    assert lines[0] == ref_lines[0]
    pat = rf"\[lm100m\] step\s+(\d+) loss={_NUM} lr={_NUM} \|D\|={_NUM}"
    rows = [re.match(pat, ln) for ln in ref_lines if re.match(pat, ln)]
    assert len(rows) == len(got["history"]) == 2
    for m, h in zip(rows, got["history"]):
        assert int(m[1]) == h["step"]
        for k, v in zip(("loss", "lr", "distance_norm"), m.groups()[1:]):
            _close(v, h[k], (h["step"], k))
    assert [p.name for p in got["ckpts"]] == ["step2.npz", "final.npz"]
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == \
        ["final.npz", "step2.npz"]
    final = T.map(lambda x: x.numpy(), got["alg"].eval_params(got["state"]))
    back = j_restore_pytree(got["ckpts"][-1], weights)
    for a, b in zip(jax.tree.leaves(back), T.leaves(final)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    step2 = j_restore_pytree(got["ckpts"][0], weights)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(step2))
    # the reference's own final checkpoint, from the same weights and
    # data: each leaf's update within TOL of the reference update's scale
    theirs = j_restore_pytree(tmp_path / "ref" / "final.npz", weights)
    for (path, w), a, b in zip(jax.tree_util.tree_leaves_with_path(weights),
                               jax.tree.leaves(back),
                               jax.tree.leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        ours, ref_upd = a - w, b - w
        assert np.abs(ref_upd).max() > 0, path
        # plus one unit in the last place of the leaf's largest value:
        # the update of a weight near 1 (a norm's scale) is read back
        # through that weight's own f32 rounding
        tol = TOL * float(np.abs(ref_upd).max()) + \
            float(np.spacing(np.abs(b).max()))
        np.testing.assert_allclose(ours, ref_upd, rtol=0, atol=tol,
                                   err_msg=str(path))

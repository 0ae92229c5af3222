"""Port parity for Algorithm 1: three steps of ``dc_s3gd`` and ``stale`` on
reduced qwen3-0.6b, from the same weights and batches, against the JAX
reference — per-leaf, bucketed, fused per-leaf and fused-bucketed (the
fused forms run the reference's Pallas kernels in interpret mode) — plus a model-free
probe on a quadratic problem made in numpy.

Tolerances (f32 throughout): each leaf of the update the params took
(w_T − w_0), of ``opt["m"]`` and of ``delta_prev`` within 1e-4 of that
leaf's largest reference magnitude; metrics rtol 1e-5.  The packages take
f32 sums in different orders (matmuls, norms, the worker mean), and D is
a difference of nearly equal deltas, so single elements of the
compensation term differ by more than a few ulps; measured worst cases
on this problem are 2.5e-5 (updates), 3e-6 (m, delta_prev) and 1e-6
(metrics).  Within the port, bucketed == per-leaf bitwise, as
``tests/test_buckets.py`` pins within the reference.

The compressed and quantized wires (``topk``, int8 ``mean_allreduce``) run
through ``dc_s3gd`` and ``ssgd`` at the same tolerances.  Both are
discontinuous in the wire: a coordinate at the top-k threshold, or at an
int8 rounding boundary, flips with a one-ulp change of its input.  topk
runs as a plain trajectory, and a failure reports how many residual
support coordinates flipped.  On the int8 wire the packages' gradients
(about 1e-7 apart) flip whole quanta, amax/127, at about 1e-4 of the
coordinates each step, far beyond 1e-4 of a leaf.  So each reducer call of
the port is fed the reference's wire of that step (recorded inside the
jitted step), while the port's own wire is held to the reference's at the
same 1e-4; the failure messages report how many int8 codes the port's own
wire would have flipped.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import dc_s3gd as j_dc_s3gd
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.core import reduce as j_reduce
from repro.models.transformer import Model as JModel
from repro.optim.schedules import theoretical_lr as j_theoretical_lr
from repro.parallel import buckets as JB
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import dc_s3gd as t_dc_s3gd
from repro_torch.core import reduce as t_reduce
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim.schedules import theoretical_lr as t_theoretical_lr
from torch_threads import one_torch_thread  # noqa: F401

STEPS, BPW, SEQ = 3, 2, 16
HP = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1)
FORMS = {"per_leaf": (0, False), "bucketed": (2, False),
         "fused_per_leaf": (0, True), "fused_bucketed": (2, True)}
TOL = 1e-4          # of each leaf's largest reference magnitude
RTOL_METRICS = 1e-5
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = reduced(get_config("qwen3-0.6b"))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


def _jax_run(algo, W, form, reducer=None, **hp):
    """``STEPS`` steps of the reference; ``reducer`` and ``hp`` (extra
    `DCS3GDConfig` fields) pick the wire."""
    buckets, kernels = FORMS[form]
    cfg = reduced(get_config("qwen3-0.6b"))
    model = JModel(cfg, remat=False)
    alg = jreg.make(algo, JConfig(**HP, **hp), n_workers=W, buckets=buckets,
                    use_kernels=kernels, reducer=reducer)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    data = JData(cfg.vocab_size, SEQ, seed=0)
    history = []
    for t in range(STEPS):
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return jax.tree.map(np.asarray, state), history


def _torch_run(algo, W, form, reducer=None, **hp):
    buckets, kernels = FORMS[form]
    cfg = t_reduced(t_get_config("qwen3-0.6b"))
    model = TModel(cfg, remat=False)
    alg = treg.make(algo, TConfig(**HP, **hp), n_workers=W, buckets=buckets,
                    use_kernels=kernels, reducer=reducer)
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    data = TData(cfg.vocab_size, SEQ, seed=0)
    history = []
    for t in range(STEPS):
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=model.loss)
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return alg, state, history


def _close(ours, theirs, what, base=None):
    """Leaves within TOL of each reference leaf's scale; ``base`` (the
    initial weights) is subtracted from both sides first."""
    a, b = T.leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b), what
    base = [0.0] * len(a) if base is None else jax.tree.leaves(base)
    for x, y, z in zip(a, b, base):
        x, y = x.numpy() - z, np.asarray(y) - z
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=TOL * float(np.abs(y).max()),
                                   err_msg=what)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("algo", ["dc_s3gd", "stale"])
def test_three_steps_match_jax(algo, W, form):
    j_state, j_hist = _jax_run(algo, W, form)
    _, t_state, t_hist = _torch_run(algo, W, form)
    assert t_state.step == int(j_state.step) == STEPS
    _close(t_state.params, j_state.params, "params", base=_weights())
    _close(t_state.opt["m"], j_state.opt["m"], "opt.m")
    _close(t_state.comm["delta_prev"], j_state.comm["delta_prev"],
           "delta_prev")
    for th, jh in zip(t_hist, j_hist):
        for k in METRICS:
            np.testing.assert_allclose(th[k], jh[k], rtol=RTOL_METRICS,
                                       atol=1e-7, err_msg=k)
    if algo == "dc_s3gd":
        assert t_hist[-1]["lambda"] > 0 and t_hist[-1]["distance_norm"] > 0
    else:
        assert all(h["lambda"] == 0 for h in t_hist)


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("algo", ["dc_s3gd", "stale"])
def test_bucketed_is_bitwise_per_leaf(algo, W):
    _, s0, h0 = _torch_run(algo, W, "per_leaf")
    alg, s1, h1 = _torch_run(algo, W, "bucketed")
    plan = alg._plan(s1.params)
    for a, b in zip(T.leaves(s0.params), T.leaves(s1.params)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(s0.opt["m"]), T.leaves(s1.opt["m"])):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(s0.comm["delta_prev"]),
                    T.leaves(plan.unpack(s1.comm["delta_prev"]))):
        assert torch.equal(a, b)
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]


def test_fused_bucketed_padding_stays_zero():
    """The carried bucketed delta_prev never leaks into the padding."""
    alg_b, s_b, _ = _torch_run("dc_s3gd", 2, "fused_bucketed")
    plan = alg_b._plan(s_b.params)
    for b, buf in enumerate(s_b.comm["delta_prev"]):
        used = sum(s.size for s in plan.slots if s.bucket == b)
        assert not buf[:, used:].any()


def test_schedules_match_reference_bitwise():
    hp = dict(learning_rate=0.1, warmup_steps=3, total_steps=11,
              weight_decay=1e-4)
    for step in range(12):
        jl, jw = j_dc_s3gd.schedules(jnp.int32(step), JConfig(**hp))
        tl, tw = t_dc_s3gd.schedules(step, TConfig(**hp))
        assert np.float32(tl) == np.asarray(jl) and np.float32(tw) == \
            np.asarray(jw), step
    assert t_theoretical_lr(0.05, 8) == j_theoretical_lr(0.05, 8)


def test_worker_means_match_reference():
    """`consensus_mean` and `collapse_worker_axis` against the reference;
    the anchor-form consensus of identical rows is bitwise row 0 at W=3."""
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 5, 4)).astype(np.float32),
            "b": rng.standard_normal((3, 7)).astype(np.float32)}
    same = {"a": np.broadcast_to(tree["a"][:1], (3, 5, 4)).copy()}
    for ours, theirs in ((t_reduce.consensus_mean, j_reduce.consensus_mean),
                         (t_reduce.collapse_worker_axis,
                          j_reduce.collapse_worker_axis)):
        got = ours(params_from_numpy(tree, device="cpu"))
        want = theirs(jax.tree.map(jnp.asarray, tree))
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    got = t_reduce.consensus_mean(params_from_numpy(same, device="cpu"))
    np.testing.assert_array_equal(got["a"].numpy(), same["a"][0])


def test_eval_params_is_the_consensus():
    _, state, _ = _torch_run("dc_s3gd", 2, "per_leaf")
    j_state, _ = _jax_run("dc_s3gd", 2, "per_leaf")
    alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=2)
    j_alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=2)
    ours = alg.eval_params(state)
    theirs = j_alg.eval_params(jax.tree.map(jnp.asarray, j_state))
    _close(ours, jax.tree.map(np.asarray, theirs), "eval_params",
           base=_weights())


# ---------------------------------------------------------------------------
# model-free probe: a quadratic problem made in numpy
# ---------------------------------------------------------------------------

N, W_Q, BS = 8, 4, 8


def _quadratic_batch(step):
    rng = np.random.default_rng(1000 + step)
    w_star = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    A = (rng.standard_normal((W_Q, BS, N)) / np.sqrt(N)).astype(np.float32)
    return {"A": A, "y": A @ w_star}


def _j_loss(p, b):
    pred = b["A"] @ (p["w"] + p["mat"].sum(0) * 0.01)
    return 0.5 * jnp.mean((pred - b["y"]) ** 2)


def _t_loss(p, b):
    pred = b["A"] @ (p["w"] + p["mat"].sum(0) * 0.01)
    return 0.5 * ((pred - b["y"]) ** 2).mean()


def _quadratic_parity(buckets, kernels, **extra):
    """Five steps of dc_s3gd on the quadratic problem in both packages;
    metrics rtol 1e-5, final params rtol 1e-5 / atol 1e-6."""
    init = {"w": np.zeros(N, np.float32), "mat": np.zeros((N, N), np.float32)}
    cfg = dict(learning_rate=0.1, momentum=0.9, lambda0=0.2,
               weight_decay=1e-3, total_steps=1, **extra)
    j_alg = jreg.make("dc_s3gd", JConfig(**cfg), n_workers=W_Q,
                      buckets=buckets, use_kernels=kernels)
    t_alg = treg.make("dc_s3gd", TConfig(**cfg), n_workers=W_Q,
                      buckets=buckets, use_kernels=kernels)
    js = j_alg.init(jax.tree.map(jnp.asarray, init))
    ts = t_alg.init(params_from_numpy(init, device="cpu"))
    for t in range(5):
        b = _quadratic_batch(t)
        js, jm = j_alg.step(js, jax.tree.map(jnp.asarray, b),
                            loss_fn=_j_loss)
        ts, tm = t_alg.step(ts, params_from_numpy(b, device="cpu"),
                            loss_fn=_t_loss)
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(T.leaves(params_to_numpy(ts.params)),
                    jax.tree.leaves(js.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    return init, ts


@pytest.mark.parametrize("form", sorted(FORMS))
def test_quadratic_probe_matches_jax(form):
    buckets, kernels = FORMS[form]
    init, ts = _quadratic_parity(buckets, kernels)
    if buckets:
        assert [x.shape[-1] for x in ts.comm["delta_prev"]] == \
            list(JB.plan_buckets(init, buckets).bucket_sizes)


@pytest.mark.parametrize("extra", [{"microbatches": 2}, {"nesterov": True}],
                         ids=["microbatches", "nesterov"])
def test_quadratic_unfused_variants_match_jax(extra):
    """Gradient accumulation over microbatches and the Nesterov form of
    the momentum optimizer, on the unfused per-leaf path."""
    _quadratic_parity(0, False, **extra)


# ---------------------------------------------------------------------------
# the compressed and quantized wires through dc_s3gd and ssgd
# ---------------------------------------------------------------------------

WIRES = {"topk": ("topk", dict(compress_density=0.02)),
         "int8": ("mean_allreduce", dict(comm_dtype="int8"))}


class _RecordWire:
    """A reference reducer that records each call's input wire (numpy),
    through a host callback that runs inside the jitted step."""

    def __init__(self, inner):
        self.inner = inner
        self.wires = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, wire, *state):
        jax.debug.callback(
            lambda w: self.wires.append(jax.tree.map(np.array, w)), wire)
        return self.inner(wire, *state)


class _ReplayWire:
    """A port reducer that keeps its own wire (numpy) and reduces the
    reference's wire of the same call instead."""

    def __init__(self, inner, wires):
        self.inner = inner
        self.wires = wires
        self.own = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, wire, *state):
        self.own.append(params_to_numpy(wire))
        theirs = params_from_numpy(self.wires[len(self.own) - 1],
                                   device="cpu")
        return self.inner(theirs, *state)


def _code_flips(own, theirs, comm_dtype) -> int:
    """Coordinates whose quantized code differs between two wires."""
    from repro_torch.core import quant as Q
    flips = 0
    for a, b in zip(T.leaves(own), jax.tree.leaves(theirs)):
        qa, _ = Q.quantize(torch.from_numpy(np.array(a)), comm_dtype)
        qb, _ = Q.quantize(torch.from_numpy(np.array(b)), comm_dtype)
        flips += int((qa != qb).sum())
    return flips


def _support_flips(ours, theirs) -> int:
    """Residual coordinates selected (zero) in one package only."""
    return sum(int(((r.numpy() == 0) != (np.asarray(jr) == 0)).sum())
               for r, jr in zip(ours["residual"], theirs["residual"]))


# topk compresses per bucket (buckets=0 raises: test_torch_compress.py)
@pytest.mark.parametrize("wire,form", [
    ("topk", "bucketed"), ("topk", "fused_bucketed"), ("int8", "per_leaf"),
    ("int8", "bucketed"), ("int8", "fused_bucketed")])
@pytest.mark.parametrize("algo", ["dc_s3gd", "ssgd"])
def test_compressed_wires_three_steps_match_jax(algo, wire, form):
    name, hp = WIRES[wire]
    W = 2
    if wire == "int8":
        rec = _RecordWire(jreg.make_reducer(name, JConfig(**HP, **hp)))
        j_state, j_hist = _jax_run(algo, W, form, reducer=rec, **hp)
        jax.effects_barrier()
        assert len(rec.wires) == STEPS
        rep = _ReplayWire(treg.make_reducer(name, TConfig(**HP, **hp)),
                          rec.wires)
        alg, t_state, t_hist = _torch_run(algo, W, form, reducer=rep, **hp)
        flips = [_code_flips(o, r, "int8") for o, r in zip(rep.own,
                                                            rec.wires)]
        note = f"int8 codes the port's own wire would flip, per step: {flips}"
        for t, (o, r) in enumerate(zip(rep.own, rec.wires)):
            _close(params_from_numpy(o, device="cpu"), r,
                   f"wire of step {t}; {note}")
    else:
        j_state, j_hist = _jax_run(algo, W, form, reducer=name, **hp)
        alg, t_state, t_hist = _torch_run(algo, W, form, reducer=name, **hp)
        note = ("flipped residual support coordinates: "
                f"{_support_flips(t_state.comm['reducer'], j_state.comm['reducer'])}")
    assert t_state.step == int(j_state.step) == STEPS
    _close(t_state.params, j_state.params, f"params; {note}",
           base=_weights())
    _close(t_state.opt["m"], j_state.opt["m"], f"opt.m; {note}")
    assert sorted(t_state.comm) == sorted(j_state.comm)
    if "delta_prev" in j_state.comm:
        _close(t_state.comm["delta_prev"], j_state.comm["delta_prev"],
               f"delta_prev; {note}")
    if "reducer" in j_state.comm:
        _close(t_state.comm["reducer"]["residual"],
               j_state.comm["reducer"]["residual"], f"residual; {note}")
    for th, jh in zip(t_hist, j_hist):
        assert sorted(th) == sorted(jh)
        for k in th:
            np.testing.assert_allclose(th[k], jh[k], rtol=RTOL_METRICS,
                                       atol=1e-7, err_msg=f"{k}; {note}")

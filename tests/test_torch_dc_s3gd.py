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


def _jax_run(algo, W, form):
    buckets, kernels = FORMS[form]
    cfg = reduced(get_config("qwen3-0.6b"))
    model = JModel(cfg, remat=False)
    alg = jreg.make(algo, JConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    step = jax.jit(functools.partial(alg.step, loss_fn=model.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    data = JData(cfg.vocab_size, SEQ, seed=0)
    history = []
    for t in range(STEPS):
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        history.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state), history


def _torch_run(algo, W, form):
    buckets, kernels = FORMS[form]
    cfg = t_reduced(t_get_config("qwen3-0.6b"))
    model = TModel(cfg)
    alg = treg.make(algo, TConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    data = TData(cfg.vocab_size, SEQ, seed=0)
    history = []
    for t in range(STEPS):
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=model.loss)
        history.append({k: float(m[k]) for k in METRICS})
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

"""Port parity for training the recurrent families: the differentiable
chunked linear-recurrence scan (the reference's ``_ssm_scan_chunked``),
the falcon-mamba loss and gradients through it, W = 2 ``dc_s3gd``
trajectories of reduced falcon-mamba and reduced recurrentgemma against
the JAX package, their decay masks and bucket plans, and a resume from a
port checkpoint of the multi-stage tree.

Tolerances (f32): the scan's y / hs / h_last atol 1e-5 (the Hillis–Steele
scan and ``jax.lax.associative_scan`` combine in other orders: rounding,
not bits); loss and gradients rtol 1e-4 / atol 1e-5, as
``tests/test_torch_dense_family.py``; the trajectories as
``tests/test_torch_dc_s3gd.py`` (each leaf of the update, of ``m`` and of
``delta_prev`` within 1e-4 of that leaf's largest reference magnitude, or
within one f32 ulp of the leaf's largest weight where that is more: the
update of falcon-mamba's ``a_log`` (values up to log 16) is ~2e-3, so 1e-4
of it is below the ulp its difference of two weights can resolve;
metrics rtol 1e-5).  Within the port a resumed run is bitwise the
uninterrupted one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models import ssm as j_ssm
from repro.models.transformer import Model as JModel
from repro.optim.local import _decay_mask as j_decay_mask
from repro.parallel import buckets as JB
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.models import ssm as t_ssm
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim.local import _decay_mask as t_decay_mask
from repro_torch.parallel.buckets import plan_buckets
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = pytest.mark.parametrize("arch", ["falcon-mamba-7b",
                                         "recurrentgemma-9b"])
RTOL, ATOL = 1e-4, 1e-5
W, STEPS, BPW, SEQ = 2, 3, 2, 24
HP = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2, weight_decay=1e-3,
          total_steps=1)
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = reduced(get_config(arch))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


def _models(arch):
    jm = JModel(reduced(get_config(arch)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    tm = TModel(t_reduced(t_get_config(arch)), remat=False, loss_chunk=16,
                scan_chunk=16)
    return jm, tm


def _scan_inputs(B, S, E, N, seed=0):
    """A decay in (0.5, 1) and inputs of unit scale, as a Mamba scan sees
    them, and C."""
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.5, 1.0, (B, S, E, N)).astype(np.float32)
    dBx = rng.standard_normal((B, S, E, N)).astype(np.float32)
    h0 = rng.standard_normal((B, E, N)).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    return dA, dBx, h0, C


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("S,chunk", [(48, 16), (48, 48), (40, 16)])
def test_ssm_scan_chunked_matches_jax(S, chunk, with_c):
    """48 steps in chunks of 16 (three carries) and of 48 (one), and 40
    steps, not a multiple of the chunk, identity-padded to 48 as the
    reference's callers pad (dA = 1, dBx = 0), from a non-zero h0, with
    and without the contraction against C; h_last of the padded scan is
    the state after step 40."""
    dA, dBx, h0, C = _scan_inputs(2, S, 8, 4)
    pad = (-S) % chunk
    dA = np.pad(dA, ((0, 0), (0, pad), (0, 0), (0, 0)), constant_values=1)
    dBx = np.pad(dBx, ((0, 0), (0, pad), (0, 0), (0, 0)))
    C = np.pad(C, ((0, 0), (0, pad), (0, 0)))
    want, wh = j_ssm._ssm_scan_chunked(
        jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(h0), chunk,
        C=jnp.asarray(C) if with_c else None)
    got, gh = t_ssm.ssm_scan_chunked(
        torch.from_numpy(dA), torch.from_numpy(dBx), torch.from_numpy(h0),
        chunk, C=torch.from_numpy(C) if with_c else None)
    assert got.shape == want.shape and gh.shape == wh.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0,
                               atol=1e-5)
    h = h0.astype(np.float64)
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
    np.testing.assert_allclose(gh.numpy(), h, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        t_ssm.ssm_scan_chunked(torch.from_numpy(dA[:, :40]),
                               torch.from_numpy(dBx[:, :40]),
                               torch.from_numpy(h0), 16)


def test_ssm_scan_chunked_gradients_are_the_sequential_recurrence_s():
    """Autograd through the checkpointed chunks (three of 16, and one)
    equals autograd through the plain step-by-step recurrence."""
    dA, dBx, h0, C = (torch.from_numpy(a).double()
                      for a in _scan_inputs(1, 48, 4, 3, seed=1))

    def seq(dA, dBx, h0, C):
        h, ys = h0, []
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            ys.append(torch.einsum("ben,bn->be", h, C[:, t]))
        return torch.stack(ys, 1), h

    weights = torch.randn(1, 48, 4, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (seq, lambda *a: t_ssm.ssm_scan_chunked(*a[:3], 16, C=a[3]),
               lambda *a: t_ssm.ssm_scan_chunked(*a[:3], 48, C=a[3])):
        xs = [t.clone().requires_grad_() for t in (dA, dBx, h0, C)]
        y, h = fn(*xs)
        loss = (y * weights).sum() + h.square().sum()
        grads.append(torch.autograd.grad(loss, xs))
    for g in grads[1:]:
        for a, b in zip(g, grads[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-10)


@pytest.mark.parametrize("S", [40, 48])
def test_mamba_training_scan_matches_jax_and_the_plain_scan(S):
    """falcon-mamba's block through the chunked scan (chunk 16: S 40 pads
    with identity steps, 48 does not): y and the final state against the
    reference's ``mamba_forward``, and the plain sequential scan
    (``use_kernel=False``: ``ssm_scan_plain``) against it too."""
    jm, tm = _models("falcon-mamba-7b")
    np_p = jax.tree.map(lambda a: a[0], _weights("falcon-mamba-7b")
                        ["stage0"]["b0"]["mamba"])
    x = np.random.default_rng(2).standard_normal((2, S, 256)) \
        .astype(np.float32)
    jy, jh = j_ssm.mamba_forward(jax.tree.map(jnp.asarray, np_p),
                                 jnp.asarray(x), jm.cfg.ssm, chunk=16,
                                 return_state=True)
    tp = params_from_numpy(np_p, device="cpu")
    ty, th = t_ssm.mamba_forward(tp, torch.from_numpy(x), tm.cfg.ssm,
                                 chunk=16, return_state=True)
    py, ph = t_ssm.mamba_forward(tp, torch.from_numpy(x), tm.cfg.ssm,
                                 return_state=True, use_kernel=False)
    for got in ((ty, th), (py, ph)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jh), rtol=0,
                                   atol=1e-5)


@ARCHS
def test_loss_and_grads_match_jax(arch):
    jm, tm = _models(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 40)).astype(np.int32)}
    batch["labels"][:, -2:] = -1
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _weights(arch)),
        jax.tree.map(jnp.asarray, batch))
    tp = params_from_numpy(_weights(arch), device="cpu")
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, params_from_numpy(batch, device="cpu"))
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


@ARCHS
def test_decay_mask_and_bucket_plan_match_reference(arch):
    """Under the worker axis the reference's rank test decays every
    stacked leaf (``lam`` (W, L, w), ``conv_b``, the norm scales, the
    stage-1 leaves) and not ``final_norm``; the port mirrors it, and
    plans the same buckets."""
    np_p = _weights(arch)
    stacked = jax.tree.map(lambda a: np.stack([a, a]), np_p)
    want = jax.tree.leaves(j_decay_mask(jax.tree.map(jnp.asarray, stacked),
                                        axis0_is_worker=True))
    got = T.leaves(t_decay_mask(params_from_numpy(stacked, device="cpu"),
                                axis0_is_worker=True))
    assert [float(x) for x in got] == [float(x) for x in want]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(np_p)[0]]
    decay = dict(zip(paths, got))
    assert decay["['final_norm']['scale']"] == 0.0
    if arch == "recurrentgemma-9b":
        assert decay["['stage0']['b0']['rglru']['lam']"] == 1.0
        assert decay["['stage1']['b0']['rglru']['conv_b']"] == 1.0
    for n in (2, 4):
        jplan = JB.plan_buckets(jax.tree.map(jnp.asarray, np_p), n)
        tplan = plan_buckets(params_from_numpy(np_p, device="cpu"), n)
        assert tplan.bucket_sizes == tuple(jplan.bucket_sizes)
        assert tplan.bucket_decay == tuple(jplan.bucket_decay)


def _jax_run(arch, buckets, kernels):
    cfg = reduced(get_config(arch))
    jm, _ = _models(arch)
    alg = jreg.make("dc_s3gd", JConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    step = jax.jit(functools.partial(alg.step, loss_fn=jm.loss))
    state = alg.init(jax.tree.map(jnp.asarray, _weights(arch)))
    data = JData(cfg.vocab_size, SEQ, seed=0)
    hist = []
    for t in range(STEPS):
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        hist.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state), hist


def _torch_run(arch, buckets, kernels):
    cfg = t_reduced(t_get_config(arch))
    _, tm = _models(arch)
    alg = treg.make("dc_s3gd", TConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    state = alg.init(params_from_numpy(_weights(arch), device="cpu"))
    data = TData(cfg.vocab_size, SEQ, seed=0)
    hist = []
    for t in range(STEPS):
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=tm.loss)
        hist.append({k: float(m[k]) for k in METRICS})
    return state, hist


@ARCHS
@pytest.mark.parametrize("form", ["per_leaf", "fused_bucketed"])
def test_dc_s3gd_trajectory_matches_jax(arch, form):
    """Three dc_s3gd steps at W = 2 (the fused, bucketed form runs the
    reference's Pallas kernels in interpret mode and A1/A2's plain
    versions here): the update of every leaf, m and delta_prev."""
    buckets, kernels = {"per_leaf": (0, False),
                        "fused_bucketed": (2, True)}[form]
    j_state, j_hist = _jax_run(arch, buckets, kernels)
    t_state, t_hist = _torch_run(arch, buckets, kernels)
    for th, jh in zip(t_hist, j_hist):
        for k in METRICS:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert t_hist[-1]["lambda"] > 0
    base = jax.tree.leaves(_weights(arch))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(_weights(arch))[0]]
    for what, ours, theirs, sub in (
            ("params", t_state.params, j_state.params, base),
            ("m", t_state.opt["m"], j_state.opt["m"], None),
            ("delta_prev", t_state.comm["delta_prev"],
             j_state.comm["delta_prev"], None)):
        leaves = jax.tree.leaves(theirs)
        assert len(T.leaves(ours)) == len(leaves)
        for i, (x, y) in enumerate(zip(T.leaves(ours), leaves)):
            x, y = x.numpy(), np.asarray(y)
            ulp = 0.0
            if sub is not None:
                x, y = x - sub[i], y - sub[i]
                # an update is known to one ulp of the weight it moved:
                # a_log (up to log 16) moves by ~1e-3, below 1e-4 of it
                ulp = float(np.spacing(np.abs(sub[i]).max()))
            np.testing.assert_allclose(
                x, y, rtol=0, atol=max(1e-4 * float(np.abs(y).max()), ulp),
                err_msg=f"{what} {paths[i]}")


def _train(tmp_path, steps, *extra):
    args = train.build_argparser().parse_args([
        "--arch", "recurrentgemma-9b", "--reduced", "--algo", "dc_s3gd",
        "--workers", str(W), "--batch-per-worker", str(BPW), "--seq",
        str(SEQ), "--steps", str(steps), "--buckets", "2", "--use-kernels",
        "--log-every", "1", "--device", "cpu", *extra])
    return train.run(args)


def test_resume_from_a_port_checkpoint_of_the_multi_stage_tree(tmp_path):
    """Reduced recurrentgemma (``stage0`` and ``stage1``) through the
    train entry point: 2 steps, ``--ckpt``, then ``--resume`` to step 3,
    against 3 steps uninterrupted: every leaf of the state and the last
    loss bitwise."""
    whole = _train(tmp_path, 3)
    _train(tmp_path, 2, "--ckpt", str(tmp_path / "half.npz"))
    resumed = _train(tmp_path, 3, "--resume", str(tmp_path / "half.npz"))
    assert resumed["start"] == 2
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == 3
    for x, y in zip(T.leaves((a.params, a.opt, a.comm)),
                    T.leaves((b.params, b.opt, b.comm))):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert sorted(a.params) == ["embed", "final_norm", "stage0", "stage1",
                                "unembed"]
    assert whole["history"][-1]["loss"] == resumed["history"][-1]["loss"]
    assert np.isfinite(whole["history"][-1]["loss"])

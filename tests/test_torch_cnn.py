"""Port parity for the paper's CNN main path: the synthetic images, the
conv layer's SAME padding, ResNet / VGG forward and gradients, the
ResNet-18 bucket plan, ssgd / stale / dc_s3gd trajectories at W = 8 and
the twin of ``examples/cnn_paper_repro.py``, each against the JAX
reference on the same numpy inputs and carried-over weights.

Tolerances (f32 throughout):

* forward, loss, gradients and top-1 error: 1e-5 absolute;
* trajectories (the reduced ResNet of the example: stages (1, 1), width
  8, 8 classes, 16 x 16 images, W = 8, 16 images per worker, 5 steps):
  the final weights ``np.testing.assert_allclose(rtol=1e-5, atol=1e-4 x
  the leaf's largest update w_T − w_0)``; ``opt["m"]`` and ``delta_prev``
  with ``atol = 1e-4 x`` the leaf's largest reference magnitude, rtol
  1e-5; metrics rtol 1e-5.  The rtol term is what admits the leaves whose
  update is a few thousand ulps of the weight (``blocks[0].conv2`` moves
  by ~1.7e-4 at a magnitude of ~0.3 because SkipInit's scale starts at
  0): there one ulp of w_T is 1.8e-4 of the update.  Measured worst
  cases: 3e-8 absolute on the weights, 5e-6 of the leaf scale on m,
  1.3e-7 relative on the metrics;
* the example twin: the last step's loss within 1e-4, the top-1 error
  within one image of the 256 evaluated (argmax may flip on a near tie).

Within the port, bitwise: bucketed == per-leaf (both tails), fused ==
unfused per leaf (the plain versions run the same arithmetic).  The
fused bucketed tail sums the Eq. 17 norms per bucket instead of per leaf,
so its λ differs in the last bits; it is held to JAX at the tolerances.
"""
import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.data import SyntheticImageDataset as JImages
from repro.data import worker_batches as j_worker_batches
from repro.models import cnn as J
from repro.parallel import buckets as JB
from repro_torch import tree as T
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticImageDataset, prefetch
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.examples import cnn_paper_repro as twin
from repro_torch.interop import params_from_numpy
from repro_torch.models import cnn as C
from repro_torch.parallel.buckets import plan_buckets

ROOT = Path(__file__).resolve().parents[1]
W, STEPS, BPW = 8, 5, 16
NET = dict(stages=(1, 1), width=8, n_classes=8)
HP = dict(learning_rate=0.4, momentum=0.9, lambda0=0.2, weight_decay=1e-4,
          warmup_steps=1, total_steps=STEPS)
FORMS = {"per_leaf": (0, False), "bucketed": (4, False),
         "fused_per_leaf": (0, True), "fused_bucketed": (4, True)}
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one CPU thread while this module runs: its convolutions
    are small, and the suite runs several worker processes at once, where
    every process's own thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(seed=0, **net):
    net = net or NET
    return jax.tree.map(np.asarray,
                        J.init_resnet(jax.random.PRNGKey(seed), **net))


def _batch(seed=3, b=4, size=16, classes=8):
    return SyntheticImageDataset(classes, image_size=size, seed=seed,
                                 noise=0.4).batch(0, 0, b)


# --- data -------------------------------------------------------------------


def test_images_and_labels_are_bitwise_the_reference():
    ours = SyntheticImageDataset(10, image_size=12, seed=3, noise=0.5)
    theirs = JImages(10, image_size=12, seed=3, noise=0.5)
    np.testing.assert_array_equal(ours.prototypes, theirs.prototypes)
    for step, worker in ((0, 0), (7, 3)):
        a, b = ours.batch(step, worker, 5), theirs.batch(step, worker, 5)
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    stacked = t_worker_batches(ours, 2, 3, 4, device="cpu")
    ref = j_worker_batches(theirs, 2, 3, 4)
    assert stacked["images"].shape == (3, 4, 12, 12, 3)
    assert stacked["labels"].dtype == torch.int32
    for k in ("images", "labels"):
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(ref[k]))


def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(prefetch(iter(range(7)), size=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    it = prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


# --- the conv layer -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("H", [7, 8, 32])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_lax_same_padding(stride, H, k):
    rng = np.random.default_rng(H * 10 + k)
    x = rng.standard_normal((2, H, H + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(J.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = C.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_symmetric_padding_is_shifted_at_stride_2():
    """Negative control: at H = 32, k = 3, s = 2 XLA pads 0 before and 1
    after; F.conv2d(padding=1) pads 1 on both sides — the same shape,
    every window one pixel off."""
    assert C.same_pads(32, 3, 2) == (0, 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    want = np.asarray(J.conv2d(jnp.asarray(x), jnp.asarray(w), 2))
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=1).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1.0
    got = C.conv2d(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- models -----------------------------------------------------------------


def _grads(loss_fn, params, batch):
    leaves, treedef = T.flatten(params)
    leaves = [x.clone().requires_grad_() for x in leaves]
    loss = loss_fn(T.unflatten(treedef, leaves), batch)
    return loss, torch.autograd.grad(loss, leaves)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("name", ["resnet", "vgg"])
def test_logits_loss_gradients_and_top1_match(name):
    if name == "resnet":
        w = _weights(stages=(1, 2), width=8, n_classes=8)
        apply_j, apply_t, size = J.resnet_apply, C.resnet_apply, 16
    else:   # 18 -> 9 -> 4: the second pool drops an odd edge (VALID)
        w = jax.tree.map(np.asarray, J.init_vgg(
            jax.random.PRNGKey(1), widths=(8, 16), n_classes=8))
        apply_j, apply_t, size = J.vgg_apply, C.vgg_apply, 18
    batch = _batch(size=size, b=6)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tw = params_from_numpy(w, device="cpu")
    if name == "resnet":   # a non-zero SkipInit scale: the residual counts
        w = dict(w, blocks=[dict(b, scale=np.float32(0.5))
                            for b in w["blocks"]])
        tw = params_from_numpy(w, device="cpu")
    jw = jax.tree.map(jnp.asarray, w)
    _close(apply_t(tw, tb["images"]).numpy(),
           jax.jit(apply_j)(jw, batch["images"]))
    j_loss, j_grads = jax.jit(jax.value_and_grad(J.cnn_loss_fn(apply_j)))(
        jw, batch)
    t_loss, t_grads = _grads(C.cnn_loss_fn(apply_t), tw, tb)
    _close(t_loss.item(), j_loss)
    for a, b in zip(t_grads, jax.tree.leaves(j_grads)):
        assert a.shape == b.shape
        _close(a.numpy(), b)
    _close(C.top1_error(apply_t, tw, tb).item(),
           jax.jit(functools.partial(J.top1_error, apply_j))(jw, batch))


def test_init_resnet_matches_reference_layout():
    ours = C.init_resnet(torch.Generator().manual_seed(0), stages=(2, 2),
                         width=8, n_classes=5)
    theirs = _weights(stages=(2, 2), width=8, n_classes=5)
    assert [tuple(x.shape) for x in T.leaves(ours)] == \
        [x.shape for x in jax.tree.leaves(theirs)]
    assert all(x.dtype == torch.float32 for x in T.leaves(ours))
    assert [b["scale"].item() for b in ours["blocks"]] == [0.0] * 4
    assert C._resnet_strides((2, 2)) == J._resnet_strides((2, 2))


@pytest.mark.parametrize("net,n_buckets,counts", [
    # the card's ResNet-18 layout at --buckets 4
    (dict(stages=(2, 2, 2, 2), width=64, n_classes=10), 4,
     (11_164_360, 29, (2_785_280, 1_179_648, 2_490_368, 2_359_296,
                       2_392_064, 32_768), (True,) * 5 + (False,))),
    # the parity config
    (NET, 4, (5_082, 9, (32_768,) * 5, (True,) * 4 + (False,))),
])
def test_plan_buckets_equals_the_reference_plan(net, n_buckets, counts):
    """The port's plan on its own params against the reference's on
    `jax.eval_shape` shapes (no compute): sizes, slots, decay."""
    shapes = jax.eval_shape(lambda: J.init_resnet(jax.random.PRNGKey(0),
                                                  **net))
    ref = JB.plan_buckets(shapes, n_buckets)
    ours = plan_buckets(C.init_resnet(torch.Generator().manual_seed(0),
                                      **net), n_buckets)
    n_params, n_leaves, sizes, decay = counts
    assert sum(s.size for s in ours.slots) == n_params
    assert len(ours.slots) == n_leaves
    assert ours.bucket_sizes == tuple(ref.bucket_sizes) == sizes
    assert ours.bucket_decay == tuple(ref.bucket_decay) == decay
    for a, b in zip(ours.slots, ref.slots):
        assert (a.bucket, a.offset, a.size, a.shape) == \
            (b.bucket, b.offset, b.size, tuple(b.shape))
    # the no-decay bucket holds exactly the SkipInit scalars
    last = [s for s in ours.slots if s.bucket == len(sizes) - 1]
    assert [s.shape for s in last] == [()] * sum(net["stages"])


# --- trajectories ---------------------------------------------------------


def _loss_j():
    return J.cnn_loss_fn(J.resnet_apply)


@functools.lru_cache(maxsize=None)
def _jax_run(algo, form):
    buckets, kernels = FORMS[form]
    alg = jreg.make(algo, JConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    step = jax.jit(functools.partial(alg.step, loss_fn=_loss_j()))
    state = alg.init(jax.tree.map(jnp.asarray, _weights()))
    data = JImages(8, image_size=16, seed=0, noise=0.4)
    history = []
    for t in range(STEPS):
        state, m = step(state, j_worker_batches(data, t, W, BPW))
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return jax.tree.map(np.asarray, state), history


def _torch_run(algo, form):
    buckets, kernels = FORMS[form]
    alg = treg.make(algo, TConfig(**HP), n_workers=W, buckets=buckets,
                    use_kernels=kernels)
    state = alg.init(params_from_numpy(_weights(), device="cpu"))
    data = SyntheticImageDataset(8, image_size=16, seed=0, noise=0.4)
    loss_fn = C.cnn_loss_fn(C.resnet_apply)
    history = []
    for t in range(STEPS):
        state, m = alg.step(state, t_worker_batches(data, t, W, BPW,
                                                    device="cpu"),
                            loss_fn=loss_fn)
        history.append({k: float(m[k]) for k in METRICS if k in m})
    return alg, state, history


def _assert_state_close(t_state, j_state, w0):
    for x, y, z in zip(T.leaves(t_state.params),
                       jax.tree.leaves(j_state.params), jax.tree.leaves(w0)):
        y = np.asarray(y)
        np.testing.assert_allclose(
            x.numpy(), y, rtol=1e-5,
            atol=1e-4 * float(np.abs(y - z).max()), err_msg="params")
    for what in ("opt", "comm"):
        ours, theirs = getattr(t_state, what), getattr(j_state, what)
        key = "m" if what == "opt" else "delta_prev"
        if key not in theirs:
            continue
        for x, y in zip(T.leaves(ours[key]), jax.tree.leaves(theirs[key])):
            y = np.asarray(y)
            np.testing.assert_allclose(
                x.numpy(), y, rtol=1e-5, atol=1e-4 * float(np.abs(y).max()),
                err_msg=key)


def _assert_history_close(t_hist, j_hist):
    for th, jh in zip(t_hist, j_hist):
        for k in jh:
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("algo,form", [
    ("ssgd", "per_leaf"), ("ssgd", "bucketed"),
    *((a, f) for a in ("stale", "dc_s3gd") for f in sorted(FORMS))])
def test_trajectories_match_jax(algo, form):
    j_state, j_hist = _jax_run(algo, form)
    _, t_state, t_hist = _torch_run(algo, form)
    assert t_state.step == int(j_state.step) == STEPS
    if algo == "ssgd":
        t_state = t_state._replace(params=T.map(
            lambda p: p.unsqueeze(0), t_state.params))
        j_state = j_state._replace(params=jax.tree.map(
            lambda p: p[None], j_state.params))
        w0 = jax.tree.map(lambda p: p[None], _weights())
    else:
        w0 = _weights()
    _assert_state_close(t_state, j_state, w0)
    _assert_history_close(t_hist, j_hist)
    if algo == "dc_s3gd":
        assert t_hist[-1]["lambda"] > 0 and t_hist[-1]["distance_norm"] > 0
    elif algo == "stale":
        assert all(h["lambda"] == 0 for h in t_hist)


@pytest.mark.parametrize("algo,fused", [("ssgd", False), ("stale", False),
                                        ("stale", True), ("dc_s3gd", False)])
def test_bucketed_is_bitwise_per_leaf(algo, fused):
    """(dc_s3gd's fused bucketed tail sums λ's norms per bucket, so it is
    held to JAX only; see the module docstring.)"""
    names = ("fused_per_leaf", "fused_bucketed") if fused \
        else ("per_leaf", "bucketed")
    _, s0, h0 = _torch_run(algo, names[0])
    _, s1, h1 = _torch_run(algo, names[1])
    for a, b in zip(T.leaves(s0.params), T.leaves(s1.params)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(s0.opt["m"]), T.leaves(s1.opt["m"])):
        assert torch.equal(a, b)
    # (the fused bucketed tail takes |D| and |Δw| over buckets: those two
    # metrics differ in the last bits)
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]


@pytest.mark.parametrize("algo", ["stale", "dc_s3gd"])
def test_fused_per_leaf_is_bitwise_unfused(algo):
    _, s0, h0 = _torch_run(algo, "per_leaf")
    _, s1, h1 = _torch_run(algo, "fused_per_leaf")
    for a, b in zip(T.leaves(s0.params), T.leaves(s1.params)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(s0.opt["m"]), T.leaves(s1.opt["m"])):
        assert torch.equal(a, b)
    assert h0 == h1


# --- the example twin -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "_jax_cnn_paper_repro", ROOT / "examples" / "cnn_paper_repro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("algo", ["ssgd", "stale", "dc_s3gd"])
def test_example_twin_matches_the_reference_example(algo):
    j_loss, j_err = _jax_example().train(algo, 4, 6)
    r = twin.train(algo, 4, 6, device="cpu", params=_weights())
    assert abs(r["loss"] - j_loss) <= 1e-4, (r["loss"], j_loss)
    assert abs(r["top1_err"] - j_err) <= 1 / 256 + 1e-7, \
        (r["top1_err"], j_err)
    assert math.isfinite(r["images_per_s"]) and r["state"].step == 6


def test_example_entry_point_turns_tf32_off(capsys):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        twin.main(["--workers", "2", "--steps", "2", "--device", "cpu"])
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True   # PyTorch's default
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()
            if ln.split() and ln.split()[0] in ("ssgd", "stale", "dc_s3gd")]
    assert [r[0] for r in rows] == ["ssgd", "stale", "dc_s3gd"]
    assert all(math.isfinite(float(r[1])) and 0 <= float(r[2]) <= 1
               for r in rows)

"""Port parity for the compressed wire: the fused compression body
``select_ef_mean`` (plain version on the CPU), ``magnitude_threshold``,
and the four error-feedback reducers, each against the JAX package on
the same numpy inputs.

Tolerances, and why:

* residuals, thresholds and W = 2 means are **bitwise**: the ops are
  elementwise or order-free (a sum of two), and the threshold search
  counts integers;
* W = 4 means: within one ulp of the wire dtype, because XLA may add the
  four worker rows in another order than the port's worker order;
* powersgd: its matmuls and LAPACK QR take f32 sums in other orders, so
  factors, outputs and residuals are held to 1e-5 of each array's largest
  magnitude, after checking that the QR column signs agree.

randk's support and powersgd's initial Q come from ``jax.random`` in the
reference; the tests draw them with jax and hand them to the port through
its ``indices`` / ``q0`` hooks.  The ``gpu`` test holds the CUDA kernel
bitwise against the plain version on the card and skips where there is
none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as JC
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.kernels import compress as JKC
from repro.kernels import ref as jref
from repro.parallel import buckets as JB
from repro_torch.core import compress as C
from repro_torch.core import registry as treg
from repro_torch.core.reduce import MeanAllReduce
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.interop import (params_from_numpy, reducer_state_from_numpy,
                                 reducer_state_to_numpy)
from repro_torch.kernels import compress as KC
from repro_torch.parallel import buckets as TB
from torch_threads import one_torch_thread  # noqa: F401

W = 2
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def _t(a):
    return params_from_numpy(a, device="cpu")


def _payload(rng, shape):
    """Gradient-like values: normal, with scales spread over decades."""
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-6, 2, shape))).astype(np.float32)


def _order(x: np.ndarray) -> np.ndarray:
    """f32 bit patterns mapped to integers that order like the floats, so
    a difference of these is a distance in ulps."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _max_ulps(ours: torch.Tensor, theirs, dtype: torch.dtype) -> int:
    """Largest distance in ulps of ``dtype`` (f32, or bf16/f16 values held
    in f32)."""
    a, b = ours.numpy(), np.asarray(theirs, np.float32)
    if dtype == torch.float32:
        return int(np.abs(_order(a) - _order(b)).max())
    # one bf16/f16 ulp of v is the f32 spacing of v times 2**(23 - mantissa)
    mant = 7 if dtype == torch.bfloat16 else 10
    step = np.maximum(np.spacing(np.abs(b)), np.finfo(np.float32).tiny) \
        * 2.0 ** (23 - mant)
    return int(np.ceil((np.abs(a - b) / step).max()))


# ---------------------------------------------------------------------------
# select_ef_mean: plain version vs the Pallas kernel (interpret) and oracle
# ---------------------------------------------------------------------------


def _select_inputs(w, n, seed):
    rng = np.random.default_rng(seed)
    a = _payload(rng, (w, n))
    a[:, ::97] = 0.0
    thresh = np.quantile(np.abs(a), 0.97, axis=1, keepdims=True) \
        .astype(np.float32)
    return a, thresh


@pytest.mark.parametrize("union", [False, True])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("w", [2, 4])
def test_select_ef_mean_plain_matches_pallas_and_ref(w, blocks, wire, union):
    a, thresh = _select_inputs(w, blocks * JKC.BLOCK, seed=w + blocks)
    mean, res = KC.select_ef_mean(_t(a), _t(thresh), comm_dtype=TDT[wire],
                                  union=union)
    assert mean.shape == (1, a.shape[1]) and res.shape == a.shape
    dt = jnp.dtype(wire)
    for jm, jr in (JKC.select_ef_mean(jnp.asarray(a), jnp.asarray(thresh),
                                      comm_dtype=dt, union=union,
                                      interpret=True),
                   jref.select_ef_mean_ref(jnp.asarray(a),
                                           jnp.asarray(thresh),
                                           comm_dtype=dt, union=union)):
        np.testing.assert_array_equal(res.numpy(), np.asarray(jr))
        if w == 2:
            np.testing.assert_array_equal(mean.numpy(), np.asarray(jm))
        else:
            assert _max_ulps(mean, jm, TDT[wire]) <= 1


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "float16"])
def test_select_ef_mean_zero_threshold_is_the_dense_mean(wire):
    a, _ = _select_inputs(W, 5000, seed=9)
    zero = np.zeros((W, 1), np.float32)
    for union in (False, True):
        mean, res = KC.select_ef_mean(_t(a), _t(zero), comm_dtype=TDT[wire],
                                      union=union)
        dense = MeanAllReduce(comm_dtype=wire)([_t(a)])[0]
        assert torch.equal(mean, dense)
        assert not res.any()


# ---------------------------------------------------------------------------
# magnitude_threshold: bitwise on the exact and coarse paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(1000, 10), (32768, 327), (32768, 1),
                                 (65536, 655), (100_003, 2000),
                                 (200_000, 7), (50, 50)])
def test_magnitude_threshold_bitwise_the_reference(n, k):
    rng = np.random.default_rng(n + k)
    mag = np.abs(_payload(rng, (3, n)))
    mag[1, : n // 3] = 0.0          # a row with many ties at zero
    ours = C.magnitude_threshold(_t(mag), k)
    theirs = JC.magnitude_threshold(jnp.asarray(mag), k)
    assert ours.shape == (3, 1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert ((mag >= ours.numpy()).sum(axis=1) >= min(k, n)).all()


def test_magnitude_threshold_on_the_reference_fallback_case():
    """All large values at odd stride-16 offsets: the reference's 1/16
    subsample sees none of them and its ``lax.cond`` falls back to the
    full-row search; the port's top-k of the full row has no fallback."""
    n, k = JC.EXACT_TOPK_MAX * 2, 97
    rng = np.random.default_rng(3)
    base = np.abs(rng.standard_normal((2, n))).astype(np.float32) * 1e-3
    base[0, 1:2 * k * 16:16] += 100.0
    ours = C.magnitude_threshold(_t(base), k).numpy()
    theirs = np.asarray(JC.magnitude_threshold(jnp.asarray(base), k))
    np.testing.assert_array_equal(ours, theirs)
    kth = np.sort(base[0])[::-1][k - 1]
    hi_floor = ((np.float32(kth).view(np.int32) >> 16) << 16) \
        .astype(np.int32).view(np.float32)
    assert ours[0, 0] == hi_floor


# ---------------------------------------------------------------------------
# the reducers: three chained calls on the same numpy wire in both packages
# ---------------------------------------------------------------------------

SEED = 3
REDUCERS = {
    "topk": (C.TopKReduce, JC.TopKReduce, dict(density=0.01)),
    "topk_exact": (C.TopKExactReduce, JC.TopKExactReduce,
                   dict(density=0.01)),
    "randk": (C.RandKReduce, JC.RandKReduce, dict(density=0.01, seed=SEED)),
    "powersgd": (C.PowerSGDReduce, JC.PowerSGDReduce,
                 dict(rank=2, seed=SEED)),
}


def _plans():
    """A (50,) vector and a (300, 400) matrix: one exact-path bucket of
    32768 and one coarse-path bucket of 131072, equal in both packages."""
    tree = {"b": np.zeros(50, np.float32),
            "w": np.zeros((300, 400), np.float32)}
    tp = TB.plan_buckets(_t(tree), 1)
    jp = JB.plan_buckets(jax.tree.map(jnp.asarray, tree), 1)
    assert tp.bucket_sizes == jp.bucket_sizes == (32768, 131072)
    return tp, jp


def _make(name, comm_dtype, kernels=False):
    ours, theirs, kw = REDUCERS[name]
    t, j = ours(comm_dtype=comm_dtype, **kw), theirs(comm_dtype=comm_dtype,
                                                    **kw)
    t.use_kernels = j.use_kernels = kernels
    return t, j


def _q0(jred, plan):
    """The reference's initial powersgd draws, before its QR."""
    key = jax.random.PRNGKey(jred.seed)
    return [np.asarray(jax.random.normal(
        jax.random.fold_in(key, b), jred._dims(n)[1:], jnp.float32))
        for b, n in enumerate(plan.bucket_sizes)]


def _randk_indices(jred, jstate, sizes):
    """The reference's shared randk supports for this call."""
    key = jax.random.fold_in(jax.random.PRNGKey(jred.seed), jstate["step"])
    return [_t(jax.random.permutation(jax.random.fold_in(key, b), n)
               [:C._k_of(n, jred.density)])
            for b, n in enumerate(sizes)]


def _same_signs(ours: torch.Tensor, theirs) -> None:
    """QR factors: each column points the same way in both packages."""
    dots = (ours.numpy() * np.asarray(theirs)).sum(axis=0)
    assert (dots > 0).all(), dots


def _assert_state(name, tst, jst):
    exact = name != "powersgd"
    for r, jr in zip(tst["residual"], jst["residual"]):
        _assert_close(r, jr, exact)
    if name == "randk":
        assert tst["step"] == int(jst["step"])
    if name == "powersgd":
        for q, jq in zip(tst["q"], jst["q"]):
            _same_signs(q, jq)
            _assert_close(q, jq, exact=False)


def _assert_close(ours: torch.Tensor, theirs, exact: bool) -> None:
    theirs = np.asarray(theirs)
    if exact:
        np.testing.assert_array_equal(ours.numpy(), theirs)
    else:
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-5 * float(np.abs(theirs).max()))


@pytest.mark.parametrize("comm_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducer_three_chained_calls_match_the_reference(name, comm_dtype):
    tp, jp = _plans()
    tred, jred = _make(name, comm_dtype)
    jst = jred.init(W, jp)
    if name == "powersgd":
        tst = tred.init(W, tp, q0=_t(_q0(jred, jp)))
    else:
        tst = tred.init(W, tp)
    _assert_state(name, tst, jst)
    rng = np.random.default_rng(11)
    for _ in range(3):
        wire = [_payload(rng, (W, n)) for n in tp.bucket_sizes]
        if name == "randk":
            idx = _randk_indices(jred, jst, tp.bucket_sizes)
            tout, tst = tred(_t(wire), tst, indices=idx)
        else:
            tout, tst = tred(_t(wire), tst)
        jout, jst = jred([jnp.asarray(x) for x in wire], jst)
        for o, jo in zip(tout, jout):
            assert o.shape == jo.shape and o.dtype == torch.float32
            _assert_close(o, jo, exact=name != "powersgd")
        _assert_state(name, tst, jst)


@pytest.mark.parametrize("comm_dtype", ["float32", "bfloat16", "float16",
                                        "int8", "fp8"])
@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_reducer_accounting_matches_the_reference(name, comm_dtype):
    tp, jp = _plans()
    tred, jred = _make(name, comm_dtype)
    tred.init(W, tp)
    jred.init(W, jp)
    sizes = list(tp.bucket_sizes) + [1000, 7]
    assert tred.wire_bytes(sizes) == jred.wire_bytes(sizes)
    assert tred.hparams == jred.hparams


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_revoke_and_resize_match_the_reference(name):
    tp, jp = _plans()
    tred, jred = _make(name, "float32")
    rng = np.random.default_rng(5)
    jprev = jred.init(W, jp)
    jprev["residual"] = [jnp.asarray(_payload(rng, (W, n)))
                         for n in jp.bucket_sizes]
    wire = [_payload(rng, (W, n)) for n in tp.bucket_sizes]
    jnew = jred.init(W, jp)
    jnew["residual"] = [jnp.asarray(_payload(rng, (W, n)))
                        for n in jp.bucket_sizes]
    tprev = reducer_state_from_numpy(jax.tree.map(np.asarray, jprev),
                                     device="cpu")
    tnew = reducer_state_from_numpy(jax.tree.map(np.asarray, jnew),
                                    device="cpu")
    ours = tred.revoke(_t(wire), tprev, tnew)
    theirs = jred.revoke([jnp.asarray(x) for x in wire], jprev, jnew)
    _assert_state(name, ours, theirs)
    for n_new in (1, 3):
        ours = tred.resize(tnew, n_new)
        theirs = jred.resize(jnew, n_new)
        # the port returns one worker's share; resize_state expands it
        assert [r.shape for r in ours["residual"]] == \
            [(1,) + r.shape[1:] for r in theirs["residual"]]
        ours["residual"] = [r.expand((n_new,) + r.shape[1:])
                            for r in ours["residual"]]
        _assert_state(name, ours, theirs)


def test_reducer_state_round_trips_through_numpy():
    """A reference ``comm["reducer"]`` crosses into the port and back with
    its structure, dtypes and values."""
    _, jp = _plans()
    for name in ("randk", "powersgd"):
        _, jred = _make(name, "float32")
        jst = jax.tree.map(np.asarray, jred.init(W, jp))
        jst["step"] = np.asarray(4, np.int32) if "step" in jst else None
        jst = {k: v for k, v in jst.items() if v is not None}
        ours = reducer_state_from_numpy(jst, device="cpu")
        back = reducer_state_to_numpy(ours)
        assert sorted(back) == sorted(jst)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if name == "randk":
            assert ours["step"] == 4


# ---------------------------------------------------------------------------
# pins inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", ["topk", "topk_exact"])
def test_topk_full_density_is_bitwise_mean_allreduce(name, kernels,
                                                     comm_dtype):
    tp, _ = _plans()
    red = REDUCERS[name][0](comm_dtype=comm_dtype, density=1.0)
    red.use_kernels = kernels
    rng = np.random.default_rng(2)
    wire = _t([_payload(rng, (W, n)) for n in tp.bucket_sizes])
    out, st = red(wire, red.init(W, tp))
    dense = MeanAllReduce(comm_dtype=comm_dtype)(wire)
    for o, d in zip(out, dense):
        assert torch.equal(o, d)
    if comm_dtype != "int8":
        assert not any(r.any() for r in st["residual"])


@pytest.mark.parametrize("comm_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name", ["topk", "topk_exact"])
def test_use_kernels_reducer_is_bitwise_the_unfused_one(name, comm_dtype):
    """Three chained calls; also bitwise the reference's own kernel path
    (its Pallas body in interpret mode) on the f32 and bf16 wires."""
    tp, jp = _plans()
    plain, _ = _make(name, comm_dtype)
    fused, jfused = _make(name, comm_dtype, kernels=True)
    s0, s1 = plain.init(W, tp), fused.init(W, tp)
    js = jfused.init(W, jp) if comm_dtype != "float16" else None
    rng = np.random.default_rng(8)
    for _ in range(3):
        wire = [_payload(rng, (W, n)) for n in tp.bucket_sizes]
        o0, s0 = plain(_t(wire), s0)
        o1, s1 = fused(_t(wire), s1)
        for a, b in zip(o0 + s0["residual"], o1 + s1["residual"]):
            assert torch.equal(a, b)
        if js is not None:
            jo, js = jfused([jnp.asarray(x) for x in wire], js)
            for a, b in zip(o1 + s1["residual"], list(jo) + js["residual"]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("algo", ["dc_s3gd", "stale", "ssgd"])
@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_compressed_reducers_need_buckets(algo, name):
    params = {"w": torch.zeros(300, 400)}
    alg = treg.make(algo, TConfig(), n_workers=W, reducer=name, buckets=0)
    with pytest.raises(ValueError, match="buckets"):
        alg.init(params)
    # the reference raises the same way
    jalg = jreg.make(algo, JConfig(), n_workers=W, reducer=name, buckets=0)
    with pytest.raises(ValueError, match="buckets"):
        jalg.init({"w": jnp.zeros((300, 400))})


def test_use_kernels_flips_the_reducer_switch():
    for algo in ("dc_s3gd", "ssgd"):
        for kernels in (False, True):
            alg = treg.make(algo, TConfig(), n_workers=W, reducer="topk",
                            buckets=1, use_kernels=kernels)
            assert alg.reducer.use_kernels is kernels
    with pytest.raises(ValueError, match="overlap"):
        treg.make("ssgd", TConfig(), n_workers=W, overlap=True)


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.zeros((W, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        KC.select_ef_mean(x, torch.zeros(W, device="meta"),
                          comm_dtype=torch.float32, union=False)


@pytest.mark.gpu
def test_cuda_select_ef_mean_bitwise_the_plain_version():
    """On the card: the kernel against its plain version, bitwise, for
    each wire and union setting, at W = 2 and 3, at an aligned width, a
    ragged one and on a view at a 4-byte (not 16-byte) aligned address;
    one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for w in (2, 3):
        for n in (3 * JKC.BLOCK, 100_003, 100_004):
            buf = torch.randn(w * n + 1, generator=gen, device=dev) \
                * torch.rand(w * n + 1, generator=gen, device=dev) ** 4
            buf[::101] = 0.0
            for a in (buf[: w * n].view(w, n), buf[1:].view(w, n)):
                t = torch.quantile(a.abs()[:, :10_000], 0.9, dim=1)
                for dt in TDT.values():
                    for union in (False, True):
                        before = KC.select_ef_mean.launches
                        got = KC.select_ef_mean(a, t, comm_dtype=dt,
                                                union=union)
                        assert KC.select_ef_mean.launches == before + 1
                        want = KC.select_ef_mean_plain(a, t, comm_dtype=dt,
                                                       union=union)
                        for x, y in zip(got, want):
                            assert torch.equal(x, y), (w, n, dt, union)
    torch.cuda.synchronize()

"""Port parity for the int8/fp8 quantization seam (`repro_torch.core.quant`)
and the quantized and f16 wires of ``mean_allreduce``.

Inputs are made with numpy and go through both packages.  Tolerances:
``quantize`` / ``dequantize`` are bitwise the reference's for int8 and
fp8 (the same op order: amax, max(amax, 1e-30)/qmax, clip(x/scale),
round half to even for int8, cast with round to nearest even); the
quantized mean at W = 2 is bitwise too (a sum of two is order-free).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as JQ
from repro.core.reduce import MeanAllReduce as JMean
from repro_torch.core import quant as Q
from repro_torch.core.reduce import MeanAllReduce
from repro_torch.interop import params_from_numpy


def _rows(seed, shape=(3, 1000)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-8, 4, shape))
         ).astype(np.float32)
    x[1] = 0.0                      # an all-zero row stays exactly zero
    x[0, ::7] = 0.0
    return x


def _t(a):
    return params_from_numpy(a, device="cpu")


def _bits(q):
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 else q


@pytest.mark.parametrize("name", ["int8", "fp8", "i8", "float8_e4m3fn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dequantize_bitwise_the_reference(name, seed):
    x = _rows(seed)
    q, s = Q.quantize(_t(x), name)
    jq, js = JQ.quantize(jnp.asarray(x), name)
    assert q.dtype == Q.qinfo(name)[0] and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    ours = q.view(torch.uint8).numpy()
    np.testing.assert_array_equal(ours, _bits(jq))
    np.testing.assert_array_equal(Q.dequantize(q, s).numpy(),
                                  np.asarray(JQ.dequantize(jq, js)))
    assert not Q.dequantize(q, s)[1].any()


def test_quantize_axes_and_one_dimensional_rows():
    """``axes`` picks the amax axes; a 1-D leaf has no axes but 0, so each
    element is its own row, as in the reference."""
    x = _rows(2, (4, 6, 5))
    for axes in (None, (2,), (1, 2)):
        q, s = Q.quantize(_t(x), "int8", axes=axes)
        jq, js = JQ.quantize(jnp.asarray(x), "int8", axes=axes)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    v = x[0, 0]
    q, s = Q.quantize(_t(v), "fp8")
    jq, js = JQ.quantize(jnp.asarray(v), "fp8")
    assert s.shape == v.shape
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(), _bits(jq))


def test_names_and_itemsizes():
    for name in ("int8", "i8", "fp8", "float8_e4m3fn"):
        assert Q.is_quantized(name) and JQ.is_quantized(name)
        assert Q.canonical(name) == JQ.canonical(name)
        assert Q.wire_itemsize(name) == JQ.wire_itemsize(name) == 1
    for name in ("float32", "bfloat16", "float16"):
        assert not Q.is_quantized(name)
        assert Q.wire_itemsize(name) == JQ.wire_itemsize(name)
    assert Q.SCALE_BYTES == JQ.SCALE_BYTES == 4
    with pytest.raises(ValueError, match="comm_dtype"):
        Q.float_wire("int4")


@pytest.mark.parametrize("comm_dtype", ["int8", "fp8", "float16"])
def test_mean_allreduce_wires_match_the_reference(comm_dtype):
    """The quantized and f16 means over a (W, ...) tree, W = 2: bitwise."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((2, 33, 7)).astype(np.float32),
            "b": rng.standard_normal((2, 19)).astype(np.float32),
            "c": _rows(6, (2, 4000))}
    ours = MeanAllReduce(comm_dtype=comm_dtype)(_t(tree))
    theirs = JMean(comm_dtype=comm_dtype)(
        {k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        assert ours[k].shape == (1,) + tree[k].shape[1:]
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


@pytest.mark.parametrize("comm_dtype", ["float32", "bfloat16", "float16",
                                        "int8", "fp8"])
def test_mean_allreduce_accounting_matches_the_reference(comm_dtype):
    sizes = [32768, 65536, 1000]
    ours, theirs = MeanAllReduce(comm_dtype=comm_dtype), \
        JMean(comm_dtype=comm_dtype)
    assert ours.wire_bytes(sizes) == theirs.wire_bytes(sizes)
    assert ours.hparams == theirs.hparams

"""Port parity: the paged-attention decode kernel's plain version and its
wrapper (on CPU tensors) against the JAX Pallas kernel (interpret mode, as
``tests/test_serve.py`` runs it) and its oracle ``paged_attention_ref``,
on the same numpy inputs.

Tolerances are the reference's own: atol 1e-6 on f32 pools
(``tests/test_serve.py``) and 2e-5 on int8/fp8 pools with per-token scales
(``tests/test_quantized.py``).  The ``gpu`` test holds the CUDA kernel
against the plain version on the card and skips where there is none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.ref import paged_attention_ref
from repro.models.cache import _quantize_tokens as j_quantize_tokens
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import paged_attention_plain
from repro_torch.models.cache import _quantize_tokens


def _case(B, KV, G, hd, ps, mp, *, seed=0, lengths=None, extra_pages=1):
    """Random q and pools, a shuffled block table over distinct pages
    (page 0 stays the scratch page), ragged lengths."""
    rng = np.random.default_rng(seed)
    n_pages = B * mp + extra_pages
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, KV, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, KV, hd)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1)[:B * mp] + 1).reshape(B, mp)
    if lengths is None:
        lengths = [1 + (i * 7) % (mp * ps) for i in range(B)]
    return q, k, v, bt.astype(np.int32), np.asarray(lengths, np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


def _to_torch_pool(a) -> torch.Tensor:
    """A JAX-quantized pool as a torch tensor of the same storage dtype."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return _t(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return _t(a)


SHAPES = [  # tests/test_serve.py's three, a length-1 row, a partial page
    dict(B=1, KV=1, G=1, hd=16, ps=8, mp=2),
    dict(B=3, KV=2, G=4, hd=32, ps=8, mp=4),
    dict(B=2, KV=4, G=1, hd=64, ps=16, mp=3),
    dict(B=3, KV=2, G=2, hd=128, ps=16, mp=3, lengths=[1, 16, 33]),
    dict(B=2, KV=2, G=2, hd=32, ps=7, mp=5, lengths=[30, 12]),
]


@pytest.mark.parametrize("shape", SHAPES,
                         ids=[f"case{i}" for i in range(len(SHAPES))])
def test_plain_and_wrapper_match_jax_kernel_and_oracle(shape):
    q, k, v, bt, lengths = _case(**shape)
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, lengths)]
    j_kernel = np.asarray(j_paged(*jargs, interpret=True))
    j_ref = np.asarray(paged_attention_ref(*jargs))
    targs = [_t(a) for a in (q, k, v, bt, lengths)]
    plain = paged_attention_plain(*targs).numpy()
    wrapped = paged_attention(*targs).numpy()
    assert plain.dtype == np.float32 and plain.shape == q.shape
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain, j_ref, atol=1e-6)
    np.testing.assert_allclose(plain, j_kernel, atol=1e-6)


def test_dead_pages_do_not_change_the_result():
    """Pages past a row's length are masked: the same rows through a wide
    block table (a kernel that stops at the last live page relies on
    it) and through a table of just the live pages agree."""
    q, k, v, bt, lengths = _case(B=2, KV=2, G=2, hd=32, ps=8, mp=6,
                                 lengths=[9, 17])
    wide = paged_attention_plain(*[_t(a) for a in (q, k, v, bt, lengths)])
    narrow = paged_attention_plain(*[_t(a) for a in (q, k, v, bt[:, :3],
                                                     lengths)])
    np.testing.assert_allclose(wide.numpy(), narrow.numpy(), atol=1e-6)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pools_match_jax_kernel_and_oracle(kv_dtype):
    """Both sides consume the SAME quantized pools and scales (quantized
    by the reference), as ``tests/test_quantized.py`` sets it up."""
    q, k, v, bt, lengths = _case(B=3, KV=2, G=2, hd=8, ps=16, mp=2,
                                 seed=5, lengths=[1, 20, 32])
    k8, ks = j_quantize_tokens(jnp.asarray(k), kv_dtype, 2)
    v8, vs = j_quantize_tokens(jnp.asarray(v), kv_dtype, 2)
    jq = [jnp.asarray(a) for a in (q, bt, lengths)]
    j_kernel = np.asarray(j_paged(jq[0], k8, v8, jq[1], jq[2], k_scale=ks,
                                  v_scale=vs, interpret=True))
    j_ref = np.asarray(paged_attention_ref(jq[0], k8, v8, jq[1], jq[2],
                                           k_scale=ks, v_scale=vs))
    tk8, tv8 = _to_torch_pool(k8), _to_torch_pool(v8)
    tks, tvs = _t(np.asarray(ks)), _t(np.asarray(vs))
    plain = paged_attention_plain(_t(q), tk8, tv8, _t(bt), _t(lengths),
                                  tks, tvs).numpy()
    wrapped = paged_attention(_t(q), tk8, tv8, _t(bt), _t(lengths),
                              k_scale=tks, v_scale=tvs).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain, j_ref, atol=2e-5)
    np.testing.assert_allclose(plain, j_kernel, atol=2e-5)
    # the error the quantized pools cost against f32 pools stays small
    dense = paged_attention_plain(*[_t(a) for a in (q, k, v, bt, lengths)])
    assert float((torch.from_numpy(plain) - dense).abs().max()) < 0.1


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("lead", [1, 3])
def test_quantize_tokens_is_bitwise_the_reference(kv_dtype, lead):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 3, 4, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0     # an all-zero token row stays exactly zero
    jq, js = j_quantize_tokens(jnp.asarray(x), kv_dtype, lead)
    tq, ts = _quantize_tokens(_t(x), kv_dtype, lead)
    assert ts.shape == x.shape[:lead] and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.view(torch.uint8 if kv_dtype == "fp8"
                                          else torch.int8).numpy(),
                                  np.asarray(jq).view(np.uint8
                                                      if kv_dtype == "fp8"
                                                      else np.int8))


def test_wrapper_checks_its_arguments():
    q, k, v, bt, lengths = (_t(a) for a in _case(B=1, KV=1, G=1, hd=16,
                                                 ps=8, mp=2))
    scale = torch.ones(k.shape[:2])
    with pytest.raises(ValueError, match="both"):
        paged_attention(q, k, v, bt, lengths, k_scale=scale)
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                        bt.to("meta"), lengths.to("meta"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Every pool dtype at the test shapes and the serving shape (16 rows,
    8 kv heads, G 2, hd 128, pages of 16, ragged lengths 1..577)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    lens = [1 + (i * 576) // 15 for i in range(16)]
    cases = [dict(s) for s in SHAPES] + [dict(
        B=16, KV=8, G=2, hd=128, ps=16, mp=37, lengths=lens)]
    for shape in cases:
        q, k, v, bt, lengths = (_t(a).to(dev) for a in _case(**shape))
        for dt in (torch.float32, torch.bfloat16, torch.float16, "int8",
                   "fp8"):
            if isinstance(dt, str):
                kq, ks = _quantize_tokens(k, dt, 2)
                vq, vs = _quantize_tokens(v, dt, 2)
                args = (q, kq, vq, bt, lengths)
                kw = dict(k_scale=ks, v_scale=vs)
                atol = 2e-5
            else:
                args = (q, k.to(dt), v.to(dt), bt, lengths)
                kw = {}
                atol = 1e-6
            before = paged_attention.launches
            got = paged_attention(*args, **kw)
            want = paged_attention_plain(*args, *kw.values())
            torch.cuda.synchronize()
            assert paged_attention.launches == before + 1
            err = float((got - want).abs().max())
            assert err <= atol, (shape, dt, err)

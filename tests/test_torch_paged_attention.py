"""Port parity: the paged-attention decode kernel's plain version and its
wrapper (on CPU tensors) against the JAX Pallas kernel (interpret mode, as
``tests/test_serve.py`` runs it) and its oracle ``paged_attention_ref``,
on the same numpy inputs.

Tolerances are the reference's own: atol 1e-6 on f32 pools
(``tests/test_serve.py``) and 2e-5 on int8/fp8 pools with per-token scales
(``tests/test_quantized.py``).  A plain-torch model of the CUDA kernel's
algorithm (split-K over each row's live tokens, 32-token tiles folded by
an online softmax, then the merge of the splits) is held against the JAX
oracle at several split counts.  The ``gpu`` test holds the CUDA kernel
against the plain version on the card and skips where there is none.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.ref import paged_attention_ref
from repro.models.cache import _quantize_tokens as j_quantize_tokens
from repro_torch.kernels.paged_attention import paged_attention, splits_for
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


def _split_merge(q, k_pool, v_pool, bt, lengths, splits, k_scale=None,
                 v_scale=None, tile=32):
    """The kernel's algorithm in plain torch: split s of row b folds the
    live tokens [s * per, min((s + 1) * per, n)), per = ceil(n / splits)
    rounded up to the tile, ``tile`` tokens at a time into an online
    softmax (m, l, acc); an empty split keeps (-1e30, 0, 0); then
    out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)."""
    B, KV, G, hd = q.shape
    ps = k_pool.shape[1]
    k_rows = k_pool.reshape(-1, KV, hd).float()
    v_rows = v_pool.reshape(-1, KV, hd).float()
    out = torch.empty((B, KV, G, hd))
    for b in range(B):
        n = int(lengths[b])
        per = math.ceil(math.ceil(n / splits) / tile) * tile
        ms, ls, accs = [], [], []
        for s in range(splits):
            lo = min(n, s * per)
            hi = min(n, lo + per)
            m = torch.full((KV, G), -1e30)
            l = torch.zeros((KV, G))
            acc = torch.zeros((KV, G, hd))
            for t0 in range(lo, hi, tile):
                pos = torch.arange(t0, min(t0 + tile, hi))
                slots = bt[b, pos // ps].long() * ps + pos % ps
                k, v = k_rows[slots], v_rows[slots]
                if k_scale is not None:
                    k = k * k_scale.reshape(-1)[slots][:, None, None]
                    v = v * v_scale.reshape(-1)[slots][:, None, None]
                sc = torch.einsum("kgh,tkh->kgt", q[b].float(), k) \
                    * hd ** -0.5
                m_new = torch.maximum(m, sc.max(dim=-1).values)
                p = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] \
                    + torch.einsum("kgt,tkh->kgh", p, v)
                m = m_new
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        m_s, l_s, acc_s = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        w = torch.exp(m_s - m_s.max(dim=0).values)
        out[b] = (w[..., None] * acc_s).sum(dim=0) \
            / torch.clamp((w * l_s).sum(dim=0), min=1e-30)[..., None]
    return out


# lengths 1 (every later split empty), on a page boundary (16, 32), a
# partial last page (9, 21) and a row that fills its block table (4 x 8)
SPLIT_CASES = [
    dict(B=4, KV=2, G=2, hd=32, ps=8, mp=4, lengths=[1, 16, 21, 32]),
    dict(B=3, KV=1, G=4, hd=16, ps=7, mp=3, lengths=[1, 9, 21]),
]


@pytest.mark.parametrize("pool", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("splits", [1, 2, 5, 16])
def test_split_and_merge_matches_jax_oracle(splits, pool):
    """The CUDA kernel's split-K + merge, modelled in plain torch, against
    the JAX oracle: 1e-6 on f32 pools, 2e-5 on int8/fp8 pools (the same
    quantized pools and scales on both sides)."""
    for shape in SPLIT_CASES:
        q, k, v, bt, lengths = _case(**shape, seed=splits)
        if pool == "float32":
            jk, jv, jks, jvs = (jnp.asarray(k), jnp.asarray(v), None, None)
            tk, tv, tks, tvs = _t(k), _t(v), None, None
            atol = 1e-6
        else:
            jk, jks = j_quantize_tokens(jnp.asarray(k), pool, 2)
            jv, jvs = j_quantize_tokens(jnp.asarray(v), pool, 2)
            tk, tv = _to_torch_pool(jk), _to_torch_pool(jv)
            tks, tvs = _t(np.asarray(jks)), _t(np.asarray(jvs))
            atol = 2e-5
        want = np.asarray(paged_attention_ref(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
            k_scale=jks, v_scale=jvs))
        got = _split_merge(_t(q), tk, tv, _t(bt), _t(lengths), splits,
                           tks, tvs).numpy()
        np.testing.assert_allclose(got, want, atol=atol)


def test_split_count_follows_the_shape_not_the_table():
    """The split count is a function of rows, kv heads and SMs alone (the
    block table's width is not an argument): 16 at the serving shape on
    132 SMs, within [1, 64] everywhere."""
    assert splits_for(16, 8, 132) == 16
    assert splits_for(1, 1, 132) == 64
    assert splits_for(4096, 8, 132) == 1
    assert all(1 <= splits_for(b, kv, 132) <= 64
               for b in (1, 3, 16, 64) for kv in (1, 2, 8))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Every pool dtype at the test shapes, the edge shapes (all lengths
    1; a row that fills its table) and the serving shape (16 rows, 8 kv
    heads, G 2, hd 128, pages of 16, ragged lengths 1..577); each launch
    bitwise equal to a second one and, at the serving shape, to a launch
    through a table cut to the live pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    lens = [1 + (i * 576) // 15 for i in range(16)]
    cases = [dict(s) for s in SHAPES + SPLIT_CASES] + [
        dict(B=5, KV=2, G=2, hd=128, ps=16, mp=3, lengths=[1] * 5),
        dict(B=16, KV=8, G=2, hd=128, ps=16, mp=640, lengths=lens)]
    for shape in cases:
        q, k, v, bt, lengths = (_t(a).to(dev) for a in _case(**shape))
        live = -(-int(lengths.max()) // shape["ps"])
        narrow = bt[:, :live].contiguous()
        for dt in (torch.float32, torch.bfloat16, torch.float16, "int8",
                   "fp8"):
            if isinstance(dt, str):
                kq, ks = _quantize_tokens(k, dt, 2)
                vq, vs = _quantize_tokens(v, dt, 2)
                pools = (q, kq, vq)
                kw = dict(k_scale=ks, v_scale=vs)
                atol = 2e-5
            else:
                pools = (q, k.to(dt), v.to(dt))
                kw = {}
                atol = 1e-6
            before = paged_attention.launches
            got = paged_attention(*pools, bt, lengths, **kw)
            again = paged_attention(*pools, bt, lengths, **kw)
            cut = paged_attention(*pools, narrow, lengths, **kw)
            want = paged_attention_plain(*pools, bt, lengths, *kw.values())
            torch.cuda.synchronize()
            assert paged_attention.launches == before + 3
            err = float((got - want).abs().max())
            assert err <= atol, (shape, dt, err)
            assert torch.equal(got, again), (shape, dt)
            assert torch.equal(got, cut), (shape, dt)

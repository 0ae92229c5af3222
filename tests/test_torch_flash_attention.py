"""Port parity: the flash-attention prefill kernel's plain version and its
wrapper (on CPU tensors) against the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and its oracle ``_blocked_attention``,
on the same numpy inputs; and the reduced qwen3-0.6b prefill, whose
attention core is the kernel's route, against the JAX ``Model.prefill``.

Tolerances are the reference's own (``tests/test_kernels.py``): atol 2e-5
in f32 and 3e-2 in bf16 (the plain version, like ``_blocked_attention``,
rounds p to bf16 before the PV product; the Pallas kernel keeps it in
f32), and 1e-4 on prefill logits and caches (``tests/test_serve.py``'s
bound between routes).  The ``gpu`` test holds the CUDA kernel against
the plain version on the card and skips where there is none.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models.attention import _blocked_attention
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.models import attention as attn
from repro_torch.models.transformer import Model
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [  # (B, Sq, Sk, KV, G, hd, causal, window): the reference's four
    (2, 128, 128, 2, 2, 64, True, 0),
    (1, 96, 96, 1, 4, 64, True, 32),
    (2, 64, 64, 4, 1, 128, False, 0),
    (1, 200, 200, 2, 1, 64, True, 0),       # non-multiple of block
]
RAGGED = [  # Sq != Sk, lengths off every block size, each mask
    (1, 77, 150, 2, 2, 64, False, 0),
    (1, 150, 77, 2, 2, 64, True, 0),
    (1, 90, 130, 1, 2, 32, True, 40),
]
DTYPES = {"float32": (np.float32, torch.float32, 2e-5),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(shape, dtype, seed=7):
    """q, k, v as numpy arrays of ``dtype`` (bf16 rounded once, so both
    packages see the same values)."""
    B, Sq, Sk, KV, G, hd = shape[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in ((B, Sq, KV, G, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _t(a, dtype):
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + RAGGED,
                         ids=[f"case{i}" for i in range(len(SHAPES)
                                                        + len(RAGGED))])
def test_plain_and_wrapper_match_jax_kernel_and_oracle(shape, dtype):
    B, Sq, Sk, KV, G, hd, causal, window = shape
    np_dt, t_dt, atol = DTYPES[dtype]
    q, k, v = _inputs(shape, np_dt)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_kernel = j_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    j_ref = _blocked_attention(jq, jk, jv, jnp.arange(Sq), jnp.arange(Sk),
                               causal=causal, window=window, q_chunk=64,
                               kv_chunk=64)
    tq, tk, tv = (_t(a, t_dt) for a in (q, k, v))
    plain = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert plain.dtype == t_dt and plain.shape == tq.shape
    assert torch.equal(wrapped, plain)
    got = plain.float().numpy()
    np.testing.assert_allclose(got, np.asarray(j_ref, np.float32), atol=atol)
    np.testing.assert_allclose(got, np.asarray(j_kernel, np.float32),
                               atol=atol)


def test_plain_version_is_the_plain_route_in_f32():
    """At f32 (the prefill's dtype) the kernel's plain version and the
    training path's `causal_attention` are the same function."""
    q, k, v = (_t(a, torch.float32)
               for a in _inputs((2, 40, 40, 2, 2, 32), np.float32))
    torch.testing.assert_close(flash_attention_plain(q, k, v, causal=True),
                               attn.causal_attention(q, k, v), atol=2e-6,
                               rtol=0)


@pytest.fixture(scope="module")
def qwen3():
    jm = JModel(reduced(get_config("qwen3-0.6b")), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 24)).astype(np.int32)
    return jm, jp, tp, prompts


def test_qwen3_prefill_through_the_kernel_route_tracks_jax(qwen3,
                                                           monkeypatch):
    """The prefill's attention goes through the kernel's wrapper once per
    layer (its plain version here) and tracks the JAX prefill's logits
    and k/v cache; the loss keeps the plain route."""
    jm, jp, tp, prompts = qwen3
    tm = Model(t_reduced(t_get_config("qwen3-0.6b")))
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(attn, "flash_attention", counted)
    j_logits, j_cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                                   cache_len=32)
    t_logits, t_cache = tm.prefill(
        tp, {"tokens": torch.as_tensor(prompts).long()}, cache_len=32)
    assert len(calls) == tm.cfg.n_layers
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(t_cache[0]["b0"][name].numpy(),
                                   np.asarray(j_cache[0]["b0"][name]),
                                   atol=1e-4)
    labels = torch.as_tensor(prompts).long().roll(-1, 1)
    tm.loss(tp, {"tokens": torch.as_tensor(prompts).long(),
                 "labels": labels})
    assert len(calls) == tm.cfg.n_layers, "the loss took the kernel route"
    # kernels=False: the plain route, the same function
    plain_logits, _ = Model(tm.cfg, kernels=False).prefill(
        tp, {"tokens": torch.as_tensor(prompts).long()}, cache_len=32)
    assert len(calls) == tm.cfg.n_layers
    np.testing.assert_allclose(plain_logits.numpy(), t_logits.numpy(),
                               atol=1e-4)


def test_wrapper_checks_its_arguments():
    q, k, v = (_t(a, torch.float32)
               for a in _inputs((1, 8, 8, 1, 2, 32), np.float32))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="'plain' or 'flash'"):
        attn.attention_train({}, torch.zeros(1, 1, 4), torch.zeros(1),
                             rope_theta=0.0, core="sdpa")


# --------------------------------------------------------------------------
# a plain-torch model of the CUDA kernel's design (csrc/flash_attention.cu)
# --------------------------------------------------------------------------

ROWS = 64           # packed query rows per CTA (kBM)
QWEN3 = (1, 512, 512, 8, 2, 128, True, 0)   # the qwen3-0.6b prefill


def _warpgroups(f32: bool, hd: int) -> int:
    """Warpgroups splitting a CTA's key tiles (the kernel's warpgroups<T,
    HD>)."""
    return 2 if f32 or hd == 256 else 3


def _key_tile(f32: bool, hd: int) -> int:
    """Keys per tile (the kernel's key_tile<T, HD>)."""
    if f32:
        return 64 if hd <= 64 else 32 if hd == 128 else 16
    return 64 if hd <= 128 else 32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero: what
    cvt.rna.tf32.f32 gives for finite x (and the kernel's integer form)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of x: what the tensor core reads of a non-TF32
    operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _product(a, b, products: str):
    """a @ b in f32 as the tensor cores run it: ``3xtf32`` (hi = tf32(x),
    lo = x - hi read as TF32; lo.hi + hi.lo + hi.hi, smallest first),
    ``tf32`` (hi.hi alone, the negative control) or ``exact`` (bf16
    inputs, whose products f32 holds exactly)."""
    if products == "exact":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if products == "tf32":
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def flash_design_model(q, k, v, *, causal=True, window=0, products=None):
    """The kernel's algorithm in plain torch: q's G heads of one kv head
    packed into rows R = position * G + head, 64 rows per CTA; the key
    tiles any of its rows can see (wholly masked ones skipped), tile i
    going to warpgroup i % W; per tile, scores in the log2 domain, masks by
    each row's position R // G, the online softmax with exp2, p rounded to
    v's dtype for the PV product; the warpgroups' (m, l, acc) merged into
    warpgroup 0's in order at the end; out = acc / max(l, 1e-30) in q's
    dtype.  Products as
    `_product` (default: 3xtf32 for f32 inputs, exact for bf16)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    f32 = q.dtype == torch.float32
    products = products or ("3xtf32" if f32 else "exact")
    BN = _key_tile(f32, hd)
    W = _warpgroups(f32, hd)
    sl = torch.tensor(hd ** -0.5, dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    rows = Sq * G
    qr = q.float().permute(0, 2, 1, 3, 4).reshape(B, KV, rows, hd)
    kr = k.float().permute(0, 2, 1, 3)              # (B, KV, Sk, hd)
    vr = v.float().permute(0, 2, 1, 3)
    out = torch.zeros((B, KV, rows, hd), dtype=torch.float32)
    for m0 in range(0, rows, ROWS):
        qt = qr[:, :, m0:m0 + ROWS]
        pos = torch.arange(m0, min(m0 + ROWS, rows)) // G
        p_first, p_last = int(pos[0]), int(pos[-1])
        k_end = min(Sk, p_last + 1) if causal else Sk
        k_begin = max(0, p_first - window + 1) if window > 0 else 0
        state = []
        for wg in range(W):
            m = torch.full(qt.shape[:3], NEG, dtype=torch.float32)
            l = torch.zeros(qt.shape[:3], dtype=torch.float32)
            acc = torch.zeros(qt.shape, dtype=torch.float32)
            for k0 in range((k_begin // BN + wg) * BN, k_end, W * BN):
                kt, vt = kr[:, :, k0:k0 + BN], vr[:, :, k0:k0 + BN]
                kpos = torch.arange(k0, k0 + kt.shape[2])
                x = _product(qt, kt.transpose(-1, -2), products) * sl
                live = torch.ones((len(pos), len(kpos)), dtype=torch.bool)
                if causal:
                    live &= kpos[None] <= pos[:, None]
                if window > 0:
                    live &= (pos[:, None] - kpos[None]) < window
                x = torch.where(live, x, torch.full_like(x, NEG))
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + _product(
                    p.to(v.dtype).float(), vt, products)
                m = m_new
            state.append((m, l, acc))
        m, l, acc = state[0]
        for m1, l1, a1 in state[1:]:
            mm = torch.maximum(m, m1)
            c0, c1 = torch.exp2(m - mm), torch.exp2(m1 - mm)
            m, l = mm, l * c0 + l1 * c1
            acc = acc * c0[..., None] + a1 * c1[..., None]
        out[:, :, m0:m0 + ROWS] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4).to(q.dtype)


NEG = -1e30


def _jax_results(shape, q, k, v):
    """(Pallas kernel in interpret mode, _blocked_attention) on the numpy
    inputs; blocks of 64, or 512 at the qwen3 shape (one block)."""
    B, Sq, Sk, KV, G, hd, causal, window = shape
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    block = 512 if Sq >= 512 else 64
    j_kernel = j_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=block, block_k=block, interpret=True)
    j_ref = _blocked_attention(jq, jk, jv, jnp.arange(Sq), jnp.arange(Sk),
                               causal=causal, window=window, q_chunk=64,
                               kv_chunk=64)
    return np.asarray(j_kernel, np.float32), np.asarray(j_ref, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + RAGGED + [QWEN3],
                         ids=[f"case{i}" for i in range(len(SHAPES)
                                                        + len(RAGGED))]
                         + ["qwen3"])
def test_design_model_matches_jax_kernel_and_oracle(shape, dtype):
    """The kernel's design (packed GQA rows, its key tiles over two or
    three warpgroups, the exp2 online softmax, 3xTF32 products in f32) within
    the reference's tolerances of the Pallas kernel and its oracle, at
    the reduced shapes and the qwen3-0.6b prefill's."""
    np_dt, t_dt, atol = DTYPES[dtype]
    q, k, v = _inputs(shape, np_dt)
    j_kernel, j_ref = _jax_results(shape, q, k, v)
    causal, window = shape[6:]
    got = flash_design_model(*(_t(a, t_dt) for a in (q, k, v)),
                             causal=causal, window=window)
    assert got.dtype == t_dt and got.shape == q.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, j_ref, atol=atol)
    np.testing.assert_allclose(got, j_kernel, atol=atol)


def test_single_tf32_misses_the_f32_tolerance():
    """The negative control: at the qwen3-0.6b prefill's shape one TF32
    product per f32 one (hi.hi alone) is further than 2e-5 from the
    oracle, where 3xTF32 is inside it; why the kernel splits."""
    q, k, v = _inputs(QWEN3, np.float32)
    _, j_ref = _jax_results(QWEN3, q, k, v)
    tq, tk, tv = (_t(a, torch.float32) for a in (q, k, v))
    errs = {p: float(np.abs(flash_design_model(tq, tk, tv, products=p)
                            .numpy() - j_ref).max())
            for p in ("tf32", "3xtf32")}
    assert errs["3xtf32"] <= 2e-5 < errs["tf32"], errs


def test_design_model_packs_more_heads_than_rows():
    """G 80 > 64 rows: one position's heads spread over two CTAs' rows
    (and f32 hd 256's 16-key tiles), against the plain version."""
    for shape in ((1, 20, 20, 1, 80, 32, True, 0),
                  (1, 70, 90, 2, 2, 256, True, 24)):
        q, k, v = (_t(a, torch.float32)
                   for a in _inputs(shape, np.float32))
        causal, window = shape[6:]
        torch.testing.assert_close(
            flash_design_model(q, k, v, causal=causal, window=window),
            flash_attention_plain(q, k, v, causal=causal, window=window),
            atol=2e-5, rtol=0)


# the gpu test's sweep: every instantiation (hd) against G 1/2/4/8, B 2,
# the three masks in turn (Sq != Sk in the non-causal one), and G 80 (one
# position spread over two CTAs' packed rows)
SWEEP = [(2, 97, 97 if i % 3 < 2 else 130, 2, G, hd, i % 3 < 2,
          40 if i % 3 == 1 else 0)
         for i, (hd, G) in enumerate((hd, G) for hd in (32, 64, 128, 256)
                                     for G in (1, 2, 4, 8))] \
    + [(1, 20, 20, 1, 80, 32, True, 0)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Every test shape, the sweep over hd and G, and the qwen3-0.6b
    prefill's (8 kv heads, G 2, hd 128, S 512), f32 and bf16, within the
    reference's tolerances, and bitwise equal from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    for shape in SHAPES + RAGGED + SWEEP + [(1, 512, 512, 8, 2, 128, True,
                                             0)]:
        causal, window = shape[6:]
        for np_dt, t_dt, atol in DTYPES.values():
            q, k, v = (_t(a, t_dt).to(dev) for a in _inputs(shape, np_dt))
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal, window=window)
            again = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 2
            assert got.dtype == t_dt and got.shape == q.shape
            assert torch.equal(got, again), (shape, t_dt)
            err = float((got.float() - want.float()).abs().max())
            assert err <= atol, (shape, t_dt, err)

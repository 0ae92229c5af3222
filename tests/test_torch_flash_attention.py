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


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Every test shape and the qwen3-0.6b prefill's (8 kv heads, G 2,
    hd 128, S 512), f32 and bf16, within the reference's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    for shape in SHAPES + RAGGED + [(1, 512, 512, 8, 2, 128, True, 0)]:
        causal, window = shape[6:]
        for np_dt, t_dt, atol in DTYPES.values():
            q, k, v = (_t(a, t_dt).to(dev) for a in _inputs(shape, np_dt))
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 1
            assert got.dtype == t_dt
            err = float((got.float() - want.float()).abs().max())
            assert err <= atol, (shape, t_dt, err)

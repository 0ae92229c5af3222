"""Port parity for serving: prefill and one-token decode of the reduced
qwen3-0.6b (f32 compute) over the dense and the paged cache layouts,
against the JAX package on the same weights (carried over from
``repro``'s ``Model.init`` as numpy) and prompts.

Tolerances: logits within 1e-4 of the reference's (the reference's own
bound between its kernel and gather routes, ``tests/test_serve.py``),
greedy tokens equal.  Within the port the paged gather decode is BITWISE
the dense decode at matched linearized cache length, as the reference
pins for itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import cache as jcache
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.ref import paged_attention_plain
from repro_torch.models import attention
from repro_torch.models import cache as cache_mod
from repro_torch.models.cache import DenseLayout, PagedLayout
from repro_torch.models.transformer import Model
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
B, P, GEN, PS = 2, 8, 16, 8
MP = -(-(P + GEN + 1) // PS)           # block-table width
CACHE_LEN = MP * PS                    # the matched linearized length


@pytest.fixture(scope="module")
def models():
    jm = JModel(reduced(get_config("qwen3-0.6b")), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_config("qwen3-0.6b")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    return jm, jp, tm, tp, prompts


def _pages():
    return np.arange(1, B * MP + 1, dtype=np.int32).reshape(B, MP)


def _torch_dense_trace(tm, tp, prompts):
    """(logits per step, greedy tokens per step) of the dense layout."""
    lay = DenseLayout(tm)
    logits, cache = lay.prefill(tp, {"tokens": torch.as_tensor(prompts)
                                     .long()}, cache_len=CACHE_LEN)
    trace, toks = [logits], [logits.argmax(-1)]
    pos = torch.tensor(P)
    for _ in range(GEN):
        logits, cache = lay.decode_step(
            tp, cache, {"tokens": toks[-1][:, None], "pos": pos})
        trace.append(logits)
        toks.append(logits.argmax(-1))
        pos = pos + 1
    return trace, toks


def _torch_paged_trace(tm, tp, prompts, **layout_kw):
    lay = PagedLayout(tm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                      max_pages=MP, **layout_kw)
    cache = lay.init_cache(device="cpu")
    pages = torch.from_numpy(_pages())
    logits, cache = lay.prefill_into(
        tp, cache, {"tokens": torch.as_tensor(prompts).long()},
        pages[:, :lay.pages_for(P)])
    trace, toks = [logits], [logits.argmax(-1)]
    pos = torch.full((B,), P)
    for _ in range(GEN):
        logits, cache = lay.decode_step(tp, cache, toks[-1][:, None], pos,
                                        pages)
        trace.append(logits)
        toks.append(logits.argmax(-1))
        pos = pos + 1
    return trace, toks


def _jax_dense_trace(jm, jp, prompts):
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=CACHE_LEN))
    step = jax.jit(lambda p, c, b: jm.decode_step(p, c, b))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompts)})
    trace = [np.asarray(logits)]
    for t in range(GEN):
        tok = jnp.argmax(logits, -1)
        logits, cache = step(jp, cache, {"tokens": tok[:, None],
                                         "pos": jnp.int32(P + t)})
        trace.append(np.asarray(logits))
    return trace


def _jax_paged_trace(jm, jp, prompts, **layout_kw):
    """(logits per step, the pools after the prefill and each step)."""
    lay = JPagedLayout(jm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                       max_pages=MP, **layout_kw)
    cache = lay.init_cache()
    pages = jnp.asarray(_pages())
    logits, cache = jax.jit(lambda p, c, t, pg, s: lay.prefill_into(
        p, c, {"tokens": t}, pg, s))(
        jp, cache, jnp.asarray(prompts), pages[:, :lay.pages_for(P)],
        jnp.arange(B, dtype=jnp.int32))
    step = jax.jit(lay.decode_step)
    trace, pools = [np.asarray(logits)], [cache[0]["b0"]]
    pos = np.full((B,), P, np.int32)
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1)
        logits, cache = step(jp, cache, tok[:, None], jnp.asarray(pos),
                             pages)
        trace.append(np.asarray(logits))
        pools.append(cache[0]["b0"])
        pos += 1
    return trace, pools


def _assert_tracks(trace, toks, ref_trace, what):
    assert len(trace) == len(ref_trace) == GEN + 1
    for t, (a, tok, r) in enumerate(zip(trace, toks, ref_trace)):
        np.testing.assert_allclose(a.numpy(), r, atol=ATOL,
                                   err_msg=f"{what}: step {t}")
        np.testing.assert_array_equal(tok.numpy(), r.argmax(-1),
                                      err_msg=f"{what}: tokens, step {t}")


def test_prefill_and_dense_decode_track_jax(models):
    jm, jp, tm, tp, prompts = models
    trace, toks = _torch_dense_trace(tm, tp, prompts)
    assert trace[0].shape == (B, tm.vocab_padded)
    assert bool((trace[0][:, tm.cfg.vocab_size:] == -1e30).all())
    _assert_tracks(trace, toks, _jax_dense_trace(jm, jp, prompts), "dense")


def test_paged_decode_bitwise_matches_dense(models):
    """>= 16 greedy steps: the paged gather decode's logits are BITWISE
    the dense layout's at matched batch width and linearized length."""
    _, _, tm, tp, prompts = models
    dense, dense_toks = _torch_dense_trace(tm, tp, prompts)
    paged, paged_toks = _torch_paged_trace(tm, tp, prompts)
    for t, (a, b) in enumerate(zip(paged, dense)):
        assert torch.equal(a, b), f"step {t}"
    for a, b in zip(paged_toks, dense_toks):
        assert torch.equal(a, b)


def test_kernel_route_tracks_gather_route(models):
    _, _, tm, tp, prompts = models
    gather, _ = _torch_paged_trace(tm, tp, prompts)
    kernel, _ = _torch_paged_trace(tm, tp, prompts, use_kernel=True)
    for t, (a, b) in enumerate(zip(gather, kernel)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("use_kernel,launches", [(None, 0), (False, 0),
                                                 (True, GEN)])
def test_paged_route_follows_the_device(models, monkeypatch, use_kernel,
                                        launches):
    """By default the paged decode gathers on the CPU (the kernel route
    is taken on a CUDA device); True or False forces a route."""
    _, _, tm, tp, prompts = models
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return paged_attention_plain(*args[:5], kw["k_scale"],
                                     kw["v_scale"])

    monkeypatch.setattr(cache_mod, "paged_attention", counted)
    _torch_paged_trace(tm, tp, prompts, use_kernel=use_kernel)
    assert len(calls) == launches * tm.cfg.n_layers


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_decode_tracks_jax_paged(models, use_kernel):
    jm, jp, tm, tp, prompts = models
    trace, toks = _torch_paged_trace(tm, tp, prompts, use_kernel=use_kernel)
    ref, _ = _jax_paged_trace(jm, jp, prompts, use_kernel=use_kernel)
    _assert_tracks(trace, toks, ref, f"paged kernel={use_kernel}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_paged_decode_tracks_jax_paged(models, use_kernel,
                                            monkeypatch):
    """int8 pages are discontinuous in their input: the two packages' k/v,
    ~1e-7 apart, flip a whole int8 code now and then (one v code of the
    prefill here), which moves logits by ~4e-4.  So each package's writes
    are held to the other's (codes within one step, flips rare, scales to
    rtol 1e-5), and the decode math is held to 1e-4 with the reference's
    codes fed in: its prefill pools are copied over, and every decode
    write of the port takes the reference's codes for that slot."""
    jm, jp, tm, tp, prompts = models
    ref, ref_pools = _jax_paged_trace(jm, jp, prompts, use_kernel=use_kernel,
                                      kv_dtype="int8")
    lay = PagedLayout(tm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                      max_pages=MP, use_kernel=use_kernel, kv_dtype="int8")
    cache = lay.init_cache(device="cpu")
    pages = torch.from_numpy(_pages())
    logits, cache = lay.prefill_into(
        tp, cache, {"tokens": torch.as_tensor(prompts).long()},
        pages[:, :lay.pages_for(P)])
    pools = cache[0]["b0"]
    flips, n_codes = 0, 0
    for name, t in pools.items():
        want = torch.from_numpy(np.array(ref_pools[0][name]))
        if name.endswith("scale"):
            torch.testing.assert_close(t, want, rtol=1e-5, atol=0)
        else:
            diff = (t.int() - want.int()).abs()
            assert int(diff.max()) <= 1, name
            flips += int((diff > 0).sum())
            n_codes += diff.numel()
        t.copy_(want)
    trace, toks = [logits], [logits.argmax(-1)]
    own = cache_mod._quantize_tokens
    pos = torch.full((B,), P)
    for step in range(GEN):
        phys = pages[torch.arange(B), pos // PS]
        writes = iter([(layer, name) for layer in range(tm.cfg.n_layers)
                       for name in ("k", "v")])

        def reference_codes(x, kv_dtype, lead, _step=step, _phys=phys,
                            _off=pos % PS):
            nonlocal flips, n_codes
            qv, sc = own(x, kv_dtype, lead)
            layer, name = next(writes)
            pool = ref_pools[_step + 1][name]
            want = torch.from_numpy(np.array(pool[layer]))[_phys, _off]
            want_sc = torch.from_numpy(np.array(
                ref_pools[_step + 1][f"{name}_scale"][layer]))[_phys, _off]
            torch.testing.assert_close(sc, want_sc, rtol=1e-5, atol=0)
            diff = (qv.int() - want.int()).abs()
            assert int(diff.max()) <= 1, (_step, layer, name)
            flips += int((diff > 0).sum())
            n_codes += diff.numel()
            return want, want_sc

        monkeypatch.setattr(cache_mod, "_quantize_tokens", reference_codes)
        logits, cache = lay.decode_step(tp, cache, toks[-1][:, None], pos,
                                        pages)
        trace.append(logits)
        toks.append(logits.argmax(-1))
        pos = pos + 1
    _assert_tracks(trace, toks, ref, f"int8 paged kernel={use_kernel}")
    assert flips <= 1e-3 * n_codes, (flips, n_codes)


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16", "float32", "int8",
                                      "fp8"])
def test_kv_bytes_per_token_matches_reference(kv_dtype):
    """Capacity facts of the published qwen3-0.6b (bf16 compute)."""
    kw = dict(n_slots=16, num_pages=641, page_size=16, max_pages=640,
              kv_dtype=kv_dtype)
    ref = JPagedLayout(JModel(get_config("qwen3-0.6b")), **kw)
    lay = PagedLayout(Model(t_get_config("qwen3-0.6b")), **kw)
    assert lay.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert lay.page_bytes() == ref.page_bytes()
    assert lay.kv_dtype_name == ref.kv_dtype_name
    assert (lay.max_len, lay.pages_for(577)) == (ref.max_len,
                                                 ref.pages_for(577))
    if kv_dtype is None:
        assert lay.kv_bytes_per_token() == 28 * 2 * 8 * 128 * 2   # 114,688


def test_paged_pools_have_the_reference_tree(models):
    jm, _, tm, _, _ = models
    kw = dict(n_slots=B, num_pages=5, page_size=PS, max_pages=2,
              kv_dtype="int8")
    ref = JPagedLayout(jm, **kw).init_cache()
    got = PagedLayout(tm, **kw).init_cache(device="cpu")
    assert len(got) == len(ref) == 1
    assert sorted(got[0]["b0"]) == sorted(ref[0]["b0"])
    for name, a in ref[0]["b0"].items():
        t = got[0]["b0"][name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), name
    assert PagedLayout(tm, **kw).chunkable == \
        JPagedLayout(jm, **kw).chunkable is True


def test_unported_attention_kinds_raise(models):
    """Every attention kind is ported now: cross-attention (whisper) reads
    a static cache and writes nothing; the windowed ring (a window of 2
    over a 4-wide cache) decodes."""
    _, _, tm, tp, _ = models
    p = T.map(lambda a: a[0], tp["stage0"]["b0"]["attn"])
    x = torch.zeros((1, 1, tm.cfg.d_model))
    cache = attention.init_kv_cache(1, 4, tm.cfg.eff_n_kv_heads,
                                    tm.cfg.resolved_head_dim, torch.float32,
                                    "cpu")
    y, cache = attention.attention_decode(p, cache, x, torch.tensor(0),
                                          rope_theta=1e4, cross=True)
    assert y.shape == x.shape and not cache["k"].any()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        x.shape).astype(np.float32))
    y, cache = attention.attention_decode(p, cache, x, torch.tensor(5),
                                          rope_theta=1e4, window=2)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    # position 5 lands in ring slot 5 % 4
    assert cache["v"][0, 1].abs().sum() > 0 \
        and cache["v"][0, [0, 2, 3]].abs().sum() == 0


def test_paged_kinds_match_reference():
    cfg, jcfg = t_get_config("qwen3-0.6b"), get_config("qwen3-0.6b")
    assert cache_mod.resolved_window(cfg, "attention") \
        == jcache.resolved_window(jcfg, "attention") == 0
    assert cache_mod.paged_kinds(cfg, ("attention",)) \
        == jcache.paged_kinds(jcfg, ("attention",)) == ["attention"]
    # the Mamba state is slot-indexed: no window, never paged
    fcfg = t_get_config("falcon-mamba-7b")
    jfcfg = get_config("falcon-mamba-7b")
    assert cache_mod.resolved_window(fcfg, "mamba") \
        == jcache.resolved_window(jfcfg, "mamba") == 0
    assert cache_mod.paged_kinds(fcfg, ("mamba",)) \
        == jcache.paged_kinds(jfcfg, ("mamba",)) == []
    # the RG-LRU state and the local-attention ring are slot-indexed
    hcfg = t_get_config("recurrentgemma-9b")
    jhcfg = get_config("recurrentgemma-9b")
    kinds = ("recurrent", "recurrent", "attention_local")
    assert [cache_mod.resolved_window(hcfg, k) for k in kinds] \
        == [jcache.resolved_window(jhcfg, k) for k in kinds] == [0, 0, 2048]
    assert cache_mod.paged_kinds(hcfg, kinds) \
        == jcache.paged_kinds(jhcfg, kinds) == []
    # MLA's latent cache is paged (ported since the MoE and MLA slice),
    # and so is a cross block's self part (since the vlm and encdec slice)
    mcfg, jmcfg = t_get_config("minicpm3-4b"), get_config("minicpm3-4b")
    assert cache_mod.paged_kinds(mcfg, ("mla",)) \
        == jcache.paged_kinds(jmcfg, ("mla",)) == ["mla"]
    assert cache_mod.paged_kinds(cfg, ("cross",)) \
        == jcache.paged_kinds(jcfg, ("cross",)) == ["cross"]

"""Port parity for multi-head latent attention (MiniCPM3's ``mla`` blocks,
minicpm3-4b) against the JAX package on the same numpy weights and
prompts.

The reduced minicpm3 (the reference's ``reduced``: d 256, 4 heads, q·k
heads 32 + 16 wide, v 32, latent ranks 64 / 32) runs in f32.
Tolerances: loss and gradients rtol 1e-4 / atol 1e-5 (as
``tests/test_torch_dense_family.py``); prefill and the absorbed dense
decode's logits atol 1e-4 (the reference's own bound between routes,
``tests/test_serve.py``) with greedy tokens equal; the schedulers' greedy
tokens equal.  Within the port, bitwise, as the reference pins for itself
(``tests/test_serve.py`` PARITY_ARCHS, ``tests/test_prefix_cache.py``):
the paged latent decode is the dense one (bf16 pools against a dense
cache at bf16; int8 pools against a dense cache holding the same
dequantized latents), and a prefix-cache hit is the cold chunked run.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch.engine import Engine as JEngine
from repro.models import cache as jcache
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.models.transformer import stage_plan as j_stage_plan
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import quant as Q
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.models import attention as attn_mod
from repro_torch.models import cache as cache_mod
from repro_torch.models.cache import DenseLayout, PagedLayout
from repro_torch.models.transformer import Model, stage_plan
from repro_torch.serve import Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "minicpm3-4b"
RTOL, ATOL = 1e-4, 1e-5
V = 512
B, P, GEN, PS = 2, 8, 16, 8
MP = -(-(P + GEN + 1) // PS)
CACHE_LEN = MP * PS


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JModel(reduced(get_config(ARCH)), remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _models():
    jm = JModel(reduced(get_config(ARCH)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    return jm, Model(t_reduced(t_get_config(ARCH)), loss_chunk=16)


def _jp():
    return jax.tree.map(jnp.asarray, _weights())


def _tp():
    return params_from_numpy(_weights(), device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def test_configs_and_stage_plan_match_reference():
    for cfg, jcfg in ((t_get_config(ARCH), get_config(ARCH)),
                      (t_reduced(t_get_config(ARCH)),
                       reduced(get_config(ARCH)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert [(s.kinds, s.repeats) for s in stage_plan(cfg)] == \
            [(s.kinds, s.repeats) for s in j_stage_plan(jcfg)]
    assert [s.kinds for s in stage_plan(t_get_config(ARCH))] == [("mla",)]


def test_full_param_count_matches_reference(monkeypatch):
    """minicpm3-4b at its published widths: the reference's tree and
    shapes, 4,262,025,728 parameters, counted on meta tensors."""
    shapes = jax.eval_shape(JModel(get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = [tuple(x.shape) for x in jax.tree.leaves(shapes)]

    class MetaGen:
        device = torch.device("meta")
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    params = Model(t_get_config(ARCH)).init(MetaGen())
    got = [tuple(x.shape) for x in T.leaves(params)]
    assert got == want
    assert sum(int(np.prod(s)) for s in got) == 4_262_025_728


def test_loss_and_grads_match_jax():
    jm, tm = _models()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, V, (2, 40)).astype(np.int32),
             "labels": rng.integers(0, V, (2, 40)).astype(np.int32)}
    batch["labels"][:, -2:] = -1
    j_loss, j_grads = jax.value_and_grad(jm.loss)(
        _jp(), jax.tree.map(jnp.asarray, batch))
    tp = _tp()
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, params_from_numpy(batch, device="cpu"))
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    assert "['stage0']['b0']['attn']['w_uk']" in paths
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def _dense_trace(tm, tp, prompts, cache_dtype=None):
    """Dense-layout greedy decode (logits per step); ``cache_dtype``
    casts the prefill's latent cache first (the paged pools' storage)."""
    lay = DenseLayout(tm)
    logits, cache = lay.prefill(tp, {"tokens": prompts},
                                cache_len=CACHE_LEN)
    if cache_dtype is not None:
        cache = T.map(lambda a: a.to(cache_dtype), cache)
    trace = [logits]
    pos = torch.tensor(P)
    for _ in range(GEN):
        logits, cache = lay.decode_step(tp, cache, {
            "tokens": trace[-1].argmax(-1)[:, None], "pos": pos})
        trace.append(logits)
        pos = pos + 1
    return trace


def test_prefill_and_absorbed_decode_match_jax():
    """The prefill's logits and latent cache, and 16 greedy steps of the
    absorbed dense decode: the reference's greedy tokens (one-shot
    generate), logits within 1e-4 at every step."""
    jm, tm = _models()
    prompts = _tokens((B, P), 1)
    jl, jc = jm.prefill(_jp(), {"tokens": jnp.asarray(prompts)},
                        cache_len=CACHE_LEN)
    tl, tc = tm.prefill(_tp(), {"tokens": torch.from_numpy(prompts).long()},
                        cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for name in ("ckv", "k_rope"):
        assert tuple(tc[0]["b0"][name].shape) == jc[0]["b0"][name].shape
        np.testing.assert_allclose(tc[0]["b0"][name].numpy(),
                                   np.asarray(jc[0]["b0"][name]), atol=1e-4,
                                   rtol=0, err_msg=name)
    want = np.asarray(JEngine(jm).generate(_jp(), jnp.asarray(prompts),
                                           gen=GEN))
    got = Engine(tm).generate(_tp(), torch.from_numpy(prompts).long(),
                              gen=GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    trace = _dense_trace(tm, _tp(), torch.from_numpy(prompts).long())
    jstep = jax.jit(jm.decode_step)
    tok = jnp.asarray(want[:, 0])
    for t in range(GEN - 1):
        jl, jc = jstep(_jp(), jc, {"tokens": tok[:, None],
                                   "pos": jnp.int32(P + t)})
        np.testing.assert_allclose(trace[t + 1].numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=0, err_msg=f"step {t}")
        tok = jnp.asarray(want[:, t + 1])


class _DequantizedDenseOps:
    """Dense latent caches (f32) written the way an int8 page is: each
    token's latents quantized and dequantized, so the dense decode sees
    the very values the paged gather dequantizes."""

    def __init__(self, pos):
        self.pos = pos

    def mla_update(self, cache, ckv_t, k_rope_t):
        rows = torch.arange(ckv_t.shape[0])
        for name, new in (("ckv", ckv_t), ("k_rope", k_rope_t)):
            qv, sc = cache_mod._quantize_tokens(new, "int8", 1)
            cache[name][rows, self.pos] = qv.float() * sc[:, None]
        valid = torch.arange(cache["ckv"].shape[1]) <= self.pos
        return cache["ckv"], cache["k_rope"], valid, cache


@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_paged_decode_is_bitwise_the_dense_decode(pools):
    """16 greedy steps: the paged latent decode's logits are BITWISE the
    dense decode's at matched linearized cache length: bf16 compute over
    bf16 pools against the dense cache at bf16, and f32 compute over int8
    pools against a dense cache of the same dequantized latents."""
    _, tm = _models()
    tp = _tp()
    prompts = torch.from_numpy(_tokens((B, P), 1)).long()
    if pools == "bfloat16":
        tm = Model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"))
        dense = _dense_trace(tm, tp, prompts, torch.bfloat16)
        kv_dtype = None
    else:
        logits, cache = tm.prefill(tp, {"tokens": prompts},
                                   cache_len=CACHE_LEN)
        for name, x in cache[0]["b0"].items():
            qv, sc = cache_mod._quantize_tokens(x, "int8", 3)
            x.copy_(qv.float() * sc[..., None])
        dense = [logits]
        pos = torch.tensor(P)
        for _ in range(GEN):
            logits, cache = tm.decode_step(
                tp, cache, {"tokens": dense[-1].argmax(-1)[:, None],
                            "pos": pos}, cache_ops=_DequantizedDenseOps(pos))
            dense.append(logits)
            pos = pos + 1
        kv_dtype = "int8"
    lay = PagedLayout(tm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                      max_pages=MP, kv_dtype=kv_dtype)
    cache = lay.init_cache(device="cpu")
    want_dtype = torch.int8 if pools == "int8" else torch.bfloat16
    assert cache[0]["b0"]["ckv"].dtype == want_dtype
    pages = torch.arange(1, B * MP + 1).reshape(B, MP)
    logits, cache = lay.prefill_into(tp, cache, {"tokens": prompts},
                                     pages[:, :lay.pages_for(P)])
    assert torch.equal(logits, dense[0])
    pos = torch.full((B,), P)
    for t in range(GEN):
        logits, cache = lay.decode_step(tp, cache,
                                        logits.argmax(-1)[:, None], pos,
                                        pages)
        assert torch.equal(logits, dense[t + 1]), f"step {t}"
        pos = pos + 1


def test_paged_decode_tracks_the_reference_paged():
    """The f32 paged latent decode against the reference's paged layout
    on the same pages: logits within 1e-4 and greedy tokens equal."""
    jm, tm = _models()
    prompts = _tokens((B, P), 2)
    pages = np.arange(1, B * MP + 1, dtype=np.int32).reshape(B, MP)
    jl_ = JPagedLayout(jm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                       max_pages=MP)
    jlog, jc = jl_.prefill_into(_jp(), jl_.init_cache(),
                                {"tokens": jnp.asarray(prompts)},
                                jnp.asarray(pages[:, :1]), jnp.arange(B))
    lay = PagedLayout(tm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                      max_pages=MP)
    tlog, tc = lay.prefill_into(_tp(), lay.init_cache(device="cpu"),
                                {"tokens": torch.from_numpy(prompts).long()},
                                torch.from_numpy(pages[:, :1]).long())
    jstep = jax.jit(jl_.decode_step)
    pos = np.full((B,), P, np.int32)
    for t in range(GEN):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0, err_msg=f"step {t}")
        tok = np.asarray(jlog).argmax(-1)
        assert tlog.argmax(-1).tolist() == tok.tolist()
        jlog, jc = jstep(_jp(), jc, jnp.asarray(tok[:, None]),
                         jnp.asarray(pos), jnp.asarray(pages))
        tlog, tc = lay.decode_step(_tp(), tc,
                                   torch.from_numpy(tok[:, None]).long(),
                                   torch.from_numpy(pos).long(),
                                   torch.from_numpy(pages).long())
        pos += 1


def _prefix_prompts(seed=0):
    """The reference's prefix-cache family: a shared 20-token prompt and
    tails that diverge inside page 2 (so sharing needs copy-on-write)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, V, 20).tolist()
    return [shared + rng.integers(1, V, 7).tolist() for _ in range(3)]


def _serve_chunked(sched, req, model, params, prefix_cache):
    sch = sched(model, params, slots=2, pages=40, page_size=PS,
                max_len=5 * PS, prefill_chunk=2 * PS,
                prefix_cache=prefix_cache)
    for i, pr in enumerate(_prefix_prompts()):
        sch.run([req(rid=i, prompt=list(pr), max_new=6)])
    return {r.rid: list(r.out) for r in sch.finished}, sch


def test_prefix_hit_is_bitwise_the_cold_chunked_run():
    """The port of ``tests/test_prefix_cache.py``'s pin at minicpm3:
    requests 2 and 3 share request 1's committed latent pages (and copy
    the partly shared page on write); their greedy tokens are bitwise the
    cold chunked run's, which are the reference's."""
    jm, tm = _models()
    cold, cold_sch = _serve_chunked(Scheduler, Request, tm, _tp(), False)
    hot, sch = _serve_chunked(Scheduler, Request, tm, _tp(), True)
    assert hot == cold
    s = sch.latency_summary()
    assert s["prefix_hits"] >= 2 and s["prefix_hit_tokens"] >= 2 * 20
    assert s["cow_copies"] >= 1
    assert s["cache_tokens_allocated"] < \
        cold_sch.latency_summary()["cache_tokens_allocated"]
    ref, _ = _serve_chunked(JScheduler, JRequest, jm, _jp(), False)
    assert cold == ref


def test_prefix_hit_is_bitwise_cold_across_key_blocks():
    """An MLA chunk attends over key blocks of ``MLA_KEY_BLOCK`` (256)
    keys on every device.  Two requests share a 280-token prompt (35
    pages), so the hit's first chunk starts past the first key block and
    its rows span two: each prompt's last-chunk logits and the greedy
    tokens are still bitwise the cold chunked run's, the blocking being
    fixed and aligned to key 0."""
    _, tm = _models()
    rng = np.random.default_rng(7)
    system = rng.integers(0, V, 280).tolist()
    prompts = [system + rng.integers(0, V, n).tolist() for n in (20, 37)]
    assert attn_mod.MLA_KEY_BLOCK < 280 < 2 * attn_mod.MLA_KEY_BLOCK
    out, last = [], []
    for prefix_cache in (False, True):
        sch = Scheduler(tm, _tp(), slots=2, pages=100, page_size=PS,
                        max_len=336, prefill_chunk=8 * PS,
                        prefix_cache=prefix_cache)
        resume, logits = sch.layout.prefill_resume, []

        def recording(*a, resume=resume, logits=logits):
            lg, cache = resume(*a)
            logits.append(lg)
            return lg, cache
        sch.layout.prefill_resume = recording
        for i, pr in enumerate(prompts):
            sch.run([Request(rid=i, prompt=list(pr), max_new=4)])
            last.append(logits[-1])
        out.append({r.rid: list(r.out) for r in sch.finished})
    assert out[1] == out[0]
    assert all(torch.equal(a, b) for a, b in zip(last[:2], last[2:]))
    s = sch.latency_summary()
    assert s["prefix_hits"] == 1 and s["prefix_hit_tokens"] == 280


def test_scheduler_whole_prompt_matches_the_reference():
    """Four requests of mixed lengths, whole-prompt admission with decode
    bursts, through both packages' schedulers: equal greedy tokens."""
    jm, tm = _models()
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, V, n).tolist(), g)
             for n, g in ((10, 6), (13, 9), (10, 5), (21, 7))]
    out = []
    for sched, req, m, p in ((Scheduler, Request, tm, _tp()),
                             (JScheduler, JRequest, jm, _jp())):
        sch = sched(m, p, slots=2, pages=24, page_size=PS, max_len=32,
                    decode_burst=3)
        done = sch.run([req(rid=i, prompt=list(pr), max_new=g)
                        for i, (pr, g) in enumerate(specs)])
        out.append({r.rid: list(r.out) for r in done})
    assert out[0] == out[1]


def test_latent_pools_and_bytes_match_the_reference():
    """The latent pools' tree (int8 with per-token scales), the kinds, and
    the capacity facts of the published minicpm3-4b: at bf16 a token
    costs 62 x (256 + 32) x 2 = 35,712 B."""
    jm, tm = _models()
    kw = dict(n_slots=B, num_pages=5, page_size=PS, max_pages=2,
              kv_dtype="int8")
    ref = JPagedLayout(jm, **kw).init_cache()
    got = PagedLayout(tm, **kw).init_cache(device="cpu")
    assert sorted(got[0]["b0"]) == sorted(ref[0]["b0"]) == [
        "ckv", "ckv_scale", "k_rope", "k_rope_scale"]
    for name, a in ref[0]["b0"].items():
        t = got[0]["b0"][name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), name
    cfg, jcfg = t_get_config(ARCH), get_config(ARCH)
    assert cache_mod.resolved_window(cfg, "mla") \
        == jcache.resolved_window(jcfg, "mla") == 0
    assert cache_mod.paged_kinds(cfg, ("mla",)) \
        == jcache.paged_kinds(jcfg, ("mla",)) == ["mla"]
    for kv_dtype in (None, "float32", "int8", "fp8"):
        kw = dict(n_slots=16, num_pages=641, page_size=16, max_pages=640,
                  kv_dtype=kv_dtype)
        lay = PagedLayout(Model(cfg), **kw)
        want = JPagedLayout(JModel(jcfg), **kw)
        assert lay.kv_bytes_per_token() == want.kv_bytes_per_token()
        assert lay.page_bytes() == want.page_bytes()
        assert lay.chunkable and want.chunkable
    assert PagedLayout(Model(cfg), **dict(kw, kv_dtype=None)) \
        .kv_bytes_per_token() == 62 * (256 + 32) * 2 == 35_712
    assert Q.SCALE_BYTES == 4

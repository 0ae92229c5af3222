"""Port parity for chunked prefill, the prefix cache and copy-on-write:
twins of ``tests/test_prefix_cache.py`` on the port, the port's chunked
``Scheduler`` against the reference's on the same numpy weights and
prompts, and the pieces under them (``blocked_attention``, the
flash-attention plain version with a query offset, ``copy_page`` and the
chunk scatter's scratch routing).

Tolerances (f32, reduced configs): greedy tokens exactly (the packages'
logits agree to ~1e-5 here, far inside the argmax margins); last-chunk
logits atol 1e-4; ``blocked_attention`` and the flash plain version
against the reference's ``_blocked_attention`` rtol 1e-5 / atol 1e-6
(f32 sums in another order).  Within the port, a prefix hit's greedy
tokens are bitwise the cold chunked run's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.attention import _blocked_attention
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.serve import PagePool as JPagePool
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.launch import serve
from repro_torch.models.attention import blocked_attention
from repro_torch.models.cache import SCRATCH_PAGE, PagedLayout, _ChunkOps
from repro_torch.models.transformer import Model
from repro_torch.serve import PagePool, PrefixCache, Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401

PS = 8  # page size used throughout
CACHES = pytest.mark.parametrize("pool_cls,cache_cls",
                                 [(JPagePool, JPrefixCache),
                                  (PagePool, PrefixCache)],
                                 ids=["jax", "torch"])


def _model(arch="qwen3-0.6b"):
    return Model(t_reduced(t_get_config(arch)))


def _params(m, seed=0):
    return m.init(torch.Generator().manual_seed(seed))


def _prompts(vocab, seed=0):
    """A 3-request family: shared 20-token system prefix, distinct tails
    that diverge INSIDE page 2 (so sharing needs copy-on-write)."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, vocab, 20).tolist()
    return [sys_prompt + rng.integers(1, vocab, 7).tolist()
            for _ in range(3)]


def _serve(model, params, prompts, *, prefix_cache, gens=None, slots=2,
           pages=40, chunk=2 * PS, max_len=5 * PS, together=False,
           sched=Scheduler, req=Request, **kw):
    sch = sched(model, params, slots=slots, pages=pages, page_size=PS,
                max_len=max_len, prefill_chunk=chunk,
                prefix_cache=prefix_cache, **kw)
    gens = gens or [6] * len(prompts)
    reqs = [req(rid=i, prompt=list(p), max_new=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    if together:
        sch.run(reqs)
    else:
        for r in reqs:                           # sequential: later ones hit
            sch.run([r])
    return {r.rid: list(r.out) for r in sch.finished}, sch


# ---------------------------------------------------------------------------
# PrefixCache host-side index (no model), on both packages' classes
# ---------------------------------------------------------------------------


@CACHES
def test_prefix_cache_match_walks_full_page_chain(pool_cls, cache_cls):
    pool = pool_cls(16, 4)
    cache = cache_cls(pool, 4)
    toks = list(range(100, 110))                 # 2 full pages + 2 tokens
    pages = pool.alloc(3)
    assert cache.commit(toks, pages) == 2        # partial page 2 not indexed
    assert pool.refcount(pages[0]) == 2          # us + the cache
    assert pool.refcount(pages[2]) == 1          # partial page stays private
    got, n = cache.match(toks)
    assert got == pages[:2] and n == 8
    assert pool.refcount(pages[0]) == 3          # match hands out a ref
    # a different chain shares nothing even when one PAGE's tokens agree
    other = [0, 0, 0, 0] + toks[4:8]
    got2, n2 = cache.match(other)
    assert got2 == [] and n2 == 0
    assert cache.stats() == {"committed_pages": 2, "hits": 1, "misses": 1,
                             "hit_tokens": 8, "evictions": 0}


@CACHES
def test_prefix_cache_partial_tail_match_prefers_longest(pool_cls,
                                                         cache_cls):
    pool = pool_cls(16, 4)
    cache = cache_cls(pool, 4)
    a = pool.alloc(2)
    b = pool.alloc(2)
    cache.commit([1, 2, 3, 4, 5, 6, 7, 8], a)
    cache.commit([1, 2, 3, 4, 5, 6, 9, 9], b)   # same page 0 -> a[0] reused
    assert cache.match([1, 2, 3, 4])[0] == [a[0]]
    got, n = cache.match([1, 2, 3, 4, 5, 6, 9])
    assert n == 7, "partial overlap with b's page 1 (3 of 4 tokens)"
    assert got == [a[0], b[1]]


@CACHES
def test_prefix_cache_eviction_respects_refcounts_and_children(pool_cls,
                                                               cache_cls):
    pool = pool_cls(16, 4)
    cache = cache_cls(pool, 4)
    pages = pool.alloc(2)
    cache.commit([1, 2, 3, 4, 5, 6, 7, 8], pages)
    pool.free(pages)                             # cache is now sole holder
    held, n = cache.match([1, 2, 3, 4])          # we re-take page 0
    assert (held, n) == ([pages[0]], 4)
    # page 0 has a committed child AND an external ref: only the
    # childless page 1 is evictable
    assert cache.evict(2) == 1
    assert len(cache) == 1 and pool.refcount(pages[1]) == 0
    assert cache.evict(1) == 0, "page 0 still externally referenced"
    pool.free(held)
    assert cache.evict(1) == 1, "sole-holder parent evicts once child is gone"
    assert pool.used_pages == 0


@CACHES
def test_prefix_cache_commit_first_writer_wins(pool_cls, cache_cls):
    pool = pool_cls(16, 4)
    cache = cache_cls(pool, 4)
    a = pool.alloc(1)
    b = pool.alloc(1)
    assert cache.commit([1, 2, 3, 4], a) == 1
    assert cache.commit([1, 2, 3, 4], b) == 0    # duplicate chain: kept as a
    assert cache.match([1, 2, 3, 4])[0] == [a[0]]
    assert pool.refcount(b[0]) == 1, "loser keeps only its own ref"


# ---------------------------------------------------------------------------
# bitwise within the port: prefix-hit decode == cold chunked decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "stablelm-3b",
                                  "granite-20b"])
def test_prefix_hit_decode_is_bitwise_cold(arch):
    """Requests 2 and 3 share request 1's committed prompt pages (and copy
    the partly shared page on write): their greedy tokens must be bit for
    bit the no-cache chunked run's."""
    m = _model(arch)
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)
    cold, cold_sch = _serve(m, params, prompts, prefix_cache=False)
    hot, sch = _serve(m, params, prompts, prefix_cache=True)
    assert hot == cold
    s = sch.latency_summary()
    assert s["prefix_hits"] >= 2 and s["prefix_hit_tokens"] >= 2 * 20
    assert s["cow_copies"] >= 1, "divergence inside page 2 must copy"
    assert s["cache_tokens_allocated"] < \
        cold_sch.latency_summary()["cache_tokens_allocated"]


def test_prefix_hit_skips_prefill_chunks():
    m = _model()
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)
    _, cold_sch = _serve(m, params, prompts, prefix_cache=False)
    _, hot_sch = _serve(m, params, prompts, prefix_cache=True)
    assert hot_sch.stats["chunks"] < cold_sch.stats["chunks"], \
        "hits must skip whole prefill chunks, not just bookkeeping"
    assert hot_sch.pool.total_allocs < cold_sch.pool.total_allocs


def test_concurrent_sharers_and_eviction_leave_sharer_pages_intact():
    """Both sharers in flight at once; the short one finishes (its pages
    freed) while the other still decodes on the shared pages: outputs equal
    the cold run and no refcount error fires."""
    m = _model()
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)[:2]
    gens = [2, 9]
    cold, _ = _serve(m, params, prompts, prefix_cache=False, gens=gens,
                     together=True)
    hot, sch = _serve(m, params, prompts, prefix_cache=True, gens=gens,
                      together=True)
    assert hot == cold
    # after the drain only the cache's own references remain
    assert sch.pool.used_pages == len(sch.prefix.pages())
    assert all(sch.pool.refcount(p) == 1 for p in sch.prefix.pages())


def test_shared_pages_counted_once_in_occupancy():
    m = _model()
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)[:2]
    _, sch = _serve(m, params, prompts, prefix_cache=True, gens=[8, 8],
                    together=False)
    occ = sch.stats["occupancy"]
    assert any(o.get("shared_pages", 0) > 0 for o in occ), \
        "the second request must actually share pages"
    for o in occ:
        assert o["internal_fragmentation"] >= 0.0, \
            "shared pages double-counted in used_tokens"


def test_preemption_under_starvation_never_frees_referenced_pages():
    """A pool too small for both sharers at full length: preemption and
    prefix eviction recycle only unreferenced pages (any violation raises
    inside PagePool.free) and every request still completes."""
    m = _model()
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)[:2]
    hot, sch = _serve(m, params, prompts, prefix_cache=True, pages=9,
                      gens=[12, 12], together=True)
    assert sorted(hot) == [0, 1]
    assert all(len(v) == 12 for v in hot.values())
    assert sch.stats["preemptions"] >= 1, \
        "9 usable pages cannot hold both lanes at full length"
    cold, _ = _serve(m, params, prompts, prefix_cache=False, pages=40,
                     gens=[12, 12], together=True)
    assert hot == cold, "preemption/eviction must not change any token"


# ---------------------------------------------------------------------------
# chunked prefill scheduling
# ---------------------------------------------------------------------------


def test_chunk_count_is_ceil_of_prompt_over_chunk():
    m = _model()
    params = _params(m)
    prompt = np.random.default_rng(0).integers(
        1, m.cfg.vocab_size, 30).tolist()
    _, sch = _serve(m, params, [prompt], prefix_cache=False, chunk=PS)
    assert sch.stats["chunks"] == -(-30 // PS)


def test_long_prefill_interleaves_with_running_decode():
    """A long prompt admitted while short requests decode does not stall
    them: the short requests finish BEFORE the long prefill completes, and
    the long request's tokens still match its solo run."""
    m = _model()
    params = _params(m)
    rng = np.random.default_rng(1)
    long_p = rng.integers(1, m.cfg.vocab_size, 36).tolist()
    short_p = rng.integers(1, m.cfg.vocab_size, 4).tolist()
    solo, _ = _serve(m, params, [long_p], prefix_cache=False, chunk=4,
                     slots=3, max_len=6 * PS)
    sch = Scheduler(m, params, slots=3, pages=40, page_size=PS,
                    max_len=6 * PS, prefill_chunk=4)
    reqs = [Request(rid=0, prompt=list(short_p), max_new=3),
            Request(rid=1, prompt=list(short_p) + [7], max_new=3),
            Request(rid=2, prompt=list(long_p), max_new=6)]
    sch.run(reqs)
    done = {r.rid: r for r in sch.finished}
    assert done[2].out == solo[0]
    # 36 tokens at chunk 4 = 9 chunk steps; the short requests (admitted
    # in the same wave) complete while those are in flight
    assert done[0].t_done <= done[2].token_walls[0]
    assert done[1].t_done <= done[2].token_walls[0]


def test_chunked_mode_rejects_unchunkable_archs():
    m = _model("falcon-mamba-7b")
    params = _params(m)
    jm = JModel(reduced(get_config("falcon-mamba-7b")), remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    for kw in ({"prefill_chunk": 8}, {"prefix_cache": True}):
        with pytest.raises(NotImplementedError) as ours:
            Scheduler(m, params, slots=1, pages=8, page_size=8, max_len=32,
                      **kw)
        with pytest.raises(NotImplementedError) as theirs:
            JScheduler(jm, jp, slots=1, pages=8, page_size=8, max_len=32,
                       **kw)
        assert str(ours.value) == str(theirs.value)
    lay = PagedLayout(m, n_slots=1, num_pages=8, page_size=8, max_pages=4)
    assert not lay.chunkable
    with pytest.raises(NotImplementedError):
        lay.prefill_resume(params, None, torch.zeros((1, 8), dtype=torch.long),
                           0, 7, torch.ones((1, 4), dtype=torch.long))


def test_ttft_reported_in_latency_summary():
    m = _model()
    params = _params(m)
    prompts = _prompts(m.cfg.vocab_size)[:2]
    _, sch = _serve(m, params, prompts, prefix_cache=True, together=True)
    s = sch.latency_summary()
    assert 0.0 <= s["p50_ttft_s"] <= s["p95_ttft_s"]
    for k in ("prefill_chunks", "cow_copies", "cache_tokens_allocated",
              "prefix_committed_pages", "prefix_hits", "prefix_misses",
              "prefix_hit_tokens", "prefix_evictions"):
        assert k in s, k


# ---------------------------------------------------------------------------
# parity with the JAX package: the same weights and prompts through both
# packages' chunked schedulers (the reference's runs once per module)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both():
    jm = JModel(reduced(get_config("qwen3-0.6b")), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = _model()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = _prompts(tm.cfg.vocab_size, seed=3)
    runs = {}
    for name, sched, req, m, p in (("jax", JScheduler, JRequest, jm, jp),
                                   ("torch", Scheduler, Request, tm, tp)):
        runs[name] = _serve(m, p, prompts, prefix_cache=True, sched=sched,
                            req=req, gens=[5, 7, 6])
    return jm, jp, tm, tp, prompts, runs


def test_chunked_prefix_greedy_tokens_match_jax(both):
    *_, runs = both
    (j_out, j_sch), (t_out, t_sch) = runs["jax"], runs["torch"]
    assert t_out == j_out
    js, ts = j_sch.latency_summary(), t_sch.latency_summary()
    for k in ("tokens", "decode_steps", "prefills", "prefill_chunks",
              "cow_copies", "cache_tokens_allocated", "prefix_hits",
              "prefix_misses", "prefix_hit_tokens", "prefix_committed_pages"):
        assert ts[k] == js[k], k


@pytest.mark.parametrize("chunk", [PS, 2 * PS + 3])
def test_last_chunk_logits_match_jax(both, chunk):
    """Chunk by chunk through ``prefill_resume`` (an unaligned chunk
    included): the last chunk's logits within atol 1e-4 of the
    reference's."""
    jm, jp, tm, tp, prompts, _ = both
    prompt = prompts[0] + prompts[1][20:]        # 34 tokens
    mp = 6
    bt = np.arange(1, mp + 1)[None]
    jl = JPagedLayout(jm, n_slots=1, num_pages=mp + 1, page_size=PS,
                      max_pages=mp)
    tl = PagedLayout(tm, n_slots=1, num_pages=mp + 1, page_size=PS,
                     max_pages=mp)
    jc, tc = jl.init_cache(), tl.init_cache(device="cpu")
    for s0 in range(0, len(prompt), chunk):
        e = min(s0 + chunk, len(prompt))
        toks = np.asarray([prompt[s0:e] + [0] * (chunk - (e - s0))])
        jlog, jc = jl.prefill_resume(
            jp, jc, jax.numpy.asarray(toks, jax.numpy.int32),
            jax.numpy.asarray([s0], jax.numpy.int32),
            jax.numpy.asarray([e - 1 - s0], jax.numpy.int32),
            jax.numpy.asarray(bt, jax.numpy.int32))
        tlog, tc = tl.prefill_resume(tp, tc, torch.as_tensor(toks), s0,
                                     e - 1 - s0, torch.as_tensor(bt))
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(tlog[:, :V].numpy(),
                               np.asarray(jlog)[:, :V], rtol=0, atol=1e-4)
    # the pages hold the reference's k and v
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0]["b0"][name][:, 1:].numpy(),
                                   np.asarray(jc[0]["b0"][name])[:, 1:],
                                   rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the pieces: blocked attention, B5's plain version with a query offset,
# copy-on-write, the chunk scatter
# ---------------------------------------------------------------------------


def _qkv(hd, Sq=12, Sk=40, KV=2, G=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("hd", [64, 80])
def test_blocked_attention_matches_reference(hd, window):
    q, k, v = _qkv(hd)
    q_pos = np.arange(20, 32)
    k_pos = np.arange(40)
    want = _blocked_attention(q, k, v, q_pos, k_pos, causal=True,
                              window=window, q_chunk=5, kv_chunk=8)
    got = blocked_attention(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)),
                            causal=True, window=window, q_chunk=5,
                            kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_plain_with_q_start_matches_blocked_reference(hd):
    """B5's plain version, queries at q_start + i over keys from 0: the
    function the reference's chunk computes with ``_blocked_attention``."""
    q, k, v = _qkv(hd)
    want = _blocked_attention(q, k, v, np.arange(25, 37), np.arange(40),
                              causal=True, window=0, q_chunk=12, kv_chunk=8)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=True, q_start=25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_blocked_attention_masked_tail_blocks_are_exact_no_ops():
    """A row's result does not depend on how many wholly masked key blocks
    follow its last live key: what makes a truncated view, and a chunk
    that starts elsewhere, give the same bits."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(64))
    q_pos = torch.arange(3, 15)
    full = blocked_attention(q, k, v, q_pos, torch.arange(40), causal=True,
                             window=0, q_chunk=12, kv_chunk=8)
    short = blocked_attention(q, k[:, :16], v[:, :16], q_pos,
                              torch.arange(16), causal=True, window=0,
                              q_chunk=12, kv_chunk=8)
    assert torch.equal(full, short)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_copy_page_copies_every_pool(kv_dtype):
    m = _model()
    lay = PagedLayout(m, n_slots=1, num_pages=6, page_size=PS, max_pages=4,
                      kv_dtype=kv_dtype)
    cache = lay.init_cache(device="cpu")
    g = torch.Generator().manual_seed(0)
    for pool in cache[0]["b0"].values():
        pool.copy_(torch.randn(pool.shape, generator=g).to(pool.dtype))
    before = {n: p.clone() for n, p in cache[0]["b0"].items()}
    cache = lay.copy_page(cache, 2, 4)
    assert set(cache[0]["b0"]) == ({"k", "v"} if kv_dtype is None else
                                   {"k", "v", "k_scale", "v_scale"})
    for n, p in cache[0]["b0"].items():
        assert torch.equal(p[:, 4], before[n][:, 2]), n
        keep = [i for i in range(6) if i != 4]
        assert torch.equal(p[:, keep], before[n][:, keep]), n


def test_chunk_scatter_routes_padded_tail_to_scratch():
    """Positions past the block table's last page (the padded tail of a
    prompt's last chunk) land on the scratch page, not on the clamped last
    entry; positions inside it land where the table says."""
    m = _model()
    lay = PagedLayout(m, n_slots=1, num_pages=8, page_size=PS, max_pages=3)
    bt = torch.tensor([[5, 6, 7]])
    positions = 20 + torch.arange(8)             # 20..27; the table ends at 24
    ops = _ChunkOps(lay, positions, bt, n_view=3, q_start=20)
    assert ops.phys.tolist() == [[7, 7, 7, 7, SCRATCH_PAGE, SCRATCH_PAGE,
                                  SCRATCH_PAGE, SCRATCH_PAGE]]
    assert ops.off.tolist() == [[4, 5, 6, 7, 0, 1, 2, 3]]
    pool = torch.zeros((8, PS, 1))
    ops._scatter(pool, torch.arange(1.0, 9.0).reshape(1, 8, 1))
    assert pool[7, 4:, 0].tolist() == [1.0, 2.0, 3.0, 4.0]
    assert pool[0, :4, 0].tolist() == [5.0, 6.0, 7.0, 8.0]
    assert float(pool[1:7].abs().sum()) == 0.0


def test_prefill_resume_view_stops_at_last_page_bitwise():
    """The chunk's view stops at the page of its last real position; the
    logits and pages are bitwise those of a block table whose later entries
    name pages full of other data."""
    m = _model()
    params = _params(m)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        1, m.cfg.vocab_size, (1, 2 * PS)))
    outs = []
    for extra in (False, True):
        lay = PagedLayout(m, n_slots=1, num_pages=9, page_size=PS,
                          max_pages=8)
        cache = lay.init_cache(device="cpu")
        if extra:   # garbage in pages the view must never read
            for p in cache[0]["b0"].values():
                p[:, 3:].normal_()
        bt = torch.arange(1, 9)[None]
        logits, cache = lay.prefill_resume(params, cache, prompt, 0,
                                           2 * PS - 1, bt)
        outs.append((logits, cache[0]["b0"]["k"][:, 1:3].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_serve_entry_point_prefix_cache(tmp_path, capsys):
    path = tmp_path / "r.jsonl"
    rng = np.random.default_rng(0)
    system = rng.integers(0, 512, 20).tolist()
    path.write_text("".join(
        '{"prompt": %s, "gen": %d}\n' % (system + rng.integers(
            0, 512, 5).tolist(), 4) for _ in range(3)))
    sch = serve.main(["--reduced", "--device", "cpu", "--requests",
                      str(path), "--slots", "1", "--pages", "12",
                      "--page-size", str(PS), "--prefill-chunk", "16",
                      "--prefix-cache"])
    out = capsys.readouterr().out
    assert "prefill_chunks" in out and "prefix_hits" in out
    s = sch.latency_summary()
    assert s["prefix_hits"] == 2 and s["cow_copies"] == 2
    assert all(len(r.out) == 4 for r in sch.finished)
    with pytest.raises(NotImplementedError):
        serve.main(["--reduced", "--device", "cpu", "--arch",
                    "falcon-mamba-7b", "--requests", str(path),
                    "--prefill-chunk", "16"])
    args = serve.build_argparser().parse_args([])
    assert (args.prefill_chunk, args.prefix_cache) == (0, False)


def test_reduced_dense_configs_agree():
    for arch in ("stablelm-3b", "granite-20b"):
        assert dataclasses.asdict(reduced(get_config(arch))) == \
            dataclasses.asdict(t_reduced(t_get_config(arch)))

"""Port parity for continuous batching: the page allocator, the scheduler's
greedy tokens against the JAX ``Scheduler`` on the same weights and
requests, the scheduler against one-shot generation within the port, the
samplers, and the ``repro_torch.launch.serve`` entry point on the CPU.

Greedy tokens are compared exactly: the packages' logits agree to ~4e-6
on this model (``tests/test_torch_serve.py``), far inside its argmax
margins.  The ``categorical`` sampler draws from a ``torch.Generator``,
not from ``jax.random``, so it is checked by its distribution.
"""
import hashlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.transformer import Model as JModel
from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.engine import Engine
from repro_torch.models.transformer import Model
from repro_torch.serve import SAMPLERS, PagePool, Request, Scheduler

ROOT = Path(__file__).resolve().parents[1]
POOLS = pytest.mark.parametrize("pool_cls", [JPagePool, PagePool],
                                ids=["jax", "torch"])


@pytest.fixture(scope="module")
def models():
    jm = JModel(reduced(get_config("qwen3-0.6b")), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_config("qwen3-0.6b")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompts(n, p_len, seed, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, p_len).tolist() for _ in range(n)]


def _run_both(models, specs, **sched_kw):
    """Serve the same (prompt, max_new) specs with both packages'
    schedulers; returns (port scheduler, {rid: tokens} of each)."""
    jm, jp, tm, tp = models
    out = []
    for sched_cls, req_cls, m, p in ((Scheduler, Request, tm, tp),
                                     (JScheduler, JRequest, jm, jp)):
        sch = sched_cls(m, p, **sched_kw)
        done = sch.run([req_cls(rid=i, prompt=list(pr), max_new=g)
                        for i, (pr, g) in enumerate(specs)])
        assert sorted(r.rid for r in done) == list(range(len(specs)))
        out.append((sch, {r.rid: list(r.out) for r in done}))
    (sch, got), (jsch, want) = out
    return sch, jsch, got, want


# ---------------------------------------------------------------------------
# page allocator (tests/test_serve.py's seven, on both packages' classes)
# ---------------------------------------------------------------------------


@POOLS
def test_pool_alloc_unique_and_reserved(pool_cls):
    pool = pool_cls(10, 16)
    got = pool.alloc(6)
    assert len(set(got)) == 6
    assert all(p >= 1 for p in got), "scratch page 0 must never be granted"
    assert pool.free_pages == 3 and pool.used_pages == 6


@POOLS
def test_pool_exhaustion_returns_none_not_partial(pool_cls):
    pool = pool_cls(5, 8)
    assert pool.alloc(4) is not None
    before = pool.free_pages
    assert pool.alloc(1) is None
    assert pool.free_pages == before, "failed alloc must not leak pages"


@POOLS
def test_pool_free_recycles_and_double_free_raises(pool_cls):
    pool = pool_cls(6, 8)
    a = pool.alloc(5)
    pool.free(a[:2])
    assert pool.free_pages == 2
    b = pool.alloc(2)
    assert set(b) == set(a[:2])  # LIFO reuse
    pool.free(b)
    with pytest.raises(ValueError):
        pool.free(b)  # double free
    with pytest.raises(ValueError):
        pool.free([0])  # the reserved scratch page was never granted


@POOLS
def test_pool_free_is_atomic_on_bad_batch(pool_cls):
    pool = pool_cls(8, 8)
    a = pool.alloc(4)
    before_free, before_used = pool.free_pages, pool.used_pages
    with pytest.raises(ValueError):
        pool.free([a[0], a[1], 0])          # reserved page in the batch
    with pytest.raises(ValueError):
        pool.free([a[0], a[1], 99])         # foreign page in the batch
    with pytest.raises(ValueError):
        pool.free([a[0], a[0]])             # intra-call double free
    assert pool.free_pages == before_free and pool.used_pages == before_used
    pool.free(a)
    assert pool.used_pages == 0


@POOLS
def test_pool_refcounts_share_and_release(pool_cls):
    pool = pool_cls(8, 8)
    [pg] = pool.alloc(1)
    pool.ref([pg])
    assert pool.refcount(pg) == 2
    assert pool.shared_pages == 1
    assert pool.used_pages == 1, "a shared page counts ONCE"
    pool.free([pg])
    assert pool.refcount(pg) == 1 and pool.free_pages == 6
    pool.free([pg])
    assert pool.refcount(pg) == 0 and pool.free_pages == 7
    with pytest.raises(ValueError):
        pool.free([pg])
    with pytest.raises(ValueError):
        pool.ref([pg])
    [pg2] = pool.alloc(1)
    pool.ref([pg2])
    with pytest.raises(ValueError):
        pool.free([pg2, pg2, pg2])          # 3 frees, 2 refs
    assert pool.refcount(pg2) == 2
    pool.free([pg2, pg2])
    assert pool.used_pages == 0


@POOLS
def test_pool_fragmentation_stats(pool_cls):
    pool = pool_cls(9, 16, bytes_per_page=1024)
    pool.alloc(4)
    s = pool.stats(used_tokens=40)  # 4 pages * 16 = 64 slots, 40 live
    assert s["used_pages"] == 4 and s["free_pages"] == 4
    assert s["utilization"] == pytest.approx(4 / 8)
    assert s["internal_fragmentation"] == pytest.approx(1 - 40 / 64)
    assert (s["pool_bytes"], s["used_bytes"]) == (8 * 1024, 4 * 1024)
    assert pool.capacity_tokens == 8 * 16


@POOLS
def test_pool_rejects_degenerate_config(pool_cls):
    with pytest.raises(ValueError):
        pool_cls(1, 16)  # nothing usable after the scratch reservation


# ---------------------------------------------------------------------------
# the scheduler against the JAX scheduler
# ---------------------------------------------------------------------------


def test_scheduler_staggered_evictions_match_jax(models):
    """Four requests, four slots, staggered max_new: short lanes evict
    while the row width stays; tokens equal the reference scheduler's."""
    vocab = models[2].cfg.vocab_size
    specs = list(zip(_prompts(4, 8, 2, vocab), [3, 6, 10, 16]))
    sch, _, got, want = _run_both(models, specs, slots=4, pages=14,
                                  page_size=8, max_len=32, decode_burst=4)
    assert got == want
    assert all(len(got[i]) == g for i, (_, g) in enumerate(specs))
    assert sch.pool.used_pages == 0


def test_scheduler_joins_reuse_freed_slots_match_jax(models):
    """More requests than slots: evictions hand slots and pages to the
    waiting queue (FIFO), every request completes, tokens equal the
    reference's."""
    specs = [(list(range(4 + 2 * i)), 3 + i) for i in range(6)]
    sch, jsch, got, want = _run_both(models, specs, slots=2, pages=12,
                                     page_size=8, max_len=40)
    assert got == want
    assert sch.pool.used_pages == 0
    assert sch.stats["prefills"] == jsch.stats["prefills"] >= 3
    order = [r.rid for r in sorted(sch.finished, key=lambda r: r.t_join)]
    assert order == sorted(order)


def test_scheduler_preempts_on_a_starved_pool_like_jax(models):
    """2 slots x up to 33 positions need 18 pages at full length; the pool
    has 11: the youngest lane is preempted and recompute-resumed, and
    every request still completes at its full length."""
    specs = [(list(range(8)), 24), (list(range(8)), 24)]
    sch, jsch, got, want = _run_both(models, specs, slots=2, pages=12,
                                     page_size=4, max_len=36)
    assert got == want
    assert all(len(t) == 24 for t in got.values())
    assert sch.stats["preemptions"] == jsch.stats["preemptions"] >= 1
    assert sch.pool.used_pages == 0


@pytest.mark.parametrize("burst", [1, 4])
def test_scheduler_decode_burst_is_token_invariant(models, burst):
    """Multi-step scheduling changes no request's tokens: burst 1 and 4
    give the reference's burst-4 tokens."""
    vocab = models[2].cfg.vocab_size
    specs = list(zip(_prompts(3, 8, 3, vocab), [4, 9, 14]))
    jm, jp, tm, tp = models
    sch = Scheduler(tm, tp, slots=2, pages=20, page_size=8, max_len=40,
                    decode_burst=burst)
    got = {r.rid: r.out for r in sch.run(
        [Request(rid=i, prompt=p, max_new=g)
         for i, (p, g) in enumerate(specs)])}
    jsch = JScheduler(jm, jp, slots=2, pages=20, page_size=8, max_len=40,
                      decode_burst=4)
    want = {r.rid: list(r.out) for r in jsch.run(
        [JRequest(rid=i, prompt=p, max_new=g)
         for i, (p, g) in enumerate(specs)])}
    assert got == want


def test_scheduler_matches_oneshot_generate_bitwise(models):
    """Equal-length requests joining together ARE the one-shot dense
    batch: greedy tokens agree exactly, with one grouped prefill."""
    _, _, tm, tp = models
    B, P, gen, ps = 2, 8, 12, 8
    mp = -(-(P + gen + 1) // ps)
    prompts = _prompts(B, P, 1, tm.cfg.vocab_size)
    dense = Engine(tm).generate(tp, torch.tensor(prompts), gen=gen,
                                cache_len=mp * ps)
    sch = Scheduler(tm, tp, slots=B, pages=B * mp + 2, page_size=ps,
                    max_len=mp * ps)
    done = sch.run([Request(rid=i, prompt=prompts[i], max_new=gen)
                    for i in range(B)])
    for r in done:
        assert r.out == dense[r.rid].tolist(), r.rid
    assert sch.pool.used_pages == 0
    assert sch.stats["prefills"] == 1, "equal-length joins must group"
    s = sch.latency_summary()
    assert s["tokens"] == B * gen and s["decode_steps"] == gen - 1
    assert s["kv_bytes_per_token"] == 2 * 2 * 2 * 64 * 4


def test_scheduler_rejects_oversized_request(models):
    _, _, tm, tp = models
    sch = Scheduler(tm, tp, slots=1, pages=6, page_size=8, max_len=32)
    with pytest.raises(ValueError):
        sch.submit(Request(rid=0, prompt=list(range(20)), max_new=20))


def test_scheduler_eos_evicts_on_the_first_occurrence(models):
    """The EOS token is one whose FIRST occurrence in the probe output is
    the intended index, so the run must stop right there.  (The probe
    repeats a token from index 3 on; ``tests/test_serve.py`` takes the
    repeat at index 4 as its EOS and expects a stop after 5 tokens, which
    no correct scheduler gives.)"""
    _, _, tm, tp = models
    prompt = list(range(8))
    kw = dict(slots=1, pages=12, page_size=8, max_len=48)
    [probe] = Scheduler(tm, tp, **kw).run(
        [Request(rid=0, prompt=prompt, max_new=12)])
    assert len(probe.out) == 12
    idx = 3
    assert probe.out[idx] not in probe.out[:idx]
    sch = Scheduler(tm, tp, eos_id=probe.out[idx], **kw)
    [early] = sch.run([Request(rid=0, prompt=prompt, max_new=12)])
    assert early.out == probe.out[:idx + 1], "evict ON the eos token"
    assert sch.pool.used_pages == 0


def test_unported_serving_options_raise(models):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="A11"):
        Scheduler(tm, tp, slots=1, pages=8, page_size=8, prefill_chunk=16)
    with pytest.raises(NotImplementedError, match="A11"):
        Scheduler(tm, tp, slots=1, pages=8, page_size=8, prefix_cache=True)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_categorical_sampler_draws_the_softmax(temperature):
    """N draws from one row of logits: every token's frequency within 5
    standard errors (sqrt(p (1 - p) / N)) of softmax(logits / T)."""
    N = 40_000
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0, 1.5, 0.2])
    gen = torch.Generator().manual_seed(0)
    draws = SAMPLERS["categorical"](logits.expand(N, -1), gen, temperature)
    freq = torch.bincount(draws, minlength=logits.numel()).double() / N
    p = torch.softmax(logits.double() / temperature, dim=0)
    se = (p * (1 - p) / N).sqrt()
    assert bool(((freq - p).abs() <= 5 * se + 1e-12).all()), (freq, p)
    assert torch.equal(SAMPLERS["greedy"](logits[None], None, 0.0),
                       torch.tensor([3]))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


CPU = ["--reduced", "--device", "cpu"]


def test_serve_oneshot_on_cpu():
    ids = serve.main(CPU + ["--batch", "2", "--prompt-len", "8",
                            "--gen", "4"])
    assert tuple(ids.shape) == (2, 4)
    assert bool((ids >= 0).all() and (ids < 512).all())


def test_serve_requests_on_cpu(tmp_path):
    path = tmp_path / "r.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in (
        {"prompt_len": 8, "gen": 5}, {"prompt": [1, 2, 3], "gen": 4},
        {"prompt_len": 12}, {"prompt_len": 8, "gen": 3})) + "\n")
    sch = serve.main(CPU + ["--requests", str(path), "--slots", "2",
                            "--pages", "12", "--page-size", "8",
                            "--paged-kernel", "--gen", "6"])
    assert sorted((r.rid, len(r.out)) for r in sch.finished) == \
        [(0, 5), (1, 4), (2, 6), (3, 3)]
    assert sch.pool.used_pages == 0 and sch.layout.use_kernel


def test_serve_poisson_writes_only_its_own_schedule(tmp_path, monkeypatch):
    bench = ROOT / "BENCH_serve.json"
    before = hashlib.sha256(bench.read_bytes()).hexdigest()
    monkeypatch.chdir(tmp_path)
    sentinel = tmp_path / "BENCH_serve.json"
    sentinel.write_text("{}")
    sch = serve.main(CPU + ["--poisson", "200", "--num-requests", "3",
                            "--gen", "3", "--slots", "2", "--pages", "12",
                            "--page-size", "8"])
    assert len(sch.finished) == 3
    schedule = json.loads((tmp_path / "serve_schedule.json").read_text())
    assert len(schedule["poisson"]["arrivals_s"]) == 3
    assert sentinel.read_text() == "{}"
    assert hashlib.sha256(bench.read_bytes()).hexdigest() == before


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--batch", "1", "--gen", "1"])

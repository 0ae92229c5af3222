"""Port parity for serving falcon-mamba (the ``ssm`` family): prefill,
one-shot generation and continuous batching of the reduced falcon-mamba-7b
(f32 compute) against the JAX package on the same weights (carried over
from ``repro``'s ``Model.init`` as numpy) and prompts.

Tolerances: prefill logits and the decode state within 1e-4 of the
reference's (the reference's own bound between routes,
``tests/test_serve.py``), greedy tokens equal.  Within the port the
slot-indexed layout is BITWISE the dense one under greedy decoding, as
the reference pins for itself (``test_paged_decode_bitwise_matches_dense``
at falcon-mamba), and the scheduler serves it without touching the page
pool (``test_scheduler_ssm_arch_runs_without_pages``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch.engine import Engine as JEngine
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch.engine import Engine
from repro_torch.models.cache import DenseLayout, PagedLayout
from repro_torch.models.transformer import Model
from repro_torch.serve import Request, Scheduler

ATOL = 1e-4
B, P, GEN, PS = 2, 8, 16, 8
MP = -(-(P + GEN + 1) // PS)
CACHE_LEN = MP * PS


@pytest.fixture(scope="module")
def models():
    jm = JModel(reduced(get_config("falcon-mamba-7b")), remat=False,
                q_chunk=16, kv_chunk=16, scan_chunk=16, loss_chunk=16)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(t_reduced(t_get_config("falcon-mamba-7b")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    return jm, jp, tm, tp, prompts


def test_params_have_the_reference_tree(models):
    """The port's own init gives the reference's tree: names, shapes and
    dtypes (``a_log``, ``dt_bias``, ``d_skip`` f32 under bf16 params)."""
    _, jp, tm, _, _ = models
    got = tm.init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(T.leaves(got)) == len(want)
    for path, a in want:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
    cfg = dataclasses.replace(tm.cfg, param_dtype="bfloat16")
    m = Model(cfg).init(torch.Generator().manual_seed(0))["stage0"]["b0"]
    assert m["mamba"]["w_in"].dtype == torch.bfloat16
    assert all(m["mamba"][n].dtype == torch.float32
               for n in ("a_log", "dt_bias", "d_skip"))


def test_prefill_logits_and_state_track_jax(models):
    jm, jp, tm, tp, prompts = models
    j_logits, j_cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                                   cache_len=CACHE_LEN)
    t_logits, t_cache = tm.prefill(
        tp, {"tokens": torch.as_tensor(prompts).long()}, cache_len=CACHE_LEN)
    assert t_logits.shape == (B, tm.vocab_padded)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=ATOL)
    assert sorted(t_cache[0]["b0"]) == sorted(j_cache[0]["b0"]) \
        == ["conv", "ssm"]
    for name, a in j_cache[0]["b0"].items():
        t = t_cache[0]["b0"][name]
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=ATOL,
                                   err_msg=name)


def test_oneshot_greedy_tokens_equal_jax(models):
    jm, jp, tm, tp, prompts = models
    want = np.asarray(JEngine(jm).generate(jp, jnp.asarray(prompts),
                                           gen=GEN))
    got = Engine(tm).generate(tp, torch.as_tensor(prompts).long(), gen=GEN)
    np.testing.assert_array_equal(got.numpy(), want)


def _dense_trace(tm, tp, prompts):
    lay = DenseLayout(tm)
    logits, cache = lay.prefill(tp, {"tokens": torch.as_tensor(prompts)
                                     .long()}, cache_len=CACHE_LEN)
    trace = [logits]
    pos = torch.tensor(P)
    for _ in range(GEN):
        logits, cache = lay.decode_step(
            tp, cache, {"tokens": trace[-1].argmax(-1)[:, None], "pos": pos})
        trace.append(logits)
        pos = pos + 1
    return trace


def test_slot_layout_is_bitwise_the_dense_layout(models):
    """>= 16 greedy steps: the slot-indexed state gives logits BITWISE the
    dense layout's at the same batch width; the pages are never read."""
    _, _, tm, tp, prompts = models
    dense = _dense_trace(tm, tp, prompts)
    lay = PagedLayout(tm, n_slots=B, num_pages=B * MP + 1, page_size=PS,
                      max_pages=MP)
    assert not lay.uses_pages and lay.pages_for(P) == 0
    assert lay.kv_bytes_per_token() == 0
    cache = lay.init_cache(device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            cache[0]["b0"].items()} == {
        "conv": ((2, B, 3, 512), torch.float32),
        "ssm": ((2, B, 512, 16), torch.float32)}
    # the joining rows land in slots 1 and 0 (the prefill batch's order)
    slots = torch.tensor([1, 0])
    logits, cache = lay.prefill_into(
        tp, cache, {"tokens": torch.as_tensor(prompts).long()},
        torch.zeros((B, 0), dtype=torch.long), slots)
    assert torch.equal(logits, dense[0])
    bt = torch.zeros((B, MP), dtype=torch.long)
    pos = torch.full((B,), P)
    tok = logits.argmax(-1)[slots.argsort()]     # per slot
    for t in range(GEN):
        logits, cache = lay.decode_step(tp, cache, tok[:, None], pos, bt)
        assert torch.equal(logits[slots], dense[t + 1]), f"step {t}"
        tok = logits.argmax(-1)
        pos = pos + 1
    with pytest.raises(ValueError, match="slot"):
        lay.prefill_into(tp, cache, {"tokens": torch.as_tensor(prompts)
                                     .long()}, torch.zeros((B, 0)))


def test_bf16_slot_state_is_rounded_like_the_reference(models):
    """Under bf16 compute the slot layout keeps the conv state at the
    compute dtype and the ssm state in f32 (``repro.models.cache``), so
    the slot's conv state is the dense prefill's rounded to bf16."""
    _, _, tm, tp, prompts = models
    tm = Model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"))
    lay = PagedLayout(tm, n_slots=B, num_pages=3, page_size=PS,
                      max_pages=2)
    cache = lay.init_cache(device="cpu")
    assert cache[0]["b0"]["conv"].dtype == torch.bfloat16
    assert cache[0]["b0"]["ssm"].dtype == torch.float32
    toks = {"tokens": torch.as_tensor(prompts).long()}
    _, dense = tm.prefill(tp, toks, cache_len=P)
    lay.prefill_into(tp, cache, toks, torch.zeros((B, 0), dtype=torch.long),
                     torch.arange(B))
    want = dense[0]["b0"]["conv"]
    assert want.dtype == torch.float32     # the f32 layers dominate
    assert torch.equal(cache[0]["b0"]["conv"], want.to(torch.bfloat16))
    assert torch.equal(cache[0]["b0"]["ssm"], dense[0]["b0"]["ssm"])


def test_scheduler_ssm_arch_runs_without_pages(models):
    """The port of the reference's test of the same name: slot-state-only
    models serve through the same scheduler and the pool stays untouched;
    the group prefill of equal-length requests matches one-shot generate
    token for token."""
    _, _, tm, tp, prompts = models
    sch = Scheduler(tm, tp, slots=2, pages=8, page_size=8, max_len=32)
    assert not sch.layout.uses_pages
    done = sch.run([Request(rid=i, prompt=list(range(4 + i)), max_new=5)
                    for i in range(3)])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 5 for r in done)
    assert sch.pool.used_pages == 0 and sch.pool.total_allocs == 0
    # no block-table width bounds a slot-state request (reference: submit)
    long = Scheduler(tm, tp, slots=2, pages=8, page_size=8, max_len=16)
    out = long.run([Request(rid=0, prompt=list(range(20)), max_new=6)])
    assert len(out[0].out) == 6 and long.pool.used_pages == 0
    summary = long.latency_summary()
    assert summary["tokens"] == 6 and "kv_bytes_per_token" not in summary
    # equal-length joiners are the one-shot batch
    sch = Scheduler(tm, tp, slots=B, pages=4, page_size=PS, decode_burst=3)
    done = sch.run([Request(rid=i, prompt=[int(t) for t in prompts[i]],
                            max_new=GEN) for i in range(B)])
    dense = Engine(tm).generate(tp, torch.as_tensor(prompts).long(),
                                gen=GEN)
    for r in done:
        assert r.out == dense[r.rid].tolist(), r.rid
    assert sch.stats["prefills"] == 1


def test_loss_raises_for_the_ssm_family(models):
    _, _, tm, tp, prompts = models
    toks = torch.as_tensor(prompts).long()
    with pytest.raises(NotImplementedError, match="Left out of slice 4"):
        tm.loss(tp, {"tokens": toks, "labels": toks})


def test_full_size_config_is_the_reference(models):
    """falcon-mamba-7b at its published widths: the reference's config,
    and 7,272,665,088 parameters (counted from the reference's shapes)."""
    cfg = t_get_config("falcon-mamba-7b")
    jcfg = get_config("falcon-mamba-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == 7_272_665_088
    assert Model(cfg).vocab_padded == 65_024

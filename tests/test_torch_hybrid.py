"""Port parity for the hybrid family (recurrentgemma: RG-LRU + local
attention over a slot-indexed ring) and for sliding-window attention in a
dense config, against the JAX package on the same numpy weights.

The reduced recurrentgemma (the reference's ``reduced``: d 256, lru
width 256, window 64, 4 layers: one (recurrent, recurrent,
attention_local) unit in ``stage0`` and a one-block ``stage1``) runs in
f32.  Tolerances: loss and gradients rtol 1e-4 / atol 1e-5 (as
``tests/test_torch_dense_family.py``: f32 sums in other orders, and the
two associative scans reduce in other orders); the RG-LRU block, prefill
logits and caches atol 1e-4 (the reference's own bound between routes,
``tests/test_serve.py``); greedy decode across the ring's wrap: tokens
exact, logits atol 1e-4; the scheduler's greedy tokens exact.  Within the
port the slot ring is BITWISE the dense ring under greedy decoding, as
the reference pins for itself (``tests/test_serve.py``, with cache_len >=
window: the reference's dense ring is ``min(window, cache_len)`` wide, the
port's always ``window``, which keeps a decode past cache_len windowed
where the reference's drops keys; ROADMAP queue C).  The ``gpu`` test holds B5 at hd 256,
G 16 and a window against its plain version on the card.
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
from repro.models import rglru as j_rglru
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_plain
from repro_torch.launch.engine import Engine
from repro_torch.models import rglru
from repro_torch.models.cache import DenseLayout, PagedLayout
from repro_torch.models.transformer import Model, stage_plan
from repro_torch.serve import Request, Scheduler
from torch_decode import short_prompt_decode
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b"
RTOL, ATOL = 1e-4, 1e-5
WINDOW = 64
V = 512


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JModel(reduced(get_config(ARCH)), remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _models():
    jm = JModel(reduced(get_config(ARCH)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    tm = Model(t_reduced(t_get_config(ARCH)), loss_chunk=16, scan_chunk=16)
    return jm, tm


def _jp():
    return jax.tree.map(jnp.asarray, _weights())


def _tp():
    return params_from_numpy(_weights(), device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def test_configs_and_stage_plan_match_reference():
    from repro.models.transformer import stage_plan as j_stage_plan
    for cfg, jcfg in ((t_get_config(ARCH), get_config(ARCH)),
                      (t_reduced(t_get_config(ARCH)),
                       reduced(get_config(ARCH)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        got = [(s.kinds, s.repeats) for s in stage_plan(cfg)]
        assert got == [(s.kinds, s.repeats) for s in j_stage_plan(jcfg)]
    unit = ("recurrent", "recurrent", "attention_local")
    assert [(s.kinds, s.repeats) for s in stage_plan(t_get_config(ARCH))] \
        == [(unit, 12), (unit[:2], 1)]


def test_params_have_the_reference_tree():
    """The port's own init gives the reference's tree: names, shapes and
    dtypes (``lam`` f32 under bf16 params), ``stage0/b{0,1,2}`` with a
    leading 1 and ``stage1/b0`` at the reduced size."""
    want = jax.tree_util.tree_flatten_with_path(_weights())[0]
    tm = Model(t_reduced(t_get_config(ARCH)))
    got = tm.init(torch.Generator().manual_seed(0))
    assert sorted(got) == ["embed", "final_norm", "stage0", "stage1",
                           "unembed"]
    assert sorted(got["stage0"]) == ["b0", "b1", "b2"]
    assert sorted(got["stage1"]) == ["b0"]
    assert len(T.leaves(got)) == len(want)
    for path, a in want:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32, path
    bf = Model(dataclasses.replace(tm.cfg, param_dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))["stage0"]["b0"]["rglru"]
    assert bf["w_x"].dtype == torch.bfloat16 \
        and bf["conv_b"].dtype == torch.bfloat16
    assert bf["lam"].dtype == torch.float32
    # lam's init puts a = sigmoid(lam)^c in [0.9, 0.999] at r = 1
    a = torch.exp(-8.0 * torch.nn.functional.softplus(bf["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_full_param_count_matches_reference(monkeypatch):
    """The full config's tree and 10,444,771,328 parameters, made on meta
    tensors (nothing is allocated)."""
    shapes = jax.eval_shape(JModel(get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = [tuple(x.shape) for x in jax.tree.leaves(shapes)]

    class MetaGen:
        device = torch.device("meta")
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    monkeypatch.setattr(torch.Tensor, "uniform_",
                        lambda self, *a, **k: self)
    params = Model(t_get_config(ARCH)).init(MetaGen())
    got = [tuple(x.shape) for x in T.leaves(params)]
    assert got == want
    assert sum(int(np.prod(s)) for s in got) == 10_444_771_328


@pytest.mark.parametrize("S", [40, 48])
def test_rglru_forward_and_decode_match_jax(S):
    """One RG-LRU block: the full-sequence pass (S 40 pads to the chunk
    of 16, 48 does not) and 6 decode steps after it, state included."""
    cfg = t_reduced(t_get_config(ARCH)).rglru
    np_p = jax.tree.map(lambda a: a[0], _weights()["stage0"]["b0"]["rglru"])
    x = np.random.default_rng(1).standard_normal((2, S + 6, 256)) \
        .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_p)
    tp = params_from_numpy(np_p, device="cpu")
    want = j_rglru.rglru_forward(jp, jnp.asarray(x[:, :S]), cfg, chunk=16)
    got, state = rglru.rglru_prefill(tp, torch.from_numpy(x[:, :S]), cfg,
                                     chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert torch.equal(got, rglru.rglru_forward(
        tp, torch.from_numpy(x[:, :S]), cfg, chunk=16))
    # the reference's decode state after the prompt, stepped on
    jstate = {"conv": jnp.asarray(state["conv"].numpy()),
              "h": jnp.asarray(state["h"].numpy())}
    for t in range(S, S + 6):
        jy, jstate = j_rglru.rglru_decode(jp, jstate,
                                          jnp.asarray(x[:, t:t + 1]), cfg)
        ty, state = rglru.rglru_decode(tp, state,
                                       torch.from_numpy(x[:, t:t + 1]), cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(state["h"].numpy(),
                                   np.asarray(jstate["h"]), rtol=0,
                                   atol=1e-5)
    # the decode of a full sequence is the forward pass
    state = rglru.init_rglru_state(2, 256, cfg, torch.float32, "cpu")
    steps = [rglru.rglru_decode(tp, state, torch.from_numpy(
        x[:, t:t + 1]), cfg)[0] for t in range(S)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), got.numpy(),
                               rtol=0, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    from repro_torch.models.layers import act_fn
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = act_fn("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=0,
                               atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - np.asarray(jax.nn.gelu(x))).max() > 1e-4


def test_loss_and_grads_match_jax():
    jm, tm = _models()
    batch = {"tokens": _tokens((2, 40)), "labels": _tokens((2, 40), 1)}
    batch["labels"][:, -2:] = -1
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(
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
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for path, a, b in zip(paths, t_grads, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    assert float(np.abs(np.asarray(j_grads["stage1"]["b0"]["rglru"]
                                   ["lam"])).max()) > 0


@pytest.mark.parametrize("S", [40, 150])
def test_prefill_logits_and_caches_match_jax(S):
    """A prompt shorter (40) and longer (150) than the 64-token window:
    last-position logits, the rings (the last 64 positions at slot pos %
    64) and the RG-LRU states."""
    jm, tm = _models()
    toks = _tokens((2, S), S)
    jl, jc = jm.prefill(_jp(), {"tokens": jnp.asarray(toks)}, cache_len=160)
    tl, tc = tm.prefill(_tp(), {"tokens": torch.from_numpy(toks).long()},
                        cache_len=160)
    np.testing.assert_allclose(tl[:, :V].numpy(), np.asarray(jl)[:, :V],
                               rtol=0, atol=1e-4)
    assert len(tc) == len(jc) == 2
    for si in range(2):
        assert sorted(tc[si]) == sorted(jc[si])
        for b in jc[si]:
            assert sorted(tc[si][b]) == sorted(jc[si][b])
            for name, a in jc[si][b].items():
                t = tc[si][b][name]
                assert tuple(t.shape) == a.shape, (si, b, name)
                np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                           atol=1e-4, err_msg=f"{si}{b}"
                                           f"{name}")
    ring = tc[0]["b2"]["k"]
    assert ring.shape[2] == WINDOW
    if S < WINDOW:      # slots past the prompt are empty
        assert float(ring[:, :, S:].abs().max()) == 0


def _trace(model, params, toks, gen, cache_len, step_tokens=None):
    """Dense-layout greedy decode: prefill, then ``gen`` steps, each fed
    the previous argmax (or ``step_tokens``).  Returns the logits per
    step."""
    lay = DenseLayout(model)
    logits, cache = lay.prefill(params, {"tokens": toks},
                                cache_len=cache_len)
    trace = [logits]
    for t in range(gen):
        tok = trace[-1].argmax(-1) if step_tokens is None \
            else step_tokens[:, t]
        logits, cache = lay.decode_step(params, cache, {
            "tokens": tok[:, None], "pos": torch.tensor(toks.shape[1] + t)})
        trace.append(logits)
    return trace


def test_greedy_decode_across_the_wrap_matches_jax():
    """A 40-token prompt decoded for 40 steps (past position 64, where
    the ring wraps): the reference's greedy tokens exactly (one-shot
    generate), and logits within 1e-4 at every step, teacher-forced by
    the reference's tokens."""
    jm, tm = _models()
    toks = _tokens((2, 40), 7)
    gen = 40
    want = np.asarray(JEngine(jm).generate(_jp(), jnp.asarray(toks),
                                           gen=gen))
    got = Engine(tm).generate(_tp(), torch.from_numpy(toks).long(), gen=gen)
    np.testing.assert_array_equal(got.numpy(), want)
    # logits per step against the reference's dense decode
    jl, jc = jm.prefill(_jp(), {"tokens": jnp.asarray(toks)},
                        cache_len=40 + gen + 1)
    tt = torch.tensor(want).long()
    trace = _trace(tm, _tp(), torch.from_numpy(toks).long(), gen - 1,
                   40 + gen + 1, step_tokens=tt)
    np.testing.assert_allclose(trace[0][:, :V].numpy(),
                               np.asarray(jl)[:, :V], atol=1e-4, rtol=0)
    jstep = jax.jit(jm.decode_step)
    for t in range(gen - 1):
        jl, jc = jstep(_jp(), jc, {
            "tokens": jnp.asarray(want[:, t:t + 1]),
            "pos": jnp.int32(40 + t)})
        np.testing.assert_allclose(trace[t + 1][:, :V].numpy(),
                                   np.asarray(jl)[:, :V], atol=1e-4, rtol=0,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("P", [20, 40, 150])
def test_slot_ring_is_bitwise_the_dense_ring(P):
    """24 greedy steps from prompts of 20 (the dense cache_len 45 < the
    window), 40 (wrapping in decode) and 150 tokens (wrapping in the
    prefill): the slot layout's logits are BITWISE the dense layout's at
    the same batch width (both rings 64 wide); no page is allocated."""
    _, tm = _models()
    tp = _tp()
    B, gen = 2, 24
    toks = torch.from_numpy(_tokens((B, P), P)).long()
    dense = _trace(tm, tp, toks, gen, P + gen + 1)
    lay = PagedLayout(tm, n_slots=B, num_pages=4, page_size=8, max_pages=2)
    assert not lay.uses_pages and not lay.chunkable
    assert lay.kv_bytes_per_token() == 0
    cache = lay.init_cache(device="cpu")
    assert {(si, b, n): tuple(t.shape) for si, unit in enumerate(cache)
            for b, c in unit.items() for n, t in c.items()} == {
        (0, "b0", "conv"): (1, B, 3, 256), (0, "b0", "h"): (1, B, 256),
        (0, "b1", "conv"): (1, B, 3, 256), (0, "b1", "h"): (1, B, 256),
        (0, "b2", "k"): (1, B, WINDOW, 1, 64),
        (0, "b2", "v"): (1, B, WINDOW, 1, 64),
        (1, "b0", "conv"): (1, B, 3, 256), (1, "b0", "h"): (1, B, 256)}
    slots = torch.tensor([1, 0])
    logits, cache = lay.prefill_into(tp, cache, {"tokens": toks},
                                     torch.zeros((B, 0), dtype=torch.long),
                                     slots)
    assert torch.equal(logits, dense[0])
    bt = torch.zeros((B, 2), dtype=torch.long)
    pos = torch.full((B,), P)
    tok = logits.argmax(-1)[slots.argsort()]
    for t in range(gen):
        logits, cache = lay.decode_step(tp, cache, tok[:, None], pos, bt)
        assert torch.equal(logits[slots], dense[t + 1]), f"step {t}"
        tok = logits.argmax(-1)
        pos = pos + 1
    with pytest.raises(ValueError, match="slot"):
        lay.prefill_into(tp, cache, {"tokens": toks}, torch.zeros((B, 0)))


def test_bf16_slot_state_is_rounded_like_the_reference():
    """Under bf16 compute the slot layout keeps the rings and the conv
    states at the compute dtype and h in f32 (``repro.models.cache``),
    where the dense prefill's cache keeps the f32 of the f32 weights'
    products: the slot's ring and conv state are the dense prefill's
    rounded to bf16, h is equal."""
    _, tm = _models()
    tm = Model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"))
    toks = {"tokens": torch.from_numpy(_tokens((2, 90), 5)).long()}
    _, dense = tm.prefill(_tp(), toks, cache_len=WINDOW)
    lay = PagedLayout(tm, n_slots=2, num_pages=2, page_size=8, max_pages=1)
    cache = lay.init_cache(device="cpu")
    lay.prefill_into(_tp(), cache, toks, torch.zeros((2, 0),
                                                     dtype=torch.long),
                     torch.arange(2))
    assert dense[0]["b2"]["k"].dtype == torch.float32
    for si, unit in enumerate(cache):
        for b, c in unit.items():
            for name, t in c.items():
                want = dense[si][b][name]
                assert t.dtype == (torch.float32 if name == "h"
                                   else torch.bfloat16), (si, b, name)
                assert torch.equal(t, want.to(t.dtype)), (si, b, name)


def test_scheduler_serves_the_hybrid_as_the_reference():
    """Requests of 30, 90 and 70 tokens (two longer than the window)
    through both packages' schedulers: equal greedy tokens, every request
    at its length, the page pool untouched."""
    jm, tm = _models()
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, V, n).tolist(), g)
             for n, g in ((30, 40), (90, 9), (70, 12))]
    out, schs = [], []
    for sched, req, m, p in ((Scheduler, Request, tm, _tp()),
                             (JScheduler, JRequest, jm, _jp())):
        sch = sched(m, p, slots=2, pages=8, page_size=8, max_len=32,
                    decode_burst=3)
        done = sch.run([req(rid=i, prompt=list(pr), max_new=g)
                        for i, (pr, g) in enumerate(specs)])
        out.append({r.rid: list(r.out) for r in done})
        schs.append(sch)
    assert out[0] == out[1]
    assert all(len(out[0][i]) == g for i, (_, g) in enumerate(specs))
    sch = schs[0]
    assert not sch.layout.uses_pages and sch.pool.total_allocs == 0


def test_chunked_prefill_refused_as_in_reference():
    jm, tm = _models()
    for kw in ({"prefill_chunk": 8}, {"prefix_cache": True}):
        with pytest.raises(NotImplementedError) as ours:
            Scheduler(tm, _tp(), slots=1, pages=8, page_size=8, max_len=32,
                      **kw)
        with pytest.raises(NotImplementedError) as theirs:
            JScheduler(jm, _jp(), slots=1, pages=8, page_size=8, max_len=32,
                       **kw)
        assert str(ours.value) == str(theirs.value)
    lay = PagedLayout(tm, n_slots=1, num_pages=8, page_size=8, max_pages=4)
    with pytest.raises(NotImplementedError):
        lay.prefill_resume(_tp(), None, torch.zeros((1, 8), dtype=torch.long),
                           0, 7, torch.ones((1, 4), dtype=torch.long))


def test_sliding_window_ring_cache_decode():
    """The port of the reference's test of the same name: reduced qwen3
    with ``sliding_window=4``; the ring decode (cache_len 12, ring 4
    wide) matches the windowed full forward beyond one wrap, and the
    full forward matches the reference's (1e-4)."""
    cfg = dataclasses.replace(t_reduced(t_get_config("qwen3-0.6b")),
                              sliding_window=4)
    jcfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                               sliding_window=4)
    jm = JModel(jcfg, remat=False, q_chunk=16, kv_chunk=16)
    jp = jm.init(jax.random.PRNGKey(2))
    m = Model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 1, 12
    toks = torch.from_numpy(_tokens((B, S), 4)).long()
    full = m.logits(params, {"tokens": toks})
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jm.logits(jp, {"tokens": jnp.asarray(
            toks.numpy())})), atol=1e-4, rtol=0)
    cache = m.init_cache(B, cache_len=S, device="cpu")
    assert cache[0]["b0"]["k"].shape[2] == 4
    for t in range(S):
        lg, cache = m.decode_step(params, cache, {
            "tokens": toks[:, t:t + 1], "pos": torch.tensor(t)})
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=0, err_msg=f"pos {t}")
    # the window masks something: the unwindowed model differs
    plain = Model(t_reduced(t_get_config("qwen3-0.6b")))
    assert float((plain.logits(params, {"tokens": toks})[:, -1]
                  - full[:, -1]).abs().max()) > 1e-3
    # and the slot ring serves it through the same seam
    lay = PagedLayout(m, n_slots=B, num_pages=2, page_size=8, max_pages=1)
    assert not lay.uses_pages
    assert lay.init_cache(device="cpu")[0]["b0"]["k"].shape == (2, B, 4, 2,
                                                               64)


def test_ring_decode_past_cache_len_stays_windowed():
    """Reduced qwen3 with an 8-token window decoded for 12 steps from a
    cache of 6 positions: the port's ring is 8 wide and matches the
    windowed full forward (1e-4); the reference's is min(8, 6) wide and
    drops keys still inside the window (a queue C caveat: its logits
    stray by more than 1)."""
    cfg = dataclasses.replace(t_reduced(t_get_config("qwen3-0.6b")),
                              sliding_window=8)
    jcfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                               sliding_window=8)
    jm = JModel(jcfg, remat=False, q_chunk=16, kv_chunk=16)
    jp = jm.init(jax.random.PRNGKey(2))
    m = Model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens((1, 12), 4)
    full = m.logits(params, {"tokens": torch.from_numpy(toks).long()})
    cache = m.init_cache(1, cache_len=6, device="cpu")
    jcache = jm.init_cache(1, cache_len=6)
    assert cache[0]["b0"]["k"].shape[2] == 8
    assert jcache[0]["b0"]["k"].shape[2] == 6
    jstep = jax.jit(jm.decode_step)
    for t in range(12):
        lg, cache = m.decode_step(params, cache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
            "pos": torch.tensor(t)})
        jlg, jcache = jstep(jp, jcache, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), atol=1e-4,
                               rtol=0)
    assert float(np.abs(np.asarray(jlg) - full[:, -1].numpy()).max()) > 1


@pytest.mark.parametrize("layout", ["dense", "slot"])
@pytest.mark.parametrize("P", [1, 2])
def test_short_prompt_decodes_like_the_whole_sequence(P, layout):
    """ROADMAP queue C5: a prompt shorter than ``conv_kernel - 1`` = 3
    tokens leaves a conv state of K - 1 rows, zeros before position 0
    (as `causal_conv1d` assumes), so the prefill and 4 teacher-forced
    decode steps stay within 1e-5 of the whole-sequence forward on both
    layouts, and within RTOL / ATOL of the reference's."""
    jm, tm = _models()
    toks = torch.from_numpy(_tokens((2, P + 4), 11)).long()
    got = short_prompt_decode(tm, _tp(), toks, P, layout)
    want = tm.logits(_tp(), {"tokens": toks})[:, P - 1:]
    assert float((got - want).abs().max()) < 1e-5
    ref = jm.logits(_jp(), {"tokens": jnp.asarray(toks.numpy())})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, P - 1:],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b"])
def test_reference_short_prompt_decode_is_off(arch):
    """The reference's own behavior at C5 (ROADMAP queue C), recorded as
    `test_ring_decode_past_cache_len_stays_windowed` records the ring's:
    it keeps ``xi[:, -(K-1):]``, S rows for a prompt of S < K - 1 = 3
    tokens.  At P = 1 its slot layout broadcasts the one row into all
    three conv rows and decodes more than 1 off the whole-sequence
    forward; at P = 2 the slot write raises."""
    jm = JModel(reduced(get_config(arch)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16)
    jp = _jp() if arch == ARCH else jm.init(jax.random.PRNGKey(0))
    B = 2
    toks = jnp.asarray(_tokens((B, 5), 11) % jm.cfg.vocab_size)
    want = np.asarray(jm.logits(jp, {"tokens": toks}))
    lay = JPagedLayout(jm, n_slots=B, num_pages=2, page_size=8, max_pages=1)
    pages, slots = jnp.zeros((B, 0), jnp.int32), jnp.arange(B)
    bt = jnp.zeros((B, 1), jnp.int32)
    logits, cache = lay.prefill_into(jp, lay.init_cache(),
                                     {"tokens": toks[:, :1]}, pages, slots)
    err = 0.0
    for t in range(1, 5):
        logits, cache = lay.decode_step(jp, cache, toks[:, t:t + 1],
                                        jnp.full((B,), t, jnp.int32), bt)
        err = max(err, float(np.abs(np.asarray(logits) - want[:, t]).max()))
    assert err > 1
    with pytest.raises((TypeError, ValueError)):
        lay.prefill_into(jp, lay.init_cache(), {"tokens": toks[:, :2]},
                         pages, slots)


# ---------------------------------------------------------------------------
# on the card: B5 at recurrentgemma's attention shape
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_flash_attention_at_hd256_g16_window_on_the_card():
    """B5 at recurrentgemma's local attention (one kv head, G 16, hd 256)
    with a 64-token window over 150 and 200 positions (the ring's wrap in
    the prefill), f32 (2e-5) and bf16 (3e-2), bitwise run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for S in (150, 200):
        for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q = torch.randn((2, S, 1, 16, 256), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((2, S, 1, 256), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((2, S, 1, 256), generator=gen,
                            device="cuda").to(dt)
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=True, window=WINDOW)
            again = flash_attention(q, k, v, causal=True, window=WINDOW)
            want = flash_attention_plain(q, k, v, causal=True, window=WINDOW)
            torch.cuda.synchronize()
            assert flash_attention.launches == before + 2
            assert torch.equal(got, again)
            err = float((got.float() - want.float()).abs().max())
            assert err <= atol, (S, dt, err)

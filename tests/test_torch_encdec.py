"""Port parity for the encdec family (whisper-large-v3: a bidirectional
encoder over stub frame embeddings, decoder blocks with cross-attention,
a plain GeLU MLP, sinusoidal absolute positions) against the JAX package
on the same numpy weights and inputs.

The reduced whisper (the reference's ``reduced``: d 256, 4 heads of 64,
MHA, layernorm, GeLU, a 2-layer encoder over 32 frames, a 2-layer
decoder) runs in f32.  Tolerances: the MLP atol 1e-5, sinusoidal
positions too, or two f32 ulps of the largest angle; loss and gradients rtol 1e-4 / atol 1e-5 (as
``tests/test_torch_mla.py``); the encoder output, logits and decode
logits atol 1e-4 (as ``tests/test_models.py``) with greedy tokens equal;
dc_s3gd steps each leaf's update within 1e-4 of its largest reference
magnitude, the metrics rtol 1e-5.  Within the port, bitwise (the
reference's pin, its cache docstring): the paged decode (the self part
paged, the encoder's xk / xv slot-indexed) is the dense one over bf16
and int8 pools.  The ``gpu`` tests hold B5 (bidirectional at S 1,500,
cross at Sq 64 over 1,500 keys, causal) and B4 at whisper-large-v3's
shapes against their plain versions on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save
from repro.configs import get_config, reduced
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.launch import train as j_train
from repro.launch.engine import Engine as JEngine
from repro.models import attention as j_attn
from repro.models import cache as jcache
from repro.models import layers as j_layers
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.models.transformer import stage_plan as j_stage_plan
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.checkpoint import restore_pytree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.launch.engine import Engine
from repro_torch.models import attention, layers
from repro_torch.models import cache as cache_mod
from repro_torch.models.cache import PagedLayout
from repro_torch.models.transformer import Model, stage_plan
from repro_torch.serve import Scheduler

from torch_multimodal import dense_trace, flash_atol, paged_trace
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-large-v3"
RTOL, ATOL = 1e-4, 1e-5
V, D, NF = 512, 256, 32
B, P, GEN, PS = 2, 8, 12, 8
MP = -(-(P + GEN + 1) // PS)


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JModel(reduced(get_config(ARCH)), remat=False)
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _models():
    jm = JModel(reduced(get_config(ARCH)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    return jm, Model(t_reduced(t_get_config(ARCH)), remat=False,
                     loss_chunk=16)


def _jp():
    return jax.tree.map(jnp.asarray, _weights())


def _tp():
    return params_from_numpy(_weights(), device="cpu")


def _inputs(n_text: int, seed: int = 0, labels: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, V, (B, n_text)).astype(np.int32),
         "frames": rng.standard_normal((B, NF, D)).astype(np.float32)}
    if labels:
        b["labels"] = rng.integers(0, V, (B, n_text)).astype(np.int32)
        b["labels"][:, -2:] = -1
    return b


def _j(batch):
    return jax.tree.map(jnp.asarray, batch)


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# config, weights and the pieces
# ---------------------------------------------------------------------------


def test_configs_and_stage_plan_match_reference():
    assert ARCH in T_ARCHS
    for cfg, jcfg in ((t_get_config(ARCH), get_config(ARCH)),
                      (t_reduced(t_get_config(ARCH)),
                       reduced(get_config(ARCH)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert [(s.kinds, s.repeats) for s in stage_plan(cfg)] == \
            [(s.kinds, s.repeats) for s in j_stage_plan(jcfg)]
    assert [s.kinds for s in stage_plan(t_get_config(ARCH))] == [("cross",)]
    enc = t_reduced(t_get_config(ARCH)).encoder
    assert (enc.n_layers, enc.n_frames) == (2, NF)


def test_full_param_count_matches_reference(monkeypatch):
    """whisper-large-v3 at its published widths: the reference's tree,
    shapes and count (1,601,459,200: 32 encoder and 32 decoder layers),
    on meta tensors."""
    shapes = jax.eval_shape(JModel(get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(shapes)]

    class MetaGen:
        device = torch.device("meta")
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    params = Model(t_get_config(ARCH)).init(MetaGen())
    got = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for x in T.leaves(params)]
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got) == 1_601_459_200


def test_params_have_the_reference_tree():
    got = Model(t_reduced(t_get_config(ARCH))).init(
        torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(_weights())[0]
    names = [jax.tree_util.keystr(p) for p, _ in want]
    for name in ("['encoder']['blocks']['attn']['wq']",
                 "['encoder']['final_norm']['bias']",
                 "['stage0']['b0']['ln_x']['scale']",
                 "['stage0']['b0']['xattn']['wk']"):
        assert name in names, name
    assert not any("w_gate" in n for n in names)
    assert len(T.leaves(got)) == len(want)
    for (path, a), t in zip(want, T.leaves(got)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), path
    assert "w_gate" not in got["stage0"]["b0"]["mlp"]


@pytest.mark.parametrize("n_pos,d", [(37, 256), (1500, 1280), (5, 2)])
def test_sinusoidal_positions_match_reference(n_pos, d):
    """The (n_pos, d) table, its denominator ``max(d // 2 - 1, 1)``, and
    the same rows at arbitrary positions (the decode's).  atol 1e-5, or
    two f32 ulps of the largest angle where that is more (2.4e-4 at
    1,500 positions: XLA's and torch's exp may part in the last bit of a
    frequency, and the angle carries it times the position)."""
    want = np.asarray(j_layers.sinusoidal_positions(n_pos, d))
    got = layers.sinusoidal_positions(n_pos, d)
    atol = max(1e-5, 2 * float(np.spacing(np.float32(n_pos))))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    rows = torch.tensor([[n_pos - 1], [0]])
    assert torch.equal(layers.sinusoidal(rows, d)[:, 0],
                       got[[n_pos - 1, 0]])


def test_plain_gelu_mlp_matches_reference():
    """The non-gated MLP, ``gelu(x @ w_up) @ w_down`` (tanh GeLU, as
    ``jax.nn.gelu``): no ``w_gate`` in either package's init."""
    p = jax.tree.map(np.asarray, j_layers.init_mlp(
        jax.random.PRNGKey(3), D, 512, False, jnp.float32))
    assert sorted(p) == ["w_down", "w_up"]
    x = np.random.default_rng(3).standard_normal((2, 5, D)).astype(np.float32)
    want = np.asarray(j_layers.mlp(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), "gelu"))
    got = layers.mlp(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                     "gelu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ours = layers.init_mlp(torch.Generator().manual_seed(0), (2,), D, 512,
                           False, torch.float32)
    assert sorted(ours) == ["w_down", "w_up"]


@pytest.mark.parametrize("core", ["plain", "flash"])
def test_encoder_output_matches_reference(core):
    """The encoder over 32 stub frames, bidirectional, through either
    attention core (the flash kernel's plain version on the CPU)."""
    jm, tm = _models()
    frames = _inputs(1)["frames"]
    want = np.asarray(jm._encoder_out(_jp(), jnp.asarray(frames)))
    got = tm._encoder_out(_tp(), torch.from_numpy(frames), core)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cross_decode_matches_reference():
    """One token's cross-attention over a static (B, 32, H, hd) encoder
    cache: no RoPE on q, every frame visible, nothing written."""
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     _weights()["stage0"]["b0"]["xattn"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    kv = {n: rng.standard_normal((B, NF, 4, 64)).astype(np.float32)
          for n in ("k", "v")}
    want, _ = j_attn.attention_decode(
        jax.tree.map(jnp.asarray, p), _j(kv), jnp.asarray(x),
        jnp.int32(9), rope_theta=0.0, cross=True)
    cache = _t(kv)
    before = {n: t.clone() for n, t in cache.items()}
    got, cache = attention.attention_decode(
        params_from_numpy(p, device="cpu"), cache, torch.from_numpy(x),
        torch.tensor(9), rope_theta=0.0, cross=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert all(torch.equal(cache[n], before[n]) for n in cache)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax():
    """Loss and gradients of 24 tokens over 32 frames (the encoder's
    weights included), and the whole-sequence logits."""
    jm, tm = _models()
    batch = _inputs(24, 0, labels=True)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(_jp(), _j(batch))
    tp = _tp()
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, _t(batch))
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    assert "['encoder']['blocks']['attn']['wq']" in paths
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    logits = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(jax.jit(jm.logits)(_jp(), _j(logits)))
    got = tm.logits(_tp(), _t(logits))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


def test_dc_s3gd_steps_match_jax():
    """Three dc_s3gd steps at W = 2, the port through the fused bucketed
    tail (A1/A2's plain versions here), the reference through its
    bucketed tail (its Pallas kernels in interpret mode take a second a
    step here), each worker's batch carrying its own frames: every leaf's
    update, m and delta_prev within 1e-4 of the leaf's largest reference
    magnitude (or one ulp of its largest weight), the metrics rtol
    1e-5."""
    jm, tm = _models()
    hp = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2,
              weight_decay=1e-3, total_steps=1)
    j_alg = jreg.make("dc_s3gd", JConfig(**hp), n_workers=2, buckets=2)
    t_alg = treg.make("dc_s3gd", TConfig(**hp), n_workers=2, buckets=2,
                      use_kernels=True)
    js = j_alg.init(_jp())
    ts = t_alg.init(_tp())
    step = jax.jit(functools.partial(j_alg.step, loss_fn=jm.loss))
    for t in range(3):
        per = [_inputs(16, 10 * t + w, labels=True) for w in range(2)]
        wb = {k: np.stack([b[k] for b in per]) for k in per[0]}
        js, jmet = step(js, _j(wb))
        ts, tmet = t_alg.step(ts, _t(wb), loss_fn=tm.loss)
        for k in ("loss", "lambda", "distance_norm", "delta_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    base = jax.tree.leaves(_weights())
    for what, ours, theirs, sub in (
            ("params", ts.params, js.params, base),
            ("m", ts.opt["m"], js.opt["m"], None),
            ("delta_prev", ts.comm["delta_prev"], js.comm["delta_prev"],
             None)):
        for i, (x, y) in enumerate(zip(T.leaves(ours),
                                       jax.tree.leaves(theirs))):
            x, y = x.numpy(), np.asarray(y)
            ulp = 0.0
            if sub is not None:
                x, y = x - sub[i], y - sub[i]
                ulp = float(np.spacing(np.abs(sub[i]).max()))
            np.testing.assert_allclose(
                x, y, rtol=0, atol=max(1e-4 * float(np.abs(y).max()), ulp),
                err_msg=f"{what} {i}")


def test_train_launcher_refuses_whisper_naming_the_frames():
    """The launchers' synthetic stream has no frames: the port refuses
    whisper before allocating, naming the missing input; the reference's
    launcher gets as far as its first step's ``Model.loss`` and raises
    ``KeyError('frames')`` there (ROADMAP queue C)."""
    argv = ["--arch", ARCH, "--reduced", "--workers", "2",
            "--batch-per-worker", "1", "--seq", "8", "--steps", "1"]
    with pytest.raises(ValueError, match="'frames'"):
        train.build(train.build_argparser().parse_args(argv +
                                                       ["--device", "cpu"]))
    with pytest.raises(KeyError, match="frames"):
        j_train.main(argv)


def test_reference_npz_restores_in_the_port(tmp_path):
    """A reference ``.npz`` of the reduced whisper (encoder blocks, ln_x,
    xattn) restores in the port bit for bit."""
    like = Model(t_reduced(t_get_config(ARCH))).init(
        torch.Generator().manual_seed(1))
    got = restore_pytree(j_save(tmp_path / "j.npz", _jp()), like)
    for a, b in zip(jax.tree.leaves(_weights()), T.leaves(got)):
        assert np.array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_forward_and_reference():
    """The prefill of 8 tokens over 32 frames (the cache holding the
    encoder's xk / xv) and decode steps with the sinusoidal row at each
    position, against the port's whole-sequence forward (1e-5) and,
    teacher-forced, the reference's decode (1e-4)."""
    jm, tm = _models()
    full = _inputs(P + GEN)
    want = tm.logits(_tp(), _t(full))
    pre = dict(full, tokens=full["tokens"][:, :P])
    cache_len = MP * PS
    tl, tc = tm.prefill(_tp(), _t(pre), cache_len=cache_len)
    jl, jc = jm.prefill(_jp(), _j(pre), cache_len=cache_len)
    for name in ("xk", "xv"):
        assert tuple(tc[0]["b0"][name].shape) == (2, B, NF, 4, 64)
        np.testing.assert_allclose(tc[0]["b0"][name].numpy(),
                                   np.asarray(jc[0]["b0"][name]), atol=1e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(tl.numpy(), want[:, P - 1].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jstep = jax.jit(jm.decode_step)
    for t in range(GEN):
        tok = full["tokens"][:, P + t:P + t + 1]
        tl, tc = tm.decode_step(_tp(), tc, {
            "tokens": torch.from_numpy(tok).long(),
            "pos": torch.tensor(P + t)})
        jl, jc = jstep(_jp(), jc, _j({"tokens": tok,
                                      "pos": np.int32(P + t)}))
        np.testing.assert_allclose(tl.numpy(), want[:, P + t].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {t}")


def test_oneshot_greedy_tokens_match_reference():
    """One-shot generation with ``extra_batch`` (the frames): the port's
    greedy tokens are the reference's `OneShotGenerator`'s."""
    jm, tm = _models()
    batch = _inputs(P, 3)
    want = np.asarray(JEngine(jm).generate(
        _jp(), jnp.asarray(batch["tokens"]), gen=GEN,
        extra_batch={"frames": jnp.asarray(batch["frames"])}))
    got = Engine(tm).generate(_tp(), torch.from_numpy(batch["tokens"]).long(),
                              gen=GEN, extra_batch={
                                  "frames": torch.from_numpy(
                                      batch["frames"])})
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_paged_decode_is_bitwise_the_dense_decode(pools):
    """12 greedy steps after 8 tokens over 32 frames: the paged decode
    (the self part in pages, the encoder's xk / xv slot-indexed at the
    compute dtype) is BITWISE the dense decode at matched linearized
    cache length: bf16 compute over bf16 pools against the dense cache at
    bf16, and f32 compute over int8 pools against a dense cache of the
    same dequantized self k / v."""
    _, tm = _models()
    if pools == "bfloat16":
        tm = Model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"))
    batch = _t(_inputs(P, 4))
    dense = dense_trace(tm, _tp(), batch, 0, GEN, MP * PS, pools)
    paged = paged_trace(tm, _tp(), batch, 0, GEN, PS, MP,
                        "int8" if pools == "int8" else None)
    for t, (a, b) in enumerate(zip(paged, dense)):
        assert torch.equal(a, b), f"step {t}"


def test_paged_pools_and_kinds_match_the_reference():
    """``cross`` is paged in both packages (its self part); the pools'
    tree, shapes and dtypes are the reference's (int8 pages with scales,
    xk / xv (n_slots, n_frames, H, hd) at the compute dtype) and so are
    the bytes a token costs; ``copy_page`` copies the pages and leaves
    the slot-indexed xk / xv alone."""
    jm, tm = _models()
    cfg, jcfg = t_get_config(ARCH), get_config(ARCH)
    assert cache_mod.resolved_window(cfg, "cross") \
        == jcache.resolved_window(jcfg, "cross") == 0
    assert cache_mod.paged_kinds(cfg, ("cross",)) \
        == jcache.paged_kinds(jcfg, ("cross",)) == ["cross"]
    kw = dict(n_slots=B, num_pages=5, page_size=PS, max_pages=2,
              kv_dtype="int8")
    ref = JPagedLayout(jm, **kw).init_cache()
    lay = PagedLayout(tm, **kw)
    got = lay.init_cache(device="cpu")
    assert sorted(got[0]["b0"]) == sorted(ref[0]["b0"]) == [
        "k", "k_scale", "v", "v_scale", "xk", "xv"]
    for name, a in ref[0]["b0"].items():
        t = got[0]["b0"][name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), name
    for kv_dtype in (None, "int8"):
        kw = dict(n_slots=16, num_pages=641, page_size=16, max_pages=640,
                  kv_dtype=kv_dtype)
        assert PagedLayout(Model(cfg), **kw).kv_bytes_per_token() \
            == JPagedLayout(JModel(jcfg), **kw).kv_bytes_per_token()
    c = got[0]["b0"]
    for t in c.values():
        t.normal_() if t.is_floating_point() else t.fill_(3)
    before = {n: t.clone() for n, t in c.items()}
    lay.copy_page(got, 1, 2)
    assert torch.equal(c["k"][:, 2], before["k"][:, 1])
    assert torch.equal(c["v_scale"][:, 2], before["v_scale"][:, 1])
    assert torch.equal(c["xk"], before["xk"])
    assert torch.equal(c["xv"], before["xv"])


def test_chunked_prefill_and_the_scheduler_refuse_encdec():
    """``chunkable`` is False in both packages, and both schedulers refuse
    an encoder-decoder (its prompts carry frames)."""
    jm, tm = _models()
    kw = dict(n_slots=2, num_pages=9, page_size=PS, max_pages=4)
    assert not PagedLayout(tm, **kw).chunkable
    assert not JPagedLayout(jm, **kw).chunkable
    with pytest.raises(NotImplementedError, match="text-only"):
        Scheduler(tm, _tp(), slots=2, pages=9, page_size=PS)
    with pytest.raises(NotImplementedError, match="text-only"):
        JScheduler(jm, _jp(), slots=2, pages=9, page_size=PS)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_at_whisper_shapes():
    """B5 at whisper-large-v3's (20 kv heads, G 1, hd 64): the encoder
    (bidirectional, S 1,500), the cross-attention (Sq 64 over 1,500 keys,
    the last key tile ragged) and the decoder's causal self-attention (S
    64), f32 and bf16 (`flash_atol`); B4 at hd 64, G 1 over bf16 and
    f32 pools within 1e-6 of its plain version in float64."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         paged_attention_plain)
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for sq, sk, causal in ((1500, 1500, False), (64, 1500, False),
                           (64, 64, True)):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((2, sq, 20, 1, 64), generator=g,
                            device=dev).to(dt)
            k = torch.randn((2, sk, 20, 64), generator=g, device=dev).to(dt)
            v = torch.randn((2, sk, 20, 64), generator=g, device=dev).to(dt)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            assert (float((got.float() - want.float()).abs().max())
                    <= flash_atol(dt, want))
    lengths = torch.tensor([1, 33, 64, 128], device=dev, dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 20, 1, 64), generator=g, device=dev)
        k = torch.randn((40, 16, 20, 64), generator=g, device=dev).to(dt)
        v = torch.randn((40, 16, 20, 64), generator=g, device=dev).to(dt)
        bt = (torch.randperm(39, generator=g, device=dev)[:4 * 8]
              + 1).reshape(4, 8).int()
        got = paged_attention(q, k, v, bt, lengths)
        want = paged_attention_plain(q.double(), k, v, bt, lengths)
        assert float((got.double() - want).abs().max()) <= 1e-6

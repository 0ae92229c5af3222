"""Port parity for the vlm family (qwen2-vl-7b: M-RoPE over a stub vision
tower) against the JAX package on the same numpy weights and inputs.

The reduced qwen2-vl (the reference's ``reduced``: d 256, 4 query heads
on 1 kv head, hd 64, M-RoPE sections (8, 12, 12), 8 patches) runs in f32.
The patches are a 2 x 4 grid: their M-RoPE positions are t = 0, h the
row and w the column, and the text after them runs from 4 in all three
components (Qwen2-VL's rule), so the three components differ and M-RoPE
is not plain RoPE (the tiled ``arange`` of the reference's tests makes
them equal).  Tolerances: M-RoPE atol 1e-5; loss and gradients rtol
1e-4 / atol 1e-5 (as ``tests/test_torch_mla.py``); logits atol 1e-4 (as
``tests/test_models.py``) with greedy tokens equal; dc_s3gd steps
through the fused tail: metrics rtol 1e-5 and each leaf's update within
1e-4 of the reference's largest (or one ulp of its largest weight), and
within 1e-6 of the per-leaf tail's.  Within the port, bitwise (the
reference's pin, its cache docstring): the paged decode is the dense one
over bf16 and int8 pools.  The ``gpu`` tests hold B5 and B4 at qwen2-vl-7b's shapes
against their plain versions on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import registry as jreg
from repro.core.types import DCS3GDConfig as JConfig
from repro.launch.engine import Engine as JEngine
from repro.models import layers as j_layers
from repro.models.cache import PagedLayout as JPagedLayout
from repro.models.transformer import Model as JModel
from repro.models.transformer import stage_plan as j_stage_plan
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train
from repro_torch.launch.engine import Engine
from repro_torch.models import layers
from repro_torch.models.cache import PagedLayout
from repro_torch.models.transformer import Model, stage_plan
from repro_torch.serve import Scheduler

from torch_multimodal import dense_trace, flash_atol, paged_trace
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-7b"
RTOL, ATOL = 1e-4, 1e-5
V, D, NP = 512, 256, 8
B, P, GEN, PS = 2, 8, 12, 8
MP = -(-(NP + P + GEN + 1) // PS)
METRICS = ("loss", "lambda", "distance_norm", "delta_norm")


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


def grid_positions(n_text: int, rows: int = 2, cols: int = 4) -> np.ndarray:
    """(3, rows * cols + n_text) M-RoPE positions: the patches t = 0, h
    the row, w the column; the text from max(rows, cols) on in all
    three."""
    n = rows * cols
    t = np.zeros(n)
    h = np.repeat(np.arange(rows), cols)
    w = np.tile(np.arange(cols), rows)
    text = max(rows, cols) + np.arange(n_text)
    return np.stack([np.concatenate([c, text]) for c in (t, h, w)]
                    ).astype(np.int32)


def _inputs(n_text: int, seed: int = 0, labels: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, V, (B, n_text)).astype(np.int32),
         "patches": rng.standard_normal((B, NP, D)).astype(np.float32),
         "mrope_positions": grid_positions(n_text)}
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
# config and weights
# ---------------------------------------------------------------------------


def test_configs_and_stage_plan_match_reference():
    assert ARCH in T_ARCHS
    for cfg, jcfg in ((t_get_config(ARCH), get_config(ARCH)),
                      (t_reduced(t_get_config(ARCH)),
                       reduced(get_config(ARCH)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert [(s.kinds, s.repeats) for s in stage_plan(cfg)] == \
            [(s.kinds, s.repeats) for s in j_stage_plan(jcfg)]
    cfg = t_reduced(t_get_config(ARCH))
    assert cfg.vlm.n_patches == NP and cfg.vlm.mrope_sections == (8, 12, 12)


def test_full_param_count_matches_reference(monkeypatch):
    """qwen2-vl-7b at its published widths: the reference's tree, shapes
    and count (7,628,332,544, 1,089,994,752 of them the embedding and
    unembedding), on meta tensors."""
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
    assert sum(int(np.prod(s)) for s, _ in got) == 7_628_332_544
    assert params["embed"]["tok"].numel() + params["unembed"].numel() \
        == 1_089_994_752


def test_params_have_the_reference_tree():
    got = Model(t_reduced(t_get_config(ARCH))).init(
        torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(_weights())[0]
    names = [jax.tree_util.keystr(p) for p, _ in want]
    assert "['vision_proj']" in names
    assert len(T.leaves(got)) == len(want)
    for (path, a), t in zip(want, T.leaves(got)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).replace("torch.", "") == str(a.dtype), path
    assert tuple(got["vision_proj"].shape) == (D, D)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


def test_apply_mrope_matches_reference_on_distinct_positions():
    """(3, S) positions whose t, h and w components differ (a 2 x 4 patch
    grid, then text): the port's rotation is the reference's within 1e-5,
    and more than 1e-2 from plain RoPE at the text's positions, so the
    check tells the two apart."""
    pos = grid_positions(5)
    x = np.random.default_rng(1).standard_normal(
        (B, pos.shape[1], 4, 64)).astype(np.float32)
    want = np.asarray(j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                           1e6, (8, 12, 12)))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, (8, 12, 12))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert len({tuple(c) for c in pos[:, :NP].tolist()}) == 3
    plain = layers.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(pos[0]).long(), 1e6)
    assert float((plain - got).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           (8, 12, 8))


@pytest.mark.parametrize("shape", ["dense (3, 1)", "paged (3, B, 1)"])
def test_apply_mrope_decode_shapes_match_reference(shape):
    """One token's rotation at decode: (3, 1) positions (every row at one
    position, the dense layout) and (3, B, 1) (a position per row, the
    paged layout), components distinct."""
    x = np.random.default_rng(2).standard_normal((B, 1, 4, 64)) \
        .astype(np.float32)
    pos = np.array([[7], [3], [5]], np.int32) if shape.startswith("dense") \
        else np.array([[[7], [9]], [[3], [2]], [[5], [11]]], np.int32)
    want = np.asarray(j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                           1e6, (8, 12, 12)))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, (8, 12, 12))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax():
    """Loss and gradients of 8 patches + 24 text tokens on distinct M-RoPE
    positions (the patches' labels -1), and the whole-sequence logits."""
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
    assert "['vision_proj']" in paths
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    logits = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(jax.jit(jm.logits)(_jp(), _j(logits)))
    got = tm.logits(_tp(), _t(logits))
    assert got.shape == (B, NP + 24, 512)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)


def test_dc_s3gd_steps_train_the_patch_projection():
    """The twin of the reference's ``test_smoke_forward_and_train_step``
    at W = 2, each worker's batch carrying its own patches and M-RoPE
    positions (sliced off the worker axis): three dc_s3gd steps through
    the fused bucketed tail (A1/A2's plain versions here) against the
    reference's jitted bucketed step on the same batches: the metrics
    rtol 1e-5, every leaf's update, m and delta_prev within 1e-4 of the
    leaf's largest reference magnitude (or one ulp of its largest
    weight), as ``tests/test_torch_encdec.py``'s trajectory.  λ > 0 once
    D is, and every leaf moves, ``vision_proj`` included.  The per-leaf
    tail gives each leaf's update within 1e-6 of the fused tail's."""
    jm, tm = _models()
    hp = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2,
              weight_decay=1e-3, total_steps=1)
    j_alg = jreg.make("dc_s3gd", JConfig(**hp), n_workers=2, buckets=2)
    js = j_alg.init(_jp())
    j_step = jax.jit(functools.partial(j_alg.step, loss_fn=jm.loss))
    runs = []
    for kw in (dict(buckets=2, use_kernels=True), dict()):
        alg = treg.make("dc_s3gd", TConfig(**hp), n_workers=2, **kw)
        state = alg.init(_tp())
        hist = []
        for t in range(3):
            per = [_inputs(16, 10 * t + w, labels=True) for w in range(2)]
            wb = {k: np.stack([b[k] for b in per]) for k in per[0]}
            state, met = alg.step(state, _t(wb), loss_fn=tm.loss)
            hist.append({k: float(met[k]) for k in METRICS})
            if not runs:
                js, jmet = j_step(js, _j(wb))
                for k in METRICS:
                    np.testing.assert_allclose(hist[-1][k], float(jmet[k]),
                                               rtol=1e-5, atol=1e-7,
                                               err_msg=k)
        runs.append((state, hist))
    (fused, hist), (leaf, _) = runs
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[0]["lambda"] == 0 and hist[-1]["lambda"] > 0
    base = jax.tree.leaves(_weights())
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(_weights())[0]]
    assert "['vision_proj']" in names
    for what, ours, theirs, sub in (
            ("params", fused.params, js.params, base),
            ("m", fused.opt["m"], js.opt["m"], None),
            ("delta_prev", fused.comm["delta_prev"], js.comm["delta_prev"],
             None)):
        for i, (x, y) in enumerate(zip(T.leaves(ours),
                                       jax.tree.leaves(theirs))):
            x, y = x.numpy(), np.asarray(y)
            ulp = 0.0
            if sub is not None:
                x, y = x - sub[i], y - sub[i]
                ulp = float(np.spacing(np.abs(sub[i]).max()))
                assert np.abs(x).max() > 0, names[i]
            np.testing.assert_allclose(
                x, y, rtol=0, atol=max(1e-4 * float(np.abs(y).max()), ulp),
                err_msg=f"{what} {names[i]}")
    for name, w0, a, b in zip(names, base, T.leaves(fused.params),
                              T.leaves(leaf.params)):
        du, dv = a.numpy() - w0[None], b.numpy() - w0[None]
        ulp = float(np.spacing(np.abs(w0).max()))
        np.testing.assert_allclose(du, dv, rtol=0,
                                   atol=max(1e-6 * np.abs(dv).max(), ulp),
                                   err_msg=name)


def test_train_launcher_trains_on_the_token_stream():
    """The launcher's synthetic stream has no patches: qwen2-vl trains as
    a text model (plain RoPE), as the reference's launcher does."""
    args = train.build_argparser().parse_args([
        "--arch", ARCH, "--reduced", "--workers", "2", "--batch-per-worker",
        "1", "--seq", "8", "--steps", "2", "--buckets", "2", "--use-kernels",
        "--log-every", "1", "--device", "cpu"])
    out = train.run(args)
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_forward_and_reference():
    """The prefill of 8 patches + 8 tokens and a decode step at M-RoPE
    positions (3, 1) against the port's whole-sequence forward (1e-5),
    then teacher-forced decode steps against the reference's (1e-4)."""
    jm, tm = _models()
    full = _inputs(P + GEN)
    want = tm.logits(_tp(), _t(full))
    pre = dict(full, tokens=full["tokens"][:, :P],
               mrope_positions=full["mrope_positions"][:, :NP + P])
    cache_len = MP * PS
    tl, tc = tm.prefill(_tp(), _t(pre), cache_len=cache_len)
    jl, jc = jm.prefill(_jp(), _j(pre), cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), want[:, NP + P - 1].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    jstep = jax.jit(jm.decode_step)
    for t in range(GEN):
        tok = full["tokens"][:, P + t:P + t + 1]
        mp = full["mrope_positions"][:, NP + P + t:NP + P + t + 1]
        batch = {"tokens": tok, "pos": np.int32(NP + P + t),
                 "mrope_positions": mp}
        tl, tc = tm.decode_step(_tp(), tc, {
            "tokens": torch.from_numpy(tok).long(),
            "pos": torch.tensor(NP + P + t),
            "mrope_positions": torch.from_numpy(mp).long()})
        jl, jc = jstep(_jp(), jc, _j(batch))
        np.testing.assert_allclose(tl.numpy(), want[:, NP + P + t].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {t}")


def test_oneshot_greedy_tokens_match_reference():
    """One-shot generation with ``extra_batch`` (patches and the tiled
    M-RoPE positions, as the launchers draw them): the port's greedy
    tokens are the reference's `OneShotGenerator`'s."""
    jm, tm = _models()
    batch = _inputs(P, 3)
    batch["mrope_positions"] = np.tile(np.arange(NP + P)[None], (3, 1)) \
        .astype(np.int32)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    want = np.asarray(JEngine(jm).generate(
        _jp(), jnp.asarray(batch["tokens"]), gen=GEN, extra_batch=_j(extra)))
    got = Engine(tm).generate(_tp(), torch.from_numpy(batch["tokens"]).long(),
                              gen=GEN, extra_batch=_t(extra))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_paged_decode_is_bitwise_the_dense_decode(pools):
    """12 greedy steps after 8 patches + 8 tokens: the paged decode's
    logits (M-RoPE positions (3, B, 1)) are BITWISE the dense decode's
    ((3, 1)) at matched linearized cache length: bf16 compute over bf16
    pools against the dense cache at bf16, and f32 compute over int8
    pools against a dense cache of the same dequantized k / v."""
    _, tm = _models()
    if pools == "bfloat16":
        tm = Model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"))
    batch = _t(_inputs(P, 4))
    dense = dense_trace(tm, _tp(), batch, NP, GEN, MP * PS, pools)
    paged = paged_trace(tm, _tp(), batch, NP, GEN, PS, MP,
                        "int8" if pools == "int8" else None)
    for t, (a, b) in enumerate(zip(paged, dense)):
        assert torch.equal(a, b), f"step {t}"


def test_prefill_into_needs_pages_for_the_patches():
    """The prompt is 8 patches + 8 tokens: pages that cover only the
    tokens are refused with a message, where the reference (which sizes
    its cache from the tokens alone) fails inside ``jnp.pad``; pages
    covering both work in both packages."""
    jm, tm = _models()
    batch = _inputs(P, 5)
    lay = PagedLayout(tm, n_slots=B, num_pages=2 * MP + 1, page_size=PS,
                      max_pages=MP)
    pages = torch.arange(1, 2 * MP + 1).reshape(B, MP)
    with pytest.raises(ValueError, match="fewer than the prompt's 16"):
        lay.prefill_into(_tp(), lay.init_cache(device="cpu"), _t(batch),
                         pages[:, :1], torch.arange(B))
    jl_ = JPagedLayout(jm, n_slots=B, num_pages=2 * MP + 1, page_size=PS,
                       max_pages=MP)
    with pytest.raises(ValueError):
        jl_.prefill_into(_jp(), jl_.init_cache(), _j(batch),
                         jnp.asarray(pages[:, :1].numpy()), jnp.arange(B))
    tl, _ = lay.prefill_into(_tp(), lay.init_cache(device="cpu"), _t(batch),
                             pages[:, :2], torch.arange(B))
    jl, _ = jl_.prefill_into(_jp(), jl_.init_cache(), _j(batch),
                             jnp.asarray(pages[:, :2].numpy()),
                             jnp.arange(B))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_chunked_prefill_and_the_scheduler_refuse_vlm():
    """``chunkable`` is False in both packages, and both schedulers refuse
    a VLM (its prompts carry patches)."""
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
def test_cuda_kernels_at_qwen2_vl_shapes():
    """B5 causal at qwen2-vl-7b's prefill (4 kv heads, G 7, hd 128, 1,024
    patches + 128 tokens), f32 and bf16 (`flash_atol`), and B4 at G 7
    over bf16 and f32 pools within 1e-6 of its plain version in float64."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import (flash_attention_plain,
                                         paged_attention_plain)
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 1152, 4, 7, 128), generator=g, device=dev).to(dt)
        k = torch.randn((1, 1152, 4, 128), generator=g, device=dev).to(dt)
        v = torch.randn((1, 1152, 4, 128), generator=g, device=dev).to(dt)
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        assert (float((got.float() - want.float()).abs().max())
                <= flash_atol(dt, want))
    lengths = torch.tensor([1, 300, 1153, 1184], device=dev,
                           dtype=torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 4, 7, 128), generator=g, device=dev)
        k = torch.randn((300, 16, 4, 128), generator=g, device=dev).to(dt)
        v = torch.randn((300, 16, 4, 128), generator=g, device=dev).to(dt)
        bt = (torch.randperm(299, generator=g, device=dev)[:4 * 74]
              + 1).reshape(4, 74).int()
        got = paged_attention(q, k, v, bt, lengths)
        want = paged_attention_plain(q.double(), k, v, bt, lengths)
        assert float((got.double() - want).abs().max()) <= 1e-6

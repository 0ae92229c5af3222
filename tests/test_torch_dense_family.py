"""Port parity for the rest of the dense family: layernorm, and stablelm-3b
(layernorm, hd 80, 32 kv heads) and granite-20b (MQA: one kv head; G 4 at
the reduced size) against the JAX reference on the same numpy weights.

Tolerances (f32, reduced configs): layernorm rtol 1e-6 / atol 1e-6 (f32,
one reduction order apart); loss and gradients rtol 1e-4 / atol 1e-5 (as
``tests/test_torch_model.py``: f32 sums in other orders); prefill logits
atol 1e-4; greedy serving tokens exactly, whole-prompt and chunked; one
fused, bucketed dc_s3gd run (the layernorm biases in the buckets) within
1e-4 of each leaf's largest reference magnitude, as
``tests/test_torch_dc_s3gd.py``.  The full configs' parameter counts are
the reference's.  The ``gpu`` tests hold B4 and B5 at hd 80, G 48 and a
query offset against their plain versions on the card.
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
from repro.data import SyntheticLMDataset as JData
from repro.data import worker_batches as j_worker_batches
from repro.models.layers import layernorm as j_layernorm
from repro.models.transformer import Model as JModel
from repro.optim.local import _decay_mask as j_decay_mask
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import registry as treg
from repro_torch.core.types import DCS3GDConfig as TConfig
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.data.pipeline import worker_batches as t_worker_batches
from repro_torch.interop import params_from_numpy
from repro_torch.models.layers import init_layernorm, layernorm
from repro_torch.models.transformer import Model as TModel
from repro_torch.optim.local import _decay_mask as t_decay_mask
from repro_torch.serve import Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = pytest.mark.parametrize("arch", ["stablelm-3b", "granite-20b"])
RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = reduced(get_config(arch))
    return jax.tree.map(np.asarray,
                        JModel(cfg, remat=False).init(jax.random.PRNGKey(0)))


def _models(arch):
    jm = JModel(reduced(get_config(arch)), remat=False, q_chunk=16,
                kv_chunk=16, scan_chunk=16, loss_chunk=16)
    tm = TModel(t_reduced(t_get_config(arch)), loss_chunk=16)
    return jm, tm


def _batch(vocab, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[:, -2:] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 80)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(80).astype(np.float32)
    bias = rng.standard_normal(80).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    want = j_layernorm({"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}, jx, 1e-5)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    got = layernorm({"scale": torch.from_numpy(scale),
                     "bias": torch.from_numpy(bias)}, tx)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == np.float32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    p = init_layernorm((4, 80), torch.float32, "cpu")
    assert torch.equal(p["scale"], torch.ones(4, 80))
    assert torch.equal(p["bias"], torch.zeros(4, 80))


@ARCHS
def test_configs_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(t_get_config(arch))


@ARCHS
def test_full_param_count_matches_reference(arch, monkeypatch):
    """The full config's tree, shapes and count, without allocating it:
    the port's init runs on meta tensors."""
    jm = JModel(get_config(arch))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    want = [tuple(x.shape) for x in jax.tree.leaves(shapes)]

    class MetaGen:
        device = torch.device("meta")
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: torch.empty(shape, device="meta"))
    params = TModel(t_get_config(arch)).init(MetaGen())
    got = [tuple(x.shape) for x in T.leaves(params)]
    assert got == want
    n = sum(int(np.prod(s)) for s in got)
    assert n == {"stablelm-3b": 2_796_098_560,
                 "granite-20b": 28_167_493_632}[arch]


@ARCHS
def test_loss_and_grads_match_jax(arch):
    np_params = _weights(arch)
    jm, tm = _models(arch)
    batch = _batch(tm.cfg.vocab_size)
    j_loss, j_grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, batch))
    tp = params_from_numpy(np_params, device="cpu")
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, params_from_numpy(batch, device="cpu"))
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for a, b in zip(t_grads, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@ARCHS
def test_prefill_logits_match_jax(arch):
    np_params = _weights(arch)
    jm, tm = _models(arch)
    toks = _batch(tm.cfg.vocab_size, S=21)["tokens"]
    jl, _ = jm.prefill(jax.tree.map(jnp.asarray, np_params),
                       {"tokens": jnp.asarray(toks)}, cache_len=32)
    tl, _ = tm.prefill(params_from_numpy(np_params, device="cpu"),
                       {"tokens": torch.from_numpy(toks).long()},
                       cache_len=32)
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(tl[:, :V].numpy(), np.asarray(jl)[:, :V],
                               rtol=0, atol=1e-4)


@ARCHS
@pytest.mark.parametrize("chunk", [0, 16])
def test_greedy_serving_matches_jax(arch, chunk):
    """The same requests through both packages' schedulers, whole-prompt
    (chunk 0) and in chunks of 16: equal greedy tokens."""
    np_params = _weights(arch)
    jm, tm = _models(arch)
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, tm.cfg.vocab_size, n).tolist(), g)
             for n, g in ((11, 5), (30, 7), (19, 4))]
    out = []
    for sched, req, m, p in (
            (Scheduler, Request, tm, params_from_numpy(np_params,
                                                       device="cpu")),
            (JScheduler, JRequest, jm, jax.tree.map(jnp.asarray,
                                                    np_params))):
        sch = sched(m, p, slots=2, pages=24, page_size=8, max_len=64,
                    prefill_chunk=chunk)
        done = sch.run([req(rid=i, prompt=list(pr), max_new=g)
                        for i, (pr, g) in enumerate(specs)])
        out.append({r.rid: list(r.out) for r in done})
    assert out[0] == out[1]
    assert all(len(out[0][i]) == g for i, (_, g) in enumerate(specs))


def test_decay_mask_of_layernorm_biases_matches_reference():
    """Stacked (L, d) ln biases are decayed and ``final_norm``'s (d,) bias
    is not, in both packages (rank judged per worker)."""
    np_params = _weights("stablelm-3b")
    stacked = jax.tree.map(lambda a: np.stack([a, a]), np_params)
    want = jax.tree.leaves(j_decay_mask(jax.tree.map(jnp.asarray, stacked),
                                        axis0_is_worker=True))
    got = T.leaves(t_decay_mask(params_from_numpy(stacked, device="cpu"),
                                axis0_is_worker=True))
    assert [float(x) for x in got] == [float(x) for x in want]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(np_params)[0]]
    decay = dict(zip(paths, got))
    assert decay["['final_norm']['bias']"] == 0.0
    assert decay["['stage0']['b0']['ln1']['bias']"] == 1.0


def test_fused_bucketed_dc_s3gd_with_layernorm_biases_matches_jax():
    """Three fused, bucketed dc_s3gd steps at W = 2 on reduced stablelm-3b
    (the reference's Pallas kernels in interpret mode): the layernorm
    biases ride the buckets through A1/A2's plain versions."""
    arch, W, steps = "stablelm-3b", 2, 3
    hp = dict(learning_rate=0.05, momentum=0.9, lambda0=0.2,
              weight_decay=1e-3, total_steps=1)
    jm, tm = _models(arch)
    jalg = jreg.make("dc_s3gd", JConfig(**hp), n_workers=W, buckets=2,
                     use_kernels=True)
    jstep = jax.jit(functools.partial(jalg.step, loss_fn=jm.loss))
    jstate = jalg.init(jax.tree.map(jnp.asarray, _weights(arch)))
    jdata = JData(tm.cfg.vocab_size, 16, seed=0)
    talg = treg.make("dc_s3gd", TConfig(**hp), n_workers=W, buckets=2,
                     use_kernels=True)
    tstate = talg.init(params_from_numpy(_weights(arch), device="cpu"))
    tdata = TData(tm.cfg.vocab_size, 16, seed=0)
    for t in range(steps):
        jstate, jm_ = jstep(jstate, j_worker_batches(jdata, t, W, 2))
        tstate, tm_ = talg.step(tstate, t_worker_batches(
            tdata, t, W, 2, device="cpu"), loss_fn=tm.loss)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    assert float(tm_["lambda"]) > 0
    base = jax.tree.leaves(_weights(arch))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(_weights(arch))[0]]
    for path, x, y, z in zip(paths, T.leaves(tstate.params),
                             jax.tree.leaves(jstate.params), base):
        x, y = x.numpy() - z, np.asarray(y) - z
        np.testing.assert_allclose(x, y, rtol=0,
                                   atol=1e-4 * float(np.abs(y).max()),
                                   err_msg=path)
        if path.endswith("['bias']"):
            assert np.abs(y).max() > 0, f"{path} never moved"


# ---------------------------------------------------------------------------
# on the card: B4 and B5 at the new shapes
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_flash_attention_new_shapes():
    """B5 at hd 80 (stablelm), G 48 with one kv head (granite) and a query
    offset (a chunk), f32 (atol 2e-5) and bf16 (3e-2), against its plain
    version; rows bitwise independent of where their chunk starts."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for (KV, G, hd), sq, sk, q0 in (((32, 1, 80), 200, 200, 0),
                                    ((1, 48, 128), 150, 150, 0),
                                    ((8, 2, 128), 128, 656, 512),
                                    ((4, 1, 80), 77, 333, 250)):
        for dt, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q = torch.randn((1, sq, KV, G, hd), generator=g,
                            device=dev).to(dt)
            k = torch.randn((1, sk, KV, hd), generator=g, device=dev).to(dt)
            v = torch.randn((1, sk, KV, hd), generator=g, device=dev).to(dt)
            got = flash_attention(q, k, v, q_start=q0)
            want = flash_attention_plain(q, k, v, q_start=q0)
            assert float((got.float() - want.float()).abs().max()) <= atol
            if q0:
                a = flash_attention(q[:, :50].contiguous(), k, v,
                                    q_start=q0)
                b = flash_attention(q[:, 50:].contiguous(), k, v,
                                    q_start=q0 + 50)
                assert torch.equal(got, torch.cat([a, b], dim=1))


@pytest.mark.gpu
def test_cuda_paged_attention_new_shapes():
    """B4 at hd 80 with G 1 and at hd 128 with G 48 (one kv head), bf16 and
    f32 pools, within 1e-6 of its plain version evaluated in float64."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_plain
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.tensor([1, 17, 200, 333], device=dev, dtype=torch.int32)
    for KV, G, hd in ((32, 1, 80), (1, 48, 128)):
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn((4, KV, G, hd), generator=g, device=dev)
            # 4 rows of 21 distinct pages (333 tokens), page 0 the scratch
            k = torch.randn((96, 16, KV, hd), generator=g, device=dev).to(dt)
            v = torch.randn((96, 16, KV, hd), generator=g, device=dev).to(dt)
            bt = (torch.randperm(95, generator=g, device=dev)[:4 * 21]
                  + 1).reshape(4, 21).int()
            got = paged_attention(q, k, v, bt, lengths)
            # a float64 q: the plain version evaluates in float64
            want = paged_attention_plain(q.double(), k, v, bt, lengths)
            assert float((got.double() - want).abs().max()) <= 1e-6

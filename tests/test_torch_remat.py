"""The Model's memory knobs against the JAX package and within the port:
per-unit ``remat``, the plain route's blocked attention at
``q_chunk`` / ``kv_chunk``, the checkpointed ``chunked_xent`` and
``seq_parallel`` over 'model'.

* Against the reference (its ``Model(remat=True, q_chunk=8,
  kv_chunk=8)``) at S = 32, so every attention runs over 4 x 4 blocks:
  the loss and every gradient for the dense, windowed, MLA, encoder
  (whisper) and MoE families, at the parity tests' tolerance, rtol 1e-4
  / atol 1e-5 (``tests/test_torch_mla.py``), on the same numpy weights.
* Within the port, bitwise: ``remat`` on == off in one process for the
  same families, and over a (1, 2) mesh of gloo ranks ``remat`` on ==
  off and ``seq_parallel`` on == off (each rank's loss and gradients of
  its shards).
* The memory: a `MemTracker` peak with ``remat`` at most two thirds of
  the peak without, on real CPU tensors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch.dryrun import traced_peak
from repro_torch.models.transformer import Model

import torch_mesh_worker as MW
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, S, CHUNK = 2, 32, 8
# family -> (arch, config overrides)
FAMILIES = {"dense": ("qwen3-0.6b", {}),
            "windowed": ("qwen3-0.6b", {"sliding_window": 12}),
            "mla": ("minicpm3-4b", {}),
            "encoder": ("whisper-large-v3", {}),
            "moe": ("olmoe-1b-7b", {})}


def _cfgs(family):
    arch, over = FAMILIES[family]
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **over),
            dataclasses.replace(reduced(get_config(arch)), **over))


@functools.lru_cache(maxsize=None)
def _weights(family):
    jcfg, _ = _cfgs(family)
    jm = JModel(jcfg, remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    batch["labels"][:, -3:] = -1
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(model, weights, batch):
    leaves = [x.requires_grad_() for x in T.leaves(
        params_from_numpy(weights, device="cpu"))]
    tree = T.unflatten(T.flatten(params_from_numpy(weights,
                                                   device="cpu"))[1],
                       leaves)
    loss = model.loss(tree, params_from_numpy(batch, device="cpu"))
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax_at_multi_block_chunks(family):
    jcfg, cfg = _cfgs(family)
    batch = _batch(cfg)
    jm = JModel(jcfg, remat=True, q_chunk=CHUNK, kv_chunk=CHUNK,
                scan_chunk=CHUNK, loss_chunk=16)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss))(
        jax.tree.map(jnp.asarray, _weights(family)),
        jax.tree.map(jnp.asarray, batch))
    model = Model(cfg, remat=True, q_chunk=CHUNK, kv_chunk=CHUNK,
                  scan_chunk=CHUNK, loss_chunk=16)
    t_loss, t_grads = _port_grads(model, _weights(family), batch)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(j_grads)[0]]
    for path, a, b in zip(paths, t_grads, jax.tree.leaves(j_grads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_on_is_off_bitwise(family):
    """Per-unit remat (and the checkpointed loss chunks, on in both)
    change what is kept for the backward pass, not one bit of the loss
    or the gradients."""
    _, cfg = _cfgs(family)
    batch = _batch(cfg, seed=1)
    got = {}
    for remat in (False, True):
        model = Model(cfg, remat=remat, q_chunk=CHUNK, kv_chunk=CHUNK,
                      loss_chunk=16)
        got[remat] = _port_grads(model, _weights(family), batch)
    assert torch.equal(got[False][0], got[True][0])
    for a, b in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b)


def test_remat_over_model_and_seq_parallel_are_bitwise(tmp_path):
    """On a (1, 2) mesh of gloo ranks each rank's loss and gradients of
    its shards are the same bits with ``remat`` on and off, and with
    ``seq_parallel`` on and off (the stream between units the rank's 16
    of the 32 positions, gathered inside each unit)."""
    res = MW.spawn(2, "remat", {"names": ["qwen3", "qwen3_window",
                                          "minicpm", "whisper", "olmoe"],
                                "seq": S, "chunk": CHUNK},
                   tmp_path, module="torch_tp_worker")
    for rank, r in enumerate(res):
        for name, variants in r.items():
            assert len(set(variants.values())) == 1, (rank, name, variants)
            assert len(variants) == 4


def test_remat_peak_is_two_thirds_of_the_peak_without_or_less():
    """The reduced qwen3 at 4 layers, 2 x 256 tokens in blocks of 32: a
    `MemTracker` over one loss-and-gradient call on real CPU tensors
    (the dry-run's `traced_peak`).  Without remat every layer's live
    blocks of scores stay alive until the backward pass; with it only
    each unit's input and one unit's recompute.  Measured 81,794,056 B
    against 40,787,976 B, 2.01x (torch 2.13, CPU); held to 1.5x."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), n_layers=4)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    batch = {"tokens": tokens, "labels": tokens}
    peaks = {}
    for remat in (False, True):
        model = Model(cfg, remat=remat, q_chunk=32, kv_chunk=32,
                      loss_chunk=256)
        params = model.init(torch.Generator().manual_seed(0))
        leaves = [x.requires_grad_() for x in T.leaves(params)]
        tree = T.unflatten(T.flatten(params)[1], leaves)

        def step():
            return torch.autograd.grad(model.loss(tree, batch), leaves)
        _, peaks[remat] = traced_peak(step, (tree, batch))
    assert peaks[True] * 1.5 < peaks[False], peaks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 12])
def test_skipped_blocks_change_no_bit(dtype, window):
    """``blocked_attention(ordered=True)`` (the training stream's
    positions 0 .. S - 1) skips the key blocks wholly masked for a query
    chunk: its output and the gradients of q, k and v are the bits of the
    run that visits every block (37 positions, blocks of 8 x 16)."""
    from repro_torch.models.attention import blocked_attention
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(dt).requires_grad_()
               for shape in ((2, 37, 2, 2, 16), (2, 37, 2, 16),
                             (2, 37, 2, 16)))
    g = torch.randn(2, 37, 2, 2, 16, generator=gen).to(dt)
    pos = torch.arange(37)
    got = []
    for ordered in (False, True):
        out = blocked_attention(q, k, v, pos, pos, causal=True,
                                window=window, q_chunk=8, kv_chunk=16,
                                ordered=ordered)
        got.append((out, *torch.autograd.grad(out, (q, k, v), g)))
    for a, b in zip(*got):
        assert torch.equal(a, b)

"""Port parity: the dense transformer's loss and gradients against the JAX
reference, on the same weights and batch (reduced qwen3-0.6b, f32).

Tolerance: rtol 1e-4 / atol 1e-5 on the loss and on every gradient leaf.
The two frameworks take f32 sums in different orders, and the reference
streams attention through an online softmax where the port takes one
softmax over the sequence.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models.transformer import Model as JModel
from repro_torch import tree as T
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import Model as TModel

RTOL, ATOL = 1e-4, 1e-5


def _weights(cfg, seed=0):
    params = JModel(cfg, remat=False).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _batch(vocab, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels[:, -2:] = -1  # masked positions
    return {"tokens": tokens, "labels": labels}


def test_reduced_configs_agree():
    j = reduced(get_config("qwen3-0.6b"))
    t = t_reduced(t_get_config("qwen3-0.6b"))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(get_config("qwen3-0.6b")) == \
        dataclasses.asdict(t_get_config("qwen3-0.6b"))


def test_init_tree_matches_reference_layout():
    cfg = t_reduced(t_get_config("qwen3-0.6b"))
    tp = TModel(cfg).init(torch.Generator().manual_seed(0))
    jp = _weights(reduced(get_config("qwen3-0.6b")))
    j_leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    t_leaves = T.leaves(tp)
    assert len(j_leaves) == len(t_leaves) == 14
    for (path, a), b in zip(j_leaves, t_leaves):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


@pytest.mark.parametrize("seq", [16, 40])
def test_loss_and_grads_match_jax(seq):
    jcfg = reduced(get_config("qwen3-0.6b"))
    np_params = _weights(jcfg)
    batch = _batch(jcfg.vocab_size, S=seq)
    # loss_chunk 32 < 40: the chunked cross-entropy crosses a chunk edge
    jm = JModel(jcfg, remat=False, loss_chunk=32)
    j_loss, j_grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jax.numpy.asarray, np_params),
        jax.tree.map(jax.numpy.asarray, batch))

    tm = TModel(t_reduced(t_get_config("qwen3-0.6b")), loss_chunk=32)
    tp = params_from_numpy(np_params, device="cpu")
    leaves = T.leaves(tp)
    for x in leaves:
        x.requires_grad_()
    t_loss = tm.loss(tp, params_from_numpy(batch, device="cpu"))
    t_grads = torch.autograd.grad(t_loss, leaves)

    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(jax.tree.leaves(j_grads), t_grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


def test_bf16_compute_promotes_like_jnp():
    """compute_dtype bf16 with f32 weights: the embedding and the first
    norm round to bf16, every product promotes to f32 (jnp's rule), so the
    loss is f32 and close to the f32-compute loss."""
    cfg = t_reduced(t_get_config("qwen3-0.6b"))
    tp = TModel(cfg).init(torch.Generator().manual_seed(0))
    batch = params_from_numpy(_batch(cfg.vocab_size), device="cpu")
    f32 = TModel(cfg).loss(tp, batch)
    bf16 = TModel(dataclasses.replace(cfg, compute_dtype="bfloat16")
                  ).loss(tp, batch)
    assert bf16.dtype == torch.float32
    np.testing.assert_allclose(bf16.item(), f32.item(), rtol=1e-2)


def test_interop_round_trip_is_bitwise():
    np_params = _weights(reduced(get_config("qwen3-0.6b")))
    np_params["bf16"] = np.asarray(
        jax.numpy.arange(7, dtype=jax.numpy.bfloat16))
    back = params_to_numpy(params_from_numpy(np_params, device="cpu"))
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

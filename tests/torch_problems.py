"""A least-squares problem made in numpy, run through both packages: the
model-free probe of the parity tests for the pipeline, elastic membership
and checkpoints.  Two leaves (a vector and a matrix, so the bucket plan
has a decay and a no-decay group), per-worker batches drawn from
(seed, step, worker) alone, so any worker count takes the first rows of a
larger draw."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.api import TrainState as JState
from repro_torch import tree as T
from repro_torch.interop import params_from_numpy

N, BS = 8, 8


def init():
    return {"w": np.zeros(N, np.float32), "mat": np.zeros((N, N), np.float32)}


def batch(step: int, n_workers: int, seed: int = 3) -> dict:
    w_star = np.random.default_rng(seed).standard_normal(N) \
        .astype(np.float32)
    A = np.stack([np.random.default_rng((seed, step, w))
                  .standard_normal((BS, N)) / np.sqrt(N)
                  for w in range(n_workers)]).astype(np.float32)
    return {"A": A, "y": A @ w_star}


def j_loss(p, b):
    pred = b["A"] @ (p["w"] + p["mat"].sum(0) * 0.01)
    return 0.5 * jnp.mean((pred - b["y"]) ** 2)


def t_loss(p, b):
    pred = b["A"] @ (p["w"] + p["mat"].sum(0) * 0.01)
    return 0.5 * ((pred - b["y"]) ** 2).mean()


def t_batch(step: int, n_workers: int) -> dict:
    return params_from_numpy(batch(step, n_workers), device="cpu")


def j_batch(step: int, n_workers: int) -> dict:
    return jax.tree.map(jnp.asarray, batch(step, n_workers))


class Model:
    """The Engine's model seam (``.loss``) for either package."""

    cfg = None

    def __init__(self, loss_fn):
        self.loss = loss_fn


def to_numpy(tree):
    """A state tree of the port as numpy (host ints as int32 arrays)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().numpy()
        return np.asarray(x, np.int32) if isinstance(x, int) \
            else np.asarray(x)
    return T.map(conv, tree)


def to_jax(state) -> JState:
    """A port `TrainState` as the reference's."""
    return JState(*(jax.tree.map(jnp.asarray, x) for x in to_numpy(state)))


def bitwise(a, b) -> bool:
    """Two trees of tensors (or numpy arrays) equal bit for bit."""
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor)
         else np.array_equal(np.asarray(x), np.asarray(y)))
        for x, y in zip(la, lb))

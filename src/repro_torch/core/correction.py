"""Delay compensation (paper Eq. 6/10/17).

    c_i = g_i ⊙ g_i ⊙ D_i                   (Eq. 4 pseudo-Hessian · distance)
    λ_i = λ0 · ‖g_i‖ / ‖c_i‖               (Eq. 17 variance control)
    g̃_i = g_i + λ_i · c_i                   (Eq. 10)

Norms are global over the whole gradient tree (``mode='global'``) or per
tensor (``mode='per_tensor'``), per worker when the tree carries a
leading worker axis.  All arithmetic is f32.  The fused path
(``use_kernels=True``, global mode) computes the same thing through
`repro_torch.kernels.ops.dc_norms_*` and ``dc_fused_update_*``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.parallel.tensor import sum_parts

Tree = Any
EPS = 1e-30


def worker_sq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over every axis but the leading (worker) one, in
    f32: (W,).  A (W,) leaf (a 0-d parameter per worker) is its own
    square — torch would sum over every axis for an empty axis list,
    which would mix the workers."""
    x = x.float()
    if x.dim() == 1:
        return x.square()
    return x.square().sum(dim=tuple(range(1, x.dim())))


def _sq_sum(x: torch.Tensor, axis0_is_worker: bool) -> torch.Tensor:
    """A leaf's sum of squares: per worker (W,), or a scalar."""
    return worker_sq_sum(x) if axis0_is_worker \
        else x.float().square().sum()


def dc_correct(grads: Tree, distance: Tree, lambda0: float, *,
               mode: str = "global", axis0_is_worker: bool = False,
               sum_sq=None, leaf_sums=None) -> Tuple[Tree, Any]:
    """Returns (corrected grads g̃, λ used): a scalar or (W,) for
    'global', a tree of per-leaf λ for 'per_tensor' ((W, 1, ...) per leaf
    under ``axis0_is_worker``).  Under tensor parallelism the caller
    passes the helpers that sum the model-sharded leaves' partials over
    the mesh's 'model' axis: ``sum_sq`` (global mode) adds up the
    per-leaf ``(‖g‖², ‖c‖²)`` pairs (`repro_torch.parallel.tensor.
    sum_parts`), ``leaf_sums`` (per-tensor mode) takes the per-leaf
    stacked pairs and returns each leaf's own sum
    (`repro_torch.parallel.tensor.sum_each`, one collective); left out,
    the leaves are whole."""
    if mode not in ("global", "per_tensor"):
        raise ValueError(f"lambda_norm={mode!r}: 'global' or 'per_tensor'")
    first = T.leaves(grads)[0]
    if lambda0 == 0.0:
        shape = (first.shape[0],) if axis0_is_worker else ()
        return grads, torch.zeros(shape, dtype=torch.float32,
                                  device=first.device)

    c = T.map(lambda g, d: g.float() ** 2 * d.float(), grads, distance)

    def lam_of(gsq, csq):
        cn = torch.sqrt(csq)
        return torch.where(cn > EPS, lambda0 * torch.sqrt(gsq) / (cn + EPS),
                           torch.zeros_like(cn))

    def bcast(lam, like):
        return lam.reshape((-1,) + (1,) * (like.dim() - 1)) \
            if axis0_is_worker else lam

    def apply(g, ci, lam_b):
        return (g.float() + lam_b * ci).to(g.dtype)

    if mode == "per_tensor":
        gl, treedef = T.flatten(grads)
        pairs = [torch.stack([_sq_sum(g, axis0_is_worker),
                              _sq_sum(ci, axis0_is_worker)])
                 for g, ci in zip(gl, T.leaves(c))]
        pairs = (leaf_sums or list)(pairs)
        out, lams = [], []
        for g, ci, pair in zip(gl, T.leaves(c), pairs):
            lam = bcast(lam_of(pair[0], pair[1]), g)
            out.append(apply(g, ci, lam))
            lams.append(lam)
        return T.unflatten(treedef, out), T.unflatten(treedef, lams)

    lam = lam_of(*(sum_sq or sum_parts)([(_sq_sum(g, axis0_is_worker),
                                          _sq_sum(ci, axis0_is_worker))
                                         for g, ci in zip(T.leaves(grads),
                                                          T.leaves(c))]))
    return T.map(lambda g, ci: apply(g, ci, bcast(lam, g)), grads, c), lam

"""Delay compensation (paper Eq. 6/10/17), global-λ mode.

    c_i = g_i ⊙ g_i ⊙ D_i                   (Eq. 4 pseudo-Hessian · distance)
    λ_i = λ0 · ‖g_i‖ / ‖c_i‖               (Eq. 17 variance control)
    g̃_i = g_i + λ_i · c_i                   (Eq. 10)

Norms are global over the whole gradient tree (per worker when the tree
carries a leading worker axis).  All arithmetic is f32.  The fused path
(``use_kernels=True``) computes the same thing through
`repro_torch.kernels.ops.dc_norms_*` and ``dc_fused_update_*``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T

Tree = Any
EPS = 1e-30


def _tree_sq_norm(tree: Tree, axis0_is_worker: bool) -> torch.Tensor:
    """Sum of squares over all dims (except the leading worker axis when
    ``axis0_is_worker``): a scalar or (W,)."""
    def leaf_sq(x):
        x = x.float()
        if axis0_is_worker:
            return x.square().sum(dim=tuple(range(1, x.dim())))
        return x.square().sum()
    return sum(leaf_sq(x) for x in T.leaves(tree))


def dc_correct(grads: Tree, distance: Tree, lambda0: float, *,
               mode: str = "global", axis0_is_worker: bool = False
               ) -> Tuple[Tree, torch.Tensor]:
    """Returns (corrected grads g̃, λ used: a scalar or (W,))."""
    if mode != "global":
        raise NotImplementedError(
            f"lambda_norm={mode!r}: only 'global' is ported (ROADMAP A5)")
    first = T.leaves(grads)[0]
    if lambda0 == 0.0:
        shape = (first.shape[0],) if axis0_is_worker else ()
        return grads, torch.zeros(shape, dtype=torch.float32,
                                  device=first.device)

    c = T.map(lambda g, d: g.float() ** 2 * d.float(), grads, distance)
    g_norm = torch.sqrt(_tree_sq_norm(grads, axis0_is_worker))
    c_norm = torch.sqrt(_tree_sq_norm(c, axis0_is_worker))
    lam = torch.where(c_norm > EPS, lambda0 * g_norm / (c_norm + EPS),
                      torch.zeros_like(c_norm))

    def apply(g, ci):
        lam_b = lam.reshape((-1,) + (1,) * (g.dim() - 1)) \
            if axis0_is_worker else lam
        return (g.float() + lam_b * ci).to(g.dtype)

    return T.map(apply, grads, c), lam

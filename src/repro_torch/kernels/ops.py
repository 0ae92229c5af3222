"""Tree- and bucket-level wrappers around the update-tail kernels (the port
of ``repro.kernels.ops``).

`DCS3GD._fused_tail` (``use_kernels=True``) plugs these into the
algorithm, in two shapes of the same tail:

* per-leaf (``buckets=0``): one launch per leaf, each leaf viewed as
  (W, n) — the kernels take any n, so the reference's pad-to-tile round
  trip is not needed;
* bucketed (``dc_norms_buckets`` / ``dc_fused_update_buckets``): one
  launch per `repro_torch.parallel.buckets.BucketPlan` bucket.

Every launch covers all W workers.  Norms are added up in leaf (bucket)
order, as the reference does.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.kernels import dc_update as K

Tree = Any


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(W, ...) leaf -> (W, n) f32 view (a copy only when not f32)."""
    return x.float().reshape(x.shape[0], -1)


def dc_norms_tree(grads: Tree, distance: Tree
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 17 norms over a worker-stacked tree: (‖g‖², ‖g²D‖²), each (W,)."""
    gsq = csq = 0.0
    for g, d in zip(T.leaves(grads), T.leaves(distance)):
        a, b = K.dc_norms(_rows(g), _rows(d))
        gsq, csq = gsq + a, csq + b
    return gsq, csq


def dc_fused_update_tree(grads: Tree, distance: Tree, momentum: Tree,
                         params: Tree, *, lam: torch.Tensor, mu: float,
                         eta: float, wd: float) -> Tuple[Tree, Tree, Tree]:
    """Fused correction + momentum + Eq. 12 over a worker-stacked tree.

    Weight decay applies to leaves of per-worker rank > 1 (the paper
    exempts normalisation parameters).  Returns (w', m', Δw) trees."""
    leaves_g, treedef = T.flatten(grads)
    out_w, out_m, out_d = [], [], []
    for g, d, m, w in zip(leaves_g, T.leaves(distance), T.leaves(momentum),
                          T.leaves(params)):
        wn, mn, dn = K.dc_fused_update(
            _rows(g), _rows(d), _rows(m), w.reshape(w.shape[0], -1),
            lam=lam, mu=mu, eta=eta, wd=wd if w.dim() > 2 else 0.0)
        out_w.append(wn.reshape(w.shape))
        out_m.append(mn.reshape(w.shape))
        out_d.append(dn.reshape(w.shape))
    return (T.unflatten(treedef, out_w), T.unflatten(treedef, out_m),
            T.unflatten(treedef, out_d))


def dc_norms_buckets(g_buckets: Sequence[torch.Tensor],
                     d_buckets: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 17 norms over (W, bucket) buffers: one launch per bucket.
    Bucket padding is zeros and adds nothing to either sum."""
    gsq = csq = 0.0
    for g, d in zip(g_buckets, d_buckets):
        a, b = K.dc_norms(g.float(), d.float())
        gsq, csq = gsq + a, csq + b
    return gsq, csq


def dc_fused_update_buckets(g_buckets, d_buckets, m_buckets, w_buckets, *,
                            lam: torch.Tensor, mu: float, eta: float,
                            wd: float, decay: Sequence[bool]):
    """Fused correction + momentum + Eq. 12 over (W, bucket) buffers.

    ``decay`` is the plan's per-bucket weight-decay mask
    (`BucketPlan.bucket_decay`): wd is 0 on the buckets it marks False.
    Returns (w', m', Δw) bucket lists: w' in each w bucket's dtype, m' and
    Δw f32."""
    out_w, out_m, out_d = [], [], []
    for g, d, m, w, dec in zip(g_buckets, d_buckets, m_buckets, w_buckets,
                               decay):
        wn, mn, dn = K.dc_fused_update(g.float(), d.float(), m.float(), w,
                                       lam=lam, mu=mu, eta=eta,
                                       wd=wd if dec else 0.0)
        out_w.append(wn)
        out_m.append(mn)
        out_d.append(dn)
    return out_w, out_m, out_d


def dc_lambda(gsq: torch.Tensor, csq: torch.Tensor, lambda0: float
              ) -> torch.Tensor:
    """λ = λ0·‖g‖/‖c‖ from the fused norms (Eq. 17), on the norms' device;
    0 where ‖c‖ = 0 (step 0, where D = 0), never NaN."""
    cn = torch.sqrt(csq)
    return torch.where(cn > 1e-30, lambda0 * torch.sqrt(gsq) / (cn + 1e-30),
                       torch.zeros_like(cn))

"""Port parity for the update-tail kernels.

On the CPU each wrapper runs its plain version; it is held against the
reference's Pallas kernels (interpret mode) and against
``repro/kernels/ref.py``, at the reference's tolerances: norms rtol 1e-5,
update atol 1e-5 with f32 w and 2e-2 with bf16 w.  The ``gpu`` test holds
each CUDA kernel against its plain version on the card and skips where
there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dc_update as JK
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dc_update as K
from repro_torch.kernels import ops

W = 2
ARGS = dict(mu=0.9, eta=0.05, wd=2.3e-4)


def _operands(n, seed=0, w_dtype=np.float32):
    rng = np.random.default_rng(seed)
    g, d, m, w = (rng.standard_normal((W, n)).astype(np.float32)
                  for _ in range(4))
    if w_dtype != np.float32:
        w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16))
    return g, d, m, w


def _t(a):
    return params_from_numpy(a, device="cpu")


@pytest.mark.parametrize("rows", [256, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_dc_norms_plain_matches_pallas_and_ref(rows, seed):
    g, d, _, _ = _operands(rows * JK.LANES, seed)
    gsq, csq = K.dc_norms(_t(g), _t(d))
    for i in range(W):
        pg, pc = JK.dc_norms(jnp.asarray(g[i]).reshape(-1, JK.LANES),
                             jnp.asarray(d[i]).reshape(-1, JK.LANES),
                             interpret=True)
        rg, rc = jref.dc_norms_ref(jnp.asarray(g[i]), jnp.asarray(d[i]))
        for ours, theirs in ((gsq[i], pg), (csq[i], pc), (gsq[i], rg),
                             (csq[i], rc)):
            np.testing.assert_allclose(ours.item(), float(theirs),
                                       rtol=1e-5)


@pytest.mark.parametrize("w_dtype", [np.float32, "bfloat16"])
def test_dc_fused_update_plain_matches_pallas_and_ref(w_dtype):
    n = 256 * JK.LANES
    g, d, m, w = _operands(n, 2, w_dtype)
    lam = np.array([0.25, 0.5], np.float32)
    wn, mn, dn = K.dc_fused_update(_t(g), _t(d), _t(m), _t(w),
                                   lam=_t(lam), **ARGS)
    atol = 1e-5 if w_dtype == np.float32 else 2e-2
    for i in range(W):
        tiles = [jnp.asarray(x[i]).reshape(-1, JK.LANES) for x in (g, d, m, w)]
        pw, pm, pd = JK.dc_fused_update(*tiles, lam=float(lam[i]),
                                        interpret=True, **ARGS)
        rw, rm, rd = jref.dc_fused_update_ref(
            *(jnp.asarray(x[i]) for x in (g, d, m, w)), lam=float(lam[i]),
            decay_mask=True, **ARGS)
        for jw, jm, jd in ((pw, pm, pd), (rw, rm, rd)):
            np.testing.assert_allclose(
                wn[i].float().numpy(),
                np.asarray(jw, np.float32).reshape(-1), atol=atol)
            np.testing.assert_allclose(mn[i].numpy(),
                                       np.asarray(jm).reshape(-1), atol=1e-5)
            np.testing.assert_allclose(dn[i].numpy(),
                                       np.asarray(jd).reshape(-1), atol=1e-5)
    assert wn.dtype == _t(w).dtype and mn.dtype == dn.dtype == torch.float32


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((W, 33, 7)).astype(np.float32),
            "scale": rng.standard_normal((W, 19)).astype(np.float32),
            "big": rng.standard_normal((W, 70_001)).astype(np.float32)}


def test_tree_wrappers_match_reference_ops():
    """Per-leaf wrappers vs ``repro.kernels.ops`` (vmapped per worker, as
    the reference's fused tail calls them): decay masked off rank-1."""
    g, d, m, w = (_tree(s) for s in range(4))
    gsq, csq = ops.dc_norms_tree(_t(g), _t(d))
    lam = ops.dc_lambda(gsq, csq, 0.2)
    wn, mn, dn = ops.dc_fused_update_tree(_t(g), _t(d), _t(m), _t(w),
                                          lam=lam, mu=0.9, eta=0.1, wd=1e-3)

    def per_worker(g_i, d_i, m_i, w_i):
        a, b = jops.dc_norms_tree(g_i, d_i, interpret=True)
        lam_i = jops.dc_lambda(a, b, 0.2)
        return jops.dc_fused_update_tree(g_i, d_i, m_i, w_i, lam=lam_i,
                                         mu=0.9, eta=0.1, wd=1e-3,
                                         interpret=True) + (lam_i,)

    jw, jm, jd, jlam = jax.vmap(per_worker)(
        *(jax.tree.map(jnp.asarray, t) for t in (g, d, m, w)))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-5)
    for k in g:
        np.testing.assert_allclose(wn[k].numpy(), np.asarray(jw[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(mn[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-5)
        np.testing.assert_allclose(dn[k].numpy(), np.asarray(jd[k]),
                                   atol=1e-5)


def test_bucket_wrappers_match_reference_ops():
    n = 2 * JK.BLOCK
    g, d, m, w = _operands(n, 5)
    gb = [_t(g[:, :n // 2].copy()), _t(g[:, n // 2:].copy())]
    db = [_t(d[:, :n // 2].copy()), _t(d[:, n // 2:].copy())]
    mb = [_t(m[:, :n // 2].copy()), _t(m[:, n // 2:].copy())]
    wb = [_t(w[:, :n // 2].copy()), _t(w[:, n // 2:].copy())]
    decay = (True, False)
    gsq, csq = ops.dc_norms_buckets(gb, db)
    lam = ops.dc_lambda(gsq, csq, 0.2)
    wn, mn, dn = ops.dc_fused_update_buckets(gb, db, mb, wb, lam=lam,
                                             decay=decay, **ARGS)

    def per_worker(g_i, d_i, m_i, w_i):
        a, b = jops.dc_norms_buckets(g_i, d_i, interpret=True)
        lam_i = jops.dc_lambda(a, b, 0.2)
        return jops.dc_fused_update_buckets(
            g_i, d_i, m_i, w_i, lam=lam_i, decay=decay, interpret=True,
            **ARGS) + (lam_i,)

    split = lambda a: [jnp.asarray(a[:, :n // 2]), jnp.asarray(a[:, n // 2:])]
    jw, jm, jd, jlam = jax.vmap(per_worker)(split(g), split(d), split(m),
                                            split(w))
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-5)
    for ours, theirs in ((wn, jw), (mn, jm), (dn, jd)):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_dc_lambda_is_zero_not_nan_when_distance_is_zero():
    g, _, _, _ = _operands(1000, 7)
    zero = np.zeros_like(g)
    gsq, csq = ops.dc_norms_buckets([_t(g)], [_t(zero)])
    lam = ops.dc_lambda(gsq, csq, 0.2)
    assert lam.shape == (W,) and torch.equal(lam, torch.zeros(W))
    j = jops.dc_lambda(jnp.asarray(gsq.numpy()), jnp.asarray(csq.numpy()),
                       0.2)
    np.testing.assert_array_equal(np.asarray(j), lam.numpy())
    # and λ = λ0·‖g‖/‖c‖ where D ≠ 0
    _, d, _, _ = _operands(1000, 8)
    gsq, csq = ops.dc_norms_buckets([_t(g)], [_t(d)])
    lam = ops.dc_lambda(gsq, csq, 0.2)
    c = g * g * d
    want = 0.2 * np.linalg.norm(g, axis=1) / np.linalg.norm(c, axis=1)
    np.testing.assert_allclose(lam.numpy(), want, rtol=1e-5)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((W, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.dc_norms(x, x)
    with pytest.raises(ValueError, match="no kernel"):
        K.dc_fused_update(x, x, x, x, lam=torch.zeros(W, device="meta"),
                          **ARGS)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel against its plain version (norms rtol 1e-5
    and bitwise run to run; update atol 1e-5 / 2e-2 for bf16 w), at an
    aligned and a ragged width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n in (3 * JK.BLOCK, 100_003):
        g, d, m, w = (torch.randn((W, n), generator=gen, device=dev)
                      for _ in range(4))
        lam = torch.tensor([0.3, 0.7], device=dev)
        before = K.dc_norms.launches
        a = K.dc_norms(g, d)
        b = K.dc_norms(g, d)
        assert K.dc_norms.launches == before + 2
        ref = K.dc_norms_plain(g, d)
        for x, y, r in zip(a, b, (ref[:, 0], ref[:, 1])):
            assert torch.equal(x, y)
            torch.testing.assert_close(x, r, rtol=1e-5, atol=0)
        for wt, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            ww = w.to(wt)
            out = K.dc_fused_update(g, d, m, ww, lam=lam, **ARGS)
            ref = K.dc_fused_update_plain(g, d, m, ww, lam=lam, **ARGS)
            assert out[0].dtype == wt
            for x, r in zip(out, ref):
                torch.testing.assert_close(x.float(), r.float(), rtol=0,
                                           atol=atol)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_norms_bitwise_on_misaligned_view():
    """On the card: the norms of a view at a 4-byte (not 16-byte) aligned
    address are bitwise those of an aligned copy of the same values — the
    alignment picks the load width, never the sum order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for n in (3 * JK.BLOCK, 100_004):
        buf = torch.randn(2 * W * n + 1, generator=gen, device=dev)
        g = buf[1:W * n + 1].view(W, n)
        d = buf[W * n + 1:].view(W, n)
        assert g.data_ptr() % 16 != 0
        a = K.dc_norms(g, d)
        b = K.dc_norms(g.clone(), d.clone())
        for x, y in zip(a, b):
            assert torch.equal(x, y)

"""Port parity: the selective-scan kernel's plain version and its wrapper
(on CPU tensors) against the JAX Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and its oracle ``ssm_scan_ref``; and
the port's ``mamba_forward``, whose scan is the kernel's route, against
the JAX one (its XLA chunked scan) on the same weights and inputs.

Tolerance: atol 1e-4, the reference's own (``tests/test_kernels.py``).
A plain-torch model of the CUDA kernel's algorithm (chunks scanned from a
zero state, then each chunk rescanned from the carry of the chunks before
it) is held against the JAX oracle at several chunk lengths.  The ``gpu``
test holds the CUDA kernel against the plain version on the
card and skips where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import SSMConfig as JSSMConfig
from repro.kernels.ref import ssm_scan_ref
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.models import ssm as j_ssm
from repro_torch.core.types import SSMConfig
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.ref import ssm_scan_plain
from repro_torch.kernels.ssm_scan import chunk_length, ssm_scan
from repro_torch.models import ssm as t_ssm

ATOL = 1e-4
SHAPES = [  # (B, S, E, N, block_s, block_e): the reference's three
    (2, 64, 32, 8, 16, 16),
    (1, 96, 16, 16, 32, 16),
    (2, 32, 64, 4, 32, 64),
]


def _inputs(B, S, E, N, seed=11):
    rng = np.random.default_rng(seed)
    a_log = (rng.standard_normal((E, N)) * 0.3).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, E)), 0).astype(np.float32)
    dtx = (dt * rng.standard_normal((B, S, E))).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    return a_log, dt, dtx, b, c


def _check_against_jax(arrays, y, h, *, block_s, block_e):
    """y, h against ssm_scan_ref and the Pallas kernel; the kernel's
    caller pads S with identity steps (dt = dtx = 0) and E to its block,
    as its docstring asks."""
    a_log, dt, dtx, b, c = arrays
    B, S, E = dt.shape
    yr, hr = ssm_scan_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y, np.asarray(yr), atol=ATOL)
    np.testing.assert_allclose(h, np.asarray(hr), atol=ATOL)
    ps, pe = (-S) % block_s, (-E) % block_e
    seq = ((0, 0), (0, ps), (0, pe))
    yk, hk = j_ssm_scan(jnp.asarray(np.pad(a_log, ((0, pe), (0, 0)))),
                        jnp.asarray(np.pad(dt, seq)),
                        jnp.asarray(np.pad(dtx, seq)),
                        jnp.asarray(np.pad(b, ((0, 0), (0, ps), (0, 0)))),
                        jnp.asarray(np.pad(c, ((0, 0), (0, ps), (0, 0)))),
                        block_s=block_s, block_e=block_e, interpret=True)
    np.testing.assert_allclose(y, np.asarray(yk)[:, :S, :E], atol=ATOL)
    np.testing.assert_allclose(h, np.asarray(hk)[:, :E], atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES + [(2, 45, 40, 16, 16, 16)],
                         ids=["case0", "case1", "case2", "ragged"])
def test_plain_and_wrapper_match_jax_kernel_and_oracle(shape):
    """The reference's three shapes, and S, E that are not multiples of
    the Pallas blocks (which the port's kernel takes as they are)."""
    B, S, E, N, bs, be = shape
    arrays = _inputs(B, S, E, N)
    targs = [torch.from_numpy(a.copy()) for a in arrays]
    y, h = ssm_scan_plain(*targs)
    yw, hw = ssm_scan(*targs)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, E) and h.shape == (B, E, N)
    assert torch.equal(yw, y) and torch.equal(hw, h)
    _check_against_jax(arrays, y.numpy(), h.numpy(), block_s=bs,
                       block_e=be)


def test_h_last_is_the_state_after_the_last_step():
    """Scanning S steps then S' more from h_last equals scanning S + S'
    at once (the kernel must return the true last state, not a padded
    one)."""
    arrays = _inputs(1, 30, 24, 8, seed=3)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    y_all, h_all = ssm_scan_plain(*t)
    a_log, dt, dtx, b, c = t
    _, h1 = ssm_scan_plain(a_log, dt[:, :17], dtx[:, :17], b[:, :17],
                           c[:, :17])
    A = -torch.exp(a_log)
    h = h1
    for s in range(17, 30):
        h = torch.exp(dt[:, s, :, None] * A) * h \
            + dtx[:, s, :, None] * b[:, s, None, :]
    torch.testing.assert_close(h, h_all, atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", [4, 8, 13])
def test_mamba_forward_matches_jax(chunk):
    """The port's block (scan through the kernel's route) against the
    reference's XLA chunked scan, with its state; 13 does not divide
    S = 24, so the reference pads with identity steps."""
    d, S, B = 32, 24, 2
    jcfg = JSSMConfig(state_dim=8, conv_kernel=4, expand=2)
    tcfg = SSMConfig(state_dim=8, conv_kernel=4, expand=2)
    jp = j_ssm.init_mamba(jax.random.PRNGKey(0), d, jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(2).standard_normal((B, S, d)).astype(
        np.float32)
    jy, jh = j_ssm.mamba_forward(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                 return_state=True)
    ty, th = t_ssm.mamba_forward(tp, torch.from_numpy(x), tcfg,
                                 return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    # the plain route is the same function
    py, ph = t_ssm.mamba_forward(tp, torch.from_numpy(x), tcfg,
                                 return_state=True, use_kernel=False)
    assert torch.equal(py, ty) and torch.equal(ph, th)


def test_init_mamba_has_the_reference_tree():
    jcfg = JSSMConfig(state_dim=16, conv_kernel=4, expand=2)
    tcfg = SSMConfig(state_dim=16, conv_kernel=4, expand=2)
    ref = j_ssm.init_mamba(jax.random.PRNGKey(0), 64, jcfg, jnp.float32)
    got = t_ssm.init_mamba(torch.Generator().manual_seed(0), (3,), 64,
                           tcfg, torch.float32)
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        assert tuple(got[name].shape) == (3,) + a.shape, name
        assert str(got[name].dtype).replace("torch.", "") == str(a.dtype)
    for name in ("d_skip", "conv_b"):
        np.testing.assert_array_equal(got[name][1].numpy(),
                                      np.asarray(ref[name]))
    # log(1..N): torch's and XLA's log differ in the last bit here and there
    np.testing.assert_allclose(got["a_log"][1].numpy(),
                               np.asarray(ref["a_log"]), rtol=1e-7, atol=0)
    assert float(got["dt_bias"].min()) >= -4.6
    assert float(got["dt_bias"].max()) <= -2.3


def test_wrapper_checks_its_arguments():
    a_log, dt, dtx, b, c = (torch.from_numpy(a.copy())
                            for a in _inputs(1, 4, 8, 8))
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan(*(t.to("meta") for t in (a_log, dt, dtx, b, c)))


def _chunk_carry(a_log, dt, dtx, b, c, L):
    """The kernel's algorithm in plain torch.  Pass 1: every chunk of L
    steps but the last is scanned from h = 0, giving its end state h_c
    and its decay product P_c (the per-step factors multiplied in order).
    Pass 2: chunk c starts from H = P_c' H + h_c' folded over c' < c and
    is scanned again, writing y; the last chunk gives h_last."""
    A = -torch.exp(a_log)
    B, S, E = dt.shape
    starts = list(range(0, S, L)) or [0]

    def scan(h, t0, t1, ys=None, P=None):
        for t in range(t0, t1):
            dA = torch.exp(dt[:, t, :, None] * A)
            h = dA * h + dtx[:, t, :, None] * b[:, t, None, :]
            if P is not None:
                P = P * dA
            if ys is not None:
                ys.append((h * c[:, t, None, :]).sum(dim=-1))
        return h, P

    zero = torch.zeros((B, E, A.shape[1]))
    carries = [scan(zero, s0, min(S, s0 + L), P=torch.ones_like(zero))
               for s0 in starts[:-1]]
    ys = []
    for ci, s0 in enumerate(starts):
        h = zero
        for h_c, P_c in carries[:ci]:
            h = P_c * h + h_c
        h, _ = scan(h, s0, min(S, s0 + L), ys)
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros((B, 0, E))
    return y, h


@pytest.mark.parametrize("L", [1, 3, 8, "S"])
def test_chunk_and_carry_matches_jax_oracle(L):
    """Chunk lengths 1, 3 and 8 (S = 46 leaves a ragged last chunk for 3
    and 8) and S itself (one chunk: the sequential chain, bitwise the
    plain version)."""
    for B, S, E, N in [(2, 46, 40, 16), (1, 19, 8, 4)]:
        arrays = _inputs(B, S, E, N, seed=5)
        t = [torch.from_numpy(a.copy()) for a in arrays]
        y, h = _chunk_carry(*t, S if L == "S" else L)
        yr, hr = ssm_scan_ref(*(jnp.asarray(a) for a in arrays))
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=ATOL)
        if L == "S":
            yp, hp = ssm_scan_plain(*t)
            assert torch.equal(y, yp) and torch.equal(h, hp)


def test_chunk_length_fills_the_card():
    """One chunk where S is short or the channels alone fill the SMs;
    otherwise a power of two from 16 whose grid holds at most 4 CTAs per
    SM: 128 at falcon-mamba's prefill (E 8,192, N 16) at S = 512."""
    assert chunk_length(1, 512, 8192, 16, 132) == 128
    assert chunk_length(1, 128, 8192, 16, 132) == 32
    assert chunk_length(1, 16, 8192, 16, 132) == 16
    assert chunk_length(1, 5, 8192, 16, 132) == 5
    assert chunk_length(1, 0, 8192, 16, 132) == 1
    assert chunk_length(16, 512, 8192, 16, 132) == 512
    for S in (17, 77, 300, 4096):
        L = chunk_length(2, S, 1000, 16, 132)
        assert L >= 16 and L & (L - 1) == 0
        assert 32 * -(-S // L) <= 4 * 132 or L >= S


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The test shapes, a ragged one, the edge lengths S = 1, S = L (one
    chunk) and S = L + 1 (a carry into a one-step chunk), and
    falcon-mamba-7b's prefill (E 8,192, N 16, S 512): y and h_last within
    1e-4 of the plain version, h_last bitwise where one chunk holds S, and
    each launch bitwise equal to a second one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L = 16       # the shortest chunk: one holds S = 16, S = 17 takes two
    assert chunk_length(2, L, 40, 16, sms) == L
    assert chunk_length(2, L + 1, 40, 16, sms) == L
    for B, S, E, N in [s[:4] for s in SHAPES] + [
            (2, 45, 40, 16), (2, 1, 40, 16), (2, L, 40, 16),
            (2, L + 1, 40, 16), (1, 512, 8192, 16)]:
        args = [torch.from_numpy(a.copy()).to(dev)
                for a in _inputs(B, S, E, N)]
        before = ssm_scan.launches
        y, h = ssm_scan(*args)
        y2, h2 = ssm_scan(*args)
        yr, hr = ssm_scan_plain(*args)
        torch.cuda.synchronize()
        assert ssm_scan.launches == before + 2
        assert float((y - yr).abs().max()) <= ATOL, (B, S, E, N)
        assert float((h - hr).abs().max()) <= ATOL, (B, S, E, N)
        assert torch.equal(y, y2) and torch.equal(h, h2), (B, S, E, N)
        if S <= chunk_length(B, S, E, N, sms):
            assert torch.equal(h, hr), (B, S, E, N)

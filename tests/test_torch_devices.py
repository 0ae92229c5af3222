"""The CUDA kernel wrappers launch on their tensors' device, not on the
current one.

Each of the six wrappers gets tensors on ``cuda:1`` while ``cuda:0`` is
current and must match its plain version run on the same tensors.  The
shapes take each kernel above 48 KB of dynamic shared memory where it
has such an instantiation (paged_attention's f32 pool at hd 128, G 8;
flash_attention's f32 body at hd 128), so the raised limit must hold on
the second device too.  The test needs two cards and skips with that
reason where there are fewer.
"""
import pytest
import torch

from repro_torch.kernels.compress import select_ef_mean
from repro_torch.kernels.dc_update import (dc_fused_update,
                                           dc_fused_update_plain, dc_norms,
                                           dc_norms_plain)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (flash_attention_plain,
                                     paged_attention_plain,
                                     select_ef_mean_plain, ssm_scan_plain)
from repro_torch.kernels.ssm_scan import ssm_scan


@pytest.mark.gpu
def test_kernels_launch_on_their_tensors_device():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: launches on cuda:1 while "
                    "cuda:0 is current")
    dev = torch.device("cuda:1")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    torch.cuda.set_device(0)
    g, d, m, w = (randn(2, 4099) for _ in range(4))
    lam = randn(2).abs()
    gsq, csq = dc_norms(g, d)
    want = dc_norms_plain(g, d)
    torch.testing.assert_close(torch.stack([gsq, csq], 1), want, rtol=1e-5,
                               atol=0)
    got = dc_fused_update(g, d, m, w, lam=lam, mu=0.9, eta=0.1, wd=1e-4)
    for a, b in zip(got, dc_fused_update_plain(g, d, m, w, lam=lam, mu=0.9,
                                               eta=0.1, wd=1e-4)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    thresh = torch.full((2,), 0.5, device=dev)
    for a, b in zip(select_ef_mean(g, thresh, comm_dtype=torch.bfloat16,
                                   union=False),
                    select_ef_mean_plain(g, thresh,
                                         comm_dtype=torch.bfloat16,
                                         union=False)):
        assert torch.equal(a, b)

    q = randn(3, 2, 8, 128)
    k_pool, v_pool = randn(13, 16, 2, 128), randn(13, 16, 2, 128)
    tables = torch.randperm(12, device=dev).add(1).reshape(3, 4)
    tables = tables.to(torch.int32)
    lengths = torch.tensor([1, 30, 64], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_attention(q, k_pool, v_pool, tables, lengths),
        paged_attention_plain(q, k_pool, v_pool, tables, lengths),
        rtol=0, atol=1e-5)

    q, k, v = randn(1, 150, 2, 2, 128), randn(1, 150, 2, 128), \
        randn(1, 150, 2, 128)
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention_plain(q, k, v), rtol=0,
                               atol=2e-5)

    a_log = torch.log(torch.arange(1, 17, dtype=torch.float32,
                                   device=dev)).expand(64, 16).contiguous()
    dt = torch.nn.functional.softplus(randn(1, 40, 64) - 3.5)
    args = (a_log, dt, dt * randn(1, 40, 64), randn(1, 40, 16),
            randn(1, 40, 16))
    for a, b in zip(ssm_scan(*args), ssm_scan_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0

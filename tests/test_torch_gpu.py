"""Kernel tests that need a CUDA device (marker ``gpu``; they skip without
one).  This file imports torch and the port only, so it also runs on a
machine without the JAX package:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_channelized, sample_kle
from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                      solve_darcy_cg_plain)
from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,family,batch", [
    (16, "kle", 5), (33, "channelized", 5), (64, "channelized", 5),
    (64, "kle", 64), (64, "channelized", 132), (128, "kle", 5),
    (128, "channelized", 64), (200, "kle", 3), (256, "channelized", 3)])
def test_cg_kernel_matches_twin(cuda, n, family, batch):
    """atol 5e-5 against the f32 twin: the sums run in another order and
    the kernel contracts multiply-adds.  64^2 at B=64 is the main path's
    shape and B=132 a full wave of one CTA per SM; 128^2 and up run as
    clusters of 4 and 16 CTAs per field."""
    K = (sample_kle(batch, n, 64, rng=n) if family == "kle"
         else sample_channelized(batch, n, rng=n))
    K = torch.from_numpy(np.ascontiguousarray(K)).to(cuda)
    before = solve_darcy_cg.launches
    u = solve_darcy_cg(K, 24 * n)
    torch.cuda.synchronize()
    assert solve_darcy_cg.launches == before + 1
    torch.testing.assert_close(u, solve_darcy_cg_plain(K, 24 * n), atol=5e-5,
                               rtol=0)


def test_labels_on_gpu_match_cpu(cuda):
    K = torch.from_numpy(sample_kle(3, 32, 64, rng=1))
    on_gpu = solve_darcy_batch_fast(K.to(cuda)).cpu()
    on_cpu = solve_darcy_batch_fast(K)
    torch.testing.assert_close(on_gpu[:, 0], on_cpu[:, 0], atol=5e-5, rtol=0)
    flux_atol = 5e-5 * 2 * 31 * float(K.max())
    torch.testing.assert_close(on_gpu[:, 1:], on_cpu[:, 1:], atol=flux_atol,
                               rtol=0)


def test_cg_kernel_rejects_what_it_cannot_take(cuda):
    K = torch.ones(2, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        solve_darcy_cg(K.double(), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(K.transpose(1, 2), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(torch.ones(1, 257, 257, device=cuda), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(torch.ones(2, 16, 8, device=cuda), 10)


def test_batchnorm_running_var_is_biased_on_gpu(cuda):
    from pde_surrogate_torch.models.codec import BatchNorm2d
    bn = BatchNorm2d(8).to(cuda).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1, 3, (2, 8, 4, 4)).astype(np.float32)).to(cuda)
    bn(x)
    want = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["fv", "fvcg", "sobel_fvcg"])
def test_fvcg_losses_on_gpu_match_cpu(cuda, name):
    """The FV objectives and the in-loss PCG (64 iterations) at 64^2, B=4,
    on the card against the CPU: loss 1e-5 relative; the gradient with
    respect to the output within 1e-5 * max|g| of the CPU's, or within
    three times the CPU f32 gradient's own distance from float64, whichever
    is larger (the CG's reverse mode amplifies f32 rounding)."""
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.codec_trainer import _physics_loss
    n = 64
    K = torch.from_numpy(sample_kle(4, n, 512, rng=5))[:, None]
    out = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (4, 3, n, n)).astype(np.float32))
    fns = {"fv": lambda k, o: td.fv_mixed_residual_loss(k, o)[0],
           "fvcg": lambda k, o: td.fv_cg_error_loss(k, o, 10.0, 64)[0],
           "sobel_fvcg": lambda k, o: _physics_loss(
               "sobel_fvcg", k, o, SobelFilter(n), 10.0, None, 100.0, 1.0,
               64)[0]}

    def run(device, dtype=torch.float32):
        o = out.to(device, dtype).detach().requires_grad_(True)
        loss = fns[name](K.to(device, dtype), o)
        loss.backward()
        return float(loss), o.grad.double().cpu()

    l_gpu, g_gpu = run(cuda)
    l_cpu, g_cpu = run("cpu")
    _, g64 = run("cpu", torch.float64)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    bound = max(1e-5 * float(g_cpu.abs().max()),
                3 * float((g_cpu - g64).abs().max()))
    assert float((g_gpu - g_cpu).abs().max()) <= bound

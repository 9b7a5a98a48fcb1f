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


@pytest.mark.parametrize("n,family", [(16, "kle"), (33, "channelized"),
                                      (64, "channelized"), (128, "kle")])
def test_cg_kernel_matches_twin(cuda, n, family):
    """atol 5e-5 against the f32 twin: the sums run in another order and
    the kernel contracts multiply-adds."""
    K = (sample_kle(5, n, 64, rng=n) if family == "kle"
         else sample_channelized(5, n, rng=n))
    K = torch.from_numpy(K).to(cuda)
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
        solve_darcy_cg(torch.ones(1, 160, 160, device=cuda), 10)
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

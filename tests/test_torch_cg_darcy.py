"""Port parity: the PCG label solver (kernel K1's plain twin) against JAX.

The twin (pde_surrogate_torch/ops/kernels/cg_darcy.solve_darcy_cg_plain)
is held against the Pallas kernel in interpret mode and the tolerance
solver, with the bounds of tests/test_pallas_kernels.py.  The CUDA kernel
itself is compared with the twin on a card, in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_channelized, sample_kle
from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                      solve_darcy_cg_plain)
from pde_surrogate_torch.solvers import fd_darcy as tfd
from pde_surrogate_tpu.ops.kernels.cg_darcy import solve_darcy_pallas
from pde_surrogate_tpu.solvers import fd_darcy as jfd

torch.set_num_threads(1)


def _twin(K: np.ndarray, n_iter: int) -> np.ndarray:
    return solve_darcy_cg_plain(torch.from_numpy(K), n_iter).numpy()


def test_twin_matches_pallas_and_solve_darcy():
    """atol 5e-5: the Pallas kernel's own bound against the tolerance
    solver at n=16 / 400 iterations; the sum order differs from both."""
    K = sample_kle(2, 16, 32, rng=np.random.default_rng(0))
    u = _twin(K, 400)
    u_pal = np.asarray(solve_darcy_pallas(jnp.asarray(K), n_iter=400,
                                          fields_per_program=1,
                                          interpret=True))
    np.testing.assert_allclose(u, u_pal, atol=5e-5)
    for b in range(2):
        np.testing.assert_allclose(u[b], np.asarray(jfd.solve_darcy(
            jnp.asarray(K[b]))), atol=5e-5)


def test_twin_constant_k():
    """Constant K: the exact solution is u = 1 - x (to CG round-off)."""
    n = 16
    u = _twin(np.ones((3, n, n), np.float32), 200)
    x = np.linspace(0, 1, n)
    np.testing.assert_allclose(u, np.broadcast_to(1 - x, (3, n, n)),
                               atol=1e-5)


def test_twin_channelized_contrast():
    """Convergence at K ratio 100: 384 iterations at n=16 (the production
    24 n) must reach rel-L2 1e-4 of a tol-1e-8 solve."""
    K = sample_channelized(2, 16, rng=np.random.default_rng(0))
    assert float(K.max() / K.min()) == pytest.approx(100.0)
    u = _twin(K, 384)
    u_ref = np.asarray(jfd.solve_darcy_batch(jnp.asarray(K), tol=1e-8))[:, 0]
    err = (np.linalg.norm((u - u_ref).reshape(2, -1), axis=1)
           / np.linalg.norm(u_ref.reshape(2, -1), axis=1))
    assert err.max() < 1e-4, err


def test_twin_batch_of_three():
    """An odd batch (the Pallas kernel pads it to its block) is solved
    field by field: each field within 5e-5 of the Pallas result."""
    K = sample_kle(3, 16, 32, rng=np.random.default_rng(0))
    u_pal = np.asarray(solve_darcy_pallas(jnp.asarray(K), n_iter=300,
                                          fields_per_program=2,
                                          interpret=True))
    u = _twin(K, 300)
    assert u.shape == (3, 16, 16)
    np.testing.assert_allclose(u, u_pal, atol=5e-5)


def test_darcy_fields_parity():
    """Same K and u give the same (u, sigma1, sigma2) labels: elementwise
    f32 ops in the same order, so 1e-6 relative to the flux scale."""
    rng = np.random.default_rng(1)
    K = sample_kle(2, 16, 32, rng=rng)
    u = rng.random((2, 16, 16)).astype(np.float32)
    ours = tfd.darcy_fields(torch.from_numpy(K), torch.from_numpy(u)).numpy()
    ref = np.asarray(jfd.darcy_fields(jnp.asarray(K), jnp.asarray(u)))
    assert ours.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(ours, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_solve_darcy_batch_fast_cpu_matches_jax():
    """CPU labels: the port's twin at 24 n iterations against JAX's CPU
    path (the tolerance solver).  u within the kernel bound 5e-5; fluxes
    are n-1 times u differences times K, so their bound scales by that."""
    K = sample_kle(2, 16, 32, rng=np.random.default_rng(2))
    ours = tfd.solve_darcy_batch_fast(torch.from_numpy(K)).numpy()
    ref = np.asarray(jfd.solve_darcy_batch_fast(jnp.asarray(K)))
    assert ours.shape == ref.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(ours[:, 0], ref[:, 0], atol=5e-5)
    flux_atol = 5e-5 * 2 * 15 * float(K.max())
    np.testing.assert_allclose(ours[:, 1:], ref[:, 1:], atol=flux_atol)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        solve_darcy_cg(torch.ones(1, 8, 8, device="meta"), 10)


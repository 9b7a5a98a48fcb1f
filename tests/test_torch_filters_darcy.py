"""Port parity: Sobel stencils and the conv-family Darcy losses against JAX.

Same numpy inputs go through both packages; the JAX side is NHWC, the port
NCHW.  Tolerances: the Sobel products are f32 matmuls summed in another
order, so 5e-7 of the output scale (docs/PARITY.md measured up to 2.4e-7
against the reference); the losses are means of such values, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel

torch.set_num_threads(1)


def _nhwc(a):
    return np.moveaxis(a, 1, -1)


def _fields(n, seed=0, b=3):
    rng = np.random.default_rng(seed)
    K = np.exp(rng.normal(0, 1, (b, 1, n, n))).astype(np.float32)
    out = rng.normal(0, 1, (b, 3, n, n)).astype(np.float32)
    return K, out


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() / scale <= rel


@pytest.mark.parametrize("n", [16, 17, 32])
@pytest.mark.parametrize("fs", [3, 5])
@pytest.mark.parametrize("correct", [True, False])
def test_sobel_parity(n, fs, correct):
    u = np.random.default_rng(n + fs).normal(0, 1, (2, 1, n, n)).astype(
        np.float32)
    ts, js = TSobel(n, correct=correct), JSobel(n, correct=correct)
    ut = torch.from_numpy(u)
    _close(ts.grad_h(ut, fs).numpy(),
           np.moveaxis(np.asarray(js.grad_h(_nhwc(u), fs)), -1, 1), 5e-7)
    _close(ts.grad_v(ut, fs).numpy(),
           np.moveaxis(np.asarray(js.grad_v(_nhwc(u), fs)), -1, 1), 5e-7)


@pytest.mark.parametrize("n", [16, 17])
def test_conv_losses_parity(n):
    K, out = _fields(n)
    ts, js = TSobel(n), JSobel(n)
    Kt, ot = torch.from_numpy(K), torch.from_numpy(out)
    Kj, oj = _nhwc(K), _nhwc(out)
    pairs = [
        (td.conv_constitutive_constraint(Kt, ot, ts),
         jd.conv_constitutive_constraint(Kj, oj, js)),
        (td.conv_continuity_constraint(ot, ts),
         jd.conv_continuity_constraint(oj, js)),
        (td.conv_continuity_constraint(ot, ts, use_tb=False),
         jd.conv_continuity_constraint(oj, js, use_tb=False)),
        (td.flux_pressure_consistency(Kt, ot),
         jd.flux_pressure_consistency(Kj, oj)),
    ]
    pairs += list(zip(td.conv_boundary_condition(ot),
                      jd.conv_boundary_condition(oj)))
    loss_t, parts_t = td.mixed_residual_loss(Kt, ot, ts, 10.0)
    loss_j, parts_j = jd.mixed_residual_loss(Kj, oj, js, 10.0)
    pairs += [(loss_t, loss_j)] + list(zip(parts_t, parts_j))
    for t, j in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-5)
    _close(td.reconstruct_pressure(Kt, ot).numpy(),
           np.asarray(jd.reconstruct_pressure(Kj, oj)), 1e-6)


def test_mixed_residual_gradient_parity():
    """d loss / d output: the backward of the Sobel products is another
    pair of f32 matmuls, so 1e-5 of the gradient scale."""
    n = 16
    K, out = _fields(n, seed=1)
    ts, js = TSobel(n), JSobel(n)
    ot = torch.from_numpy(out).requires_grad_(True)
    td.mixed_residual_loss(torch.from_numpy(K), ot, ts, 10.0)[0].backward()
    g_j = jax.grad(lambda o: jd.mixed_residual_loss(
        jnp.asarray(_nhwc(K)), o, js, 10.0)[0])(jnp.asarray(_nhwc(out)))
    _close(ot.grad.numpy(), np.moveaxis(np.asarray(g_j), -1, 1), 1e-5)

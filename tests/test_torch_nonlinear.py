"""Port parity: the nonlinear Darcy law, its FV-Newton oracle, the tolerance
solver and the auxiliary filters, against the JAX package.

Tolerances.  Float32 results within 1e-5 relative (of max|x| for arrays),
or three times JAX's own float32 error where that is larger; the solvers'
within three times JAX's own float32 error alone.  JAX's own error is the
distance of its float32 result from the same JAX function under
``jax.enable_x64``, so the bound never depends on the port.  Float64
results within 1e-10, except the solvers (1e-8 of max|u|: their stopping
tests fire in float64, and a residual on the threshold may stop one
iteration apart) and the conv losses, whose JAX Sobel filter keeps float32
stencils under x64 (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops import filters as tf
from pde_surrogate_torch.solvers import fd_darcy as tfd
from pde_surrogate_torch.train.codec_trainer import _physics_loss as t_loss
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.ops import filters as jf
from pde_surrogate_tpu.solvers import fd_darcy as jfd
from pde_surrogate_tpu.train.codec_trainer import _physics_loss as j_loss

torch.set_num_threads(1)


def _nhwc(a):
    return np.moveaxis(a, 1, -1)


def _within(port32, port64, ref32, ref64, rtol64, floor32=1e-5):
    """Arrays (or scalars) of the port and of JAX in both precisions, held
    to the bounds of the module docstring (relative to max|ref|);
    ``floor32=0`` holds float32 to three times JAX's own error alone."""
    port32, port64, ref32, ref64 = (np.asarray(a, np.float64) for a in
                                    (port32, port64, ref32, ref64))
    scale = np.abs(ref64).max()
    own = np.abs(ref32 - ref64).max()
    err32 = np.abs(port32 - ref32).max()
    assert err32 <= max(floor32 * scale, 3 * own), (err32, own, scale)
    err64 = np.abs(port64 - ref64).max()
    assert err64 <= rtol64 * scale, (err64, scale)


# ---------------------------------------------------------------------------
# The nonlinear conv losses
# ---------------------------------------------------------------------------


def _conv_case(n=16, seed=0):
    rng = np.random.default_rng(seed)
    K = np.exp(rng.normal(0, 0.4, (2, 1, n, n)))
    out = 0.5 * rng.normal(0, 1, (2, 3, n, n))
    return K, out


def _port_grad(fn, K, out, dtype):
    o = torch.from_numpy(out).to(dtype).requires_grad_(True)
    v = fn(torch.from_numpy(K).to(dtype), o)
    (g,) = torch.autograd.grad(v, o)
    return float(v.detach()), g.double().numpy()


def _jax_grad(fn, K, out, x64):
    dtype = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        Kj = jnp.asarray(_nhwc(K).astype(dtype))
        v, g = jax.jit(jax.value_and_grad(lambda o: fn(Kj, o)))(
            jnp.asarray(_nhwc(out).astype(dtype)))
        assert g.dtype == dtype
        return float(v), np.moveaxis(np.asarray(g, np.float64), -1, 1)


NONLINEAR_LOSSES = {
    "poly": (lambda k, o: td.conv_constitutive_constraint_nonlinear(
        k, o, tf.SobelFilter(16), 0.7, 1.3),
        lambda k, o: jd.conv_constitutive_constraint_nonlinear(
            k, o, jf.SobelFilter(16), 0.7, 1.3)),
    "exp": (lambda k, o: td.conv_constitutive_constraint_nonlinear_exp(
        k, o, tf.SobelFilter(16)),
        lambda k, o: jd.conv_constitutive_constraint_nonlinear_exp(
            k, o, jf.SobelFilter(16))),
    "energy_exp": (lambda k, o: td.energy_functional_exp(
        k, o[:, :1], tf.SobelFilter(16, filter_size=5)),
        lambda k, o: jd.energy_functional_exp(
            k, o[..., :1], jf.SobelFilter(16, filter_size=5))),
    "mixed_poly": (lambda k, o: td.mixed_residual_loss(
        k, o, tf.SobelFilter(16), 7.0, "poly", 0.5, 2.0)[0],
        lambda k, o: jd.mixed_residual_loss(
            k, o, jf.SobelFilter(16), 7.0, "poly", 0.5, 2.0)[0]),
    "physics_poly": (lambda k, o: t_loss("sobel", k, o, tf.SobelFilter(16),
                                         10.0, "poly")[0],
                     lambda k, o: j_loss("sobel", k, o, jf.SobelFilter(16),
                                         10.0, "poly")[0]),
    "physics_exp": (lambda k, o: t_loss("sobel", k, o, tf.SobelFilter(16),
                                        10.0, "exp")[0],
                    lambda k, o: j_loss("sobel", k, o, jf.SobelFilter(16),
                                        10.0, "exp")[0]),
}


@pytest.mark.parametrize("name", list(NONLINEAR_LOSSES))
def test_nonlinear_conv_losses_match_jax(name):
    """The polynomial and exponential constitutive residuals, the
    exponential energy functional (5x5 stencil), the mixed residual with
    the polynomial law and ``_physics_loss('sobel', nonlinear=...)``:
    values and gradients with respect to the output."""
    t_fn, j_fn = NONLINEAR_LOSSES[name]
    K, out = _conv_case()
    t32, t64 = (_port_grad(t_fn, K, out, d) for d in (torch.float32,
                                                      torch.float64))
    j32, j64 = (_jax_grad(j_fn, K, out, x) for x in (False, True))
    for i in range(2):
        _within(t32[i], t64[i], j32[i], j64[i], 1e-6)


def test_unknown_nonlinear_law_raises_like_jax():
    K, out = _conv_case(8)
    with pytest.raises(ValueError, match="unknown nonlinear law"):
        td.mixed_residual_loss(torch.from_numpy(K), torch.from_numpy(out),
                               tf.SobelFilter(8), nonlinear="cubic")
    with pytest.raises(ValueError, match="unknown nonlinear law"):
        jd.mixed_residual_loss(jnp.asarray(_nhwc(K)), jnp.asarray(_nhwc(out)),
                               jf.SobelFilter(8), nonlinear="cubic")


# ---------------------------------------------------------------------------
# The componentwise flux solve and its implicit derivative
# ---------------------------------------------------------------------------


def _sigma_case(seed=1):
    rng = np.random.default_rng(seed)
    K = np.exp(rng.normal(0, 1, (5, 6)))
    g = rng.normal(0, 2, (5, 6))
    dK, dg, ct = rng.normal(0, 1, (3, 5, 6))
    return K, g, dK, dg, ct


@pytest.mark.parametrize("alphas", [(1.0, 1.0), (0.5, 0.1)])
def test_sigma_from_grad_and_derivatives_match_jax(alphas):
    """sigma, its JVP along (dK, dg) and its VJP of a cotangent, against
    JAX's custom JVP (and its transpose)."""
    case = _sigma_case()

    def port(dtype):
        K, g, dK, dg, ct = (torch.from_numpy(a).to(dtype) for a in case)
        s, ds = torch.func.jvp(
            lambda k, gg: tfd._sigma_from_grad(k, gg, *alphas), (K, g),
            (dK, dg))
        Kr, gr = K.clone().requires_grad_(True), g.clone().requires_grad_(True)
        vjp = torch.autograd.grad(tfd._sigma_from_grad(Kr, gr, *alphas),
                                  (Kr, gr), ct)
        return [a.detach().numpy() for a in (s, ds, *vjp)]

    def ref(x64):
        dtype = np.float64 if x64 else np.float32
        with jax.enable_x64(x64):
            K, g, dK, dg, ct = (jnp.asarray(a.astype(dtype)) for a in case)
            f = lambda k, gg: jfd._sigma_from_grad(k, gg, *alphas)  # noqa
            s, ds = jax.jvp(f, (K, g), (dK, dg))
            _, pull = jax.vjp(f, K, g)
            return [np.asarray(a) for a in (s, ds, *pull(ct))]

    for t32, t64, j32, j64 in zip(port(torch.float32), port(torch.float64),
                                  ref(False), ref(True)):
        _within(t32, t64, j32, j64, 1e-10)


def test_sigma_from_grad_gradcheck():
    """Float64 finite differences against both the backward and the
    forward-mode rule; the solve satisfies its cubic."""
    K, g, *_ = _sigma_case(2)
    K = torch.from_numpy(K).requires_grad_(True)
    g = torch.from_numpy(g * 0.3).requires_grad_(True)
    f = lambda k, gg: tfd._sigma_from_grad(k, gg, 0.8, 0.5)  # noqa: E731
    assert torch.autograd.gradcheck(f, (K, g), check_forward_ad=True)
    s = f(K, g).detach()
    Kd = K.detach()
    resid = s + 0.8 * torch.sqrt(Kd) * s ** 2 + 0.5 * Kd * s ** 3 + Kd * g.detach()
    assert float(resid.abs().max()) < 1e-10


# ---------------------------------------------------------------------------
# The Newton matvec, the tolerance solver and the FV-Newton oracle
# ---------------------------------------------------------------------------


def _jax_residual(K, alpha1, alpha2):
    """JAX's nonlinear FV residual N(v), assembled from the JAX package's
    own parts as in its ``solve_nonlinear_darcy``."""
    n = K.shape[-1]
    h = 1.0 / (n - 1)
    mask = jfd._interior_mask(n).astype(K.dtype)
    u_d = jnp.zeros((n, n), K.dtype).at[:, 0].set(1.0)
    Kx = jfd._harm(K[:, :-1], K[:, 1:])
    Ky = jfd._harm(K[:-1, :], K[1:, :])

    def residual(v):
        u = u_d + v * mask
        sx = jfd._sigma_from_grad(Kx, (u[:, 1:] - u[:, :-1]) / h, alpha1,
                                  alpha2)
        sy = jfd._sigma_from_grad(Ky, (u[1:, :] - u[:-1, :]) / h, alpha1,
                                  alpha2)
        div = (jnp.pad(sx, ((0, 0), (0, 1))) - jnp.pad(sx, ((0, 0), (1, 0)))
               + jnp.pad(sy, ((0, 1), (0, 0))) - jnp.pad(sy, ((1, 0), (0, 0))))
        return div / h * mask

    return residual


@pytest.mark.parametrize("n", [16, 33])
def test_newton_matvec_matches_jax_jvp(n):
    """The Jacobian the Newton step assembles once (the FV operator on
    K / f_sigma) against ``jax.jvp`` of the residual at the same (v, dv);
    the residual itself too."""
    rng = np.random.default_rng(n)
    K = np.exp(rng.normal(0, 1, (n, n)))
    v = 0.3 * rng.normal(0, 1, (n, n))
    dv = rng.normal(0, 1, (n, n))

    def port(dtype):
        fv = tfd._NonlinearFV(torch.from_numpy(K).to(dtype), 1.0, 1.0)
        r, jac, _ = fv.linearize(torch.from_numpy(v).to(dtype))
        return [r.numpy(), jac(torch.from_numpy(dv).to(dtype)).numpy(),
                fv.residual(torch.from_numpy(v).to(dtype)).numpy()]

    def ref(x64):
        dtype = np.float64 if x64 else np.float32
        with jax.enable_x64(x64):
            res = _jax_residual(jnp.asarray(K.astype(dtype)), 1.0, 1.0)
            r, jv = jax.jvp(res, (jnp.asarray(v.astype(dtype)),),
                            (jnp.asarray(dv.astype(dtype)),))
            return [np.asarray(r), np.asarray(jv), np.asarray(r)]

    for t32, t64, j32, j64 in zip(port(torch.float32), port(torch.float64),
                                  ref(False), ref(True)):
        _within(t32, t64, j32, j64, 1e-10)


def _fields(n, seed, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    return np.exp(np.random.default_rng(seed).normal(0, 1, shape))


@pytest.mark.parametrize("n", [16, 33])
def test_solve_darcy_matches_jax(n):
    """The tolerance PCG (tol 1e-8, maxiter 4000): one field, and a batch
    of three whose fields stop at their own iterations (float64: every
    field meets the tolerance) against JAX's vmapped solver."""
    K = _fields(n, n)
    Kb = _fields(n, n + 1, batch=3)
    Kb[1] *= 100.0

    def port(dtype):
        return (tfd.solve_darcy(torch.from_numpy(K).to(dtype)).numpy(),
                tfd.solve_darcy_batch(torch.from_numpy(Kb).to(dtype)).numpy())

    def ref(x64):
        dtype = np.float64 if x64 else np.float32
        with jax.enable_x64(x64):
            return (np.asarray(jfd.solve_darcy(jnp.asarray(K.astype(dtype)))),
                    np.asarray(jfd.solve_darcy_batch(
                        jnp.asarray(Kb.astype(dtype)))))

    for t32, t64, j32, j64 in zip(port(torch.float32), port(torch.float64),
                                  ref(False), ref(True)):
        _within(t32, t64, j32, j64, 1e-8, floor32=0.0)


@pytest.mark.parametrize("n", [16, 33])
def test_solve_nonlinear_darcy_matches_jax(n):
    """The FV-Newton oracle (alpha1 = alpha2 = 1, 12 damped Newton steps):
    (u, sigma1, sigma2) against JAX's; u meets its Dirichlet values and
    sigma2 vanishes on the walls."""
    K = _fields(n, 2 * n)

    def port(dtype):
        return tfd.solve_nonlinear_darcy(torch.from_numpy(K).to(dtype)).numpy()

    def ref(x64):
        dtype = np.float64 if x64 else np.float32
        with jax.enable_x64(x64):
            return np.asarray(jax.jit(jfd.solve_nonlinear_darcy)(
                jnp.asarray(K.astype(dtype))))

    t32, t64 = port(torch.float32), port(torch.float64)
    _within(t32, t64, ref(False), ref(True), 1e-8, floor32=0.0)
    assert t32.shape == (3, n, n)
    np.testing.assert_allclose(t32[0, :, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(t32[0, :, -1], 0.0, atol=1e-6)
    assert (t32[2, [0, -1]] == 0.0).all()


def test_nonlinear_oracle_monotonicity_check():
    K = torch.ones(4, 4)
    with pytest.raises(ValueError, match="monotonicity"):
        tfd.solve_nonlinear_darcy(K, 3.0, 1.0)
    with pytest.raises(ValueError, match="monotonicity"):
        jfd.solve_nonlinear_darcy(jnp.ones((4, 4)), 3.0, 1.0)


@pytest.mark.parametrize("axis", [0, 1])
def test_grad_fd_matches_jax(axis):
    u = np.random.default_rng(axis).normal(0, 1, (2, 9, 11))
    np.testing.assert_allclose(
        tfd._grad_fd(torch.from_numpy(u), axis + 1, 0.1).numpy(),
        np.asarray(jfd._grad_fd(jnp.asarray(u, jnp.float32), axis + 1, 0.1)),
        rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Gaussian and Fourier filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_gaussian_filter_matches_jax(order):
    """The reflect-padded Gaussian (derivative) smoother on a 12x15 image:
    weights within 1e-12, images within 1e-6 of max|x|."""
    np.testing.assert_allclose(tf.gaussian_filter1d_weights(1.3, order),
                               jf.gaussian_filter1d_weights(1.3, order),
                               rtol=1e-12, atol=1e-15)
    x = np.random.default_rng(order).normal(0, 1, (2, 1, 12, 15)).astype(
        np.float32)
    got = tf.GaussianFilter(1.3, order=order)(torch.from_numpy(x)).numpy()
    want = np.moveaxis(np.asarray(jf.GaussianFilter(1.3, order=order)(
        jnp.asarray(_nhwc(x)))), -1, 1)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("filter_size", [3, 5, 7])
def test_fourier_filter_matches_jax(filter_size):
    """Farid-Simoncelli derivatives along x and y (scaled by the image
    size) within 1e-6 of max|x|."""
    x = np.random.default_rng(filter_size).normal(0, 1, (2, 1, 12, 12)).astype(
        np.float32)
    for fn in ("grad_h", "grad_v"):
        got = getattr(tf.FourierFilter(12), fn)(torch.from_numpy(x),
                                               filter_size).numpy()
        want = np.moveaxis(np.asarray(getattr(jf.FourierFilter(12), fn)(
            jnp.asarray(_nhwc(x)), filter_size)), -1, 1)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), fn

"""Port parity: the finite-volume objectives, their in-loss PCG and the
physics dispatch, against the JAX package.

The same numpy inputs go through both packages (JAX NHWC, the port NCHW).
Each result is checked twice:

* the port in float32 against JAX in float32.  Values: rtol 1e-5, or three
  times JAX's own f32 error where that is larger (at the FV labels every
  term is f32 rounding).  Gradients with respect to the output:
  1e-5 * max|g|, or three times JAX's own f32 error, whichever is larger:
  the reverse mode of the CG amplifies f32 rounding, and at the FV labels
  every gradient is f32 noise.  JAX's own error is the distance of its
  float32 result from the same JAX function evaluated in float64
  (``jax.enable_x64``), so the bound never depends on the port;
* the port in float64 against JAX in float64: within 1e-10 of the result
  (of max|g| for gradients), plus a ten-thousandth of JAX's own f32 error
  for results that are all cancellation (the FV labels).  An error that
  the port made in both precisions would show here, whatever f32 rounding
  does.  The JAX Sobel filter keeps float32 stencils and accumulates in
  float32 under x64 too, so the objectives that hold it are compared in
  float64 at 1e-6 instead of 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.solvers import fd_darcy as tfd
from pde_surrogate_torch.train.codec_trainer import _physics_loss as t_loss
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.solvers import fd_darcy as jfd
from pde_surrogate_tpu.train.codec_trainer import _physics_loss as j_loss

torch.set_num_threads(1)

B = 2


def _nhwc(a):
    return np.moveaxis(a, 1, -1)


def _bump(n, amp=0.3):
    s = np.sin(np.pi * np.arange(n) / (n - 1))
    return (amp * s[:, None] * s[None, :]).astype(np.float32)


def _fields(n, kind, seed=0):
    """K (B, 1, n, n) and outputs (B, 3, n, n) of one kind: random, the FV
    labels (the port's twin, 24 n iterations), or the labels with a smooth
    interior bump on u."""
    rng = np.random.default_rng(seed + n)
    K = np.exp(rng.normal(0, 1, (B, 1, n, n))).astype(np.float32)
    if kind == "random":
        return K, rng.normal(0, 1, (B, 3, n, n)).astype(np.float32)
    out = tfd.solve_darcy_batch_fast(torch.from_numpy(K[:, 0])).numpy()
    if kind == "bump":
        out[:, 0] += _bump(n)
    return K, out


def _port(fn, K, out, dtype=torch.float32):
    """Values of the scalars ``fn`` returns, and the gradient of each with
    respect to ``out`` (zero where a scalar does not depend on it)."""
    ot = torch.from_numpy(out).to(dtype).requires_grad_(True)
    vals = fn(torch.from_numpy(K).to(dtype), ot)
    grads = []
    for v in vals:
        g = (torch.autograd.grad(v, ot, retain_graph=True)[0]
             if v.requires_grad else torch.zeros_like(ot))
        grads.append(g.double().numpy())
    return np.array([float(v.detach()) for v in vals]), grads


def _jax(fn, K, out, x64=False):
    """The same for a JAX function of (K, out) in NHWC, compiled once, in
    float32 or, with ``x64``, in float64."""
    dtype = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        Kj = jnp.asarray(_nhwc(K).astype(dtype))

        def f(o):
            return jnp.stack(fn(Kj, o))

        vals, jac = jax.jit(lambda o: (f(o), jax.jacrev(f)(o)))(
            jnp.asarray(_nhwc(out).astype(dtype)))
        assert vals.dtype == jac.dtype == dtype
        return (np.asarray(vals, np.float64),
                [np.moveaxis(g, -1, 1).astype(np.float64)
                 for g in np.asarray(jac)])


def _check(port32, port64, ref32, ref64, rtol64=1e-10):
    """Values and gradients within the bounds of the module docstring."""
    own = np.abs(ref32[0] - ref64[0])
    bound = np.maximum(1e-5 * np.abs(ref32[0]), 3 * own)
    assert (np.abs(port32[0] - ref32[0]) <= bound).all(), (
        port32[0], ref32[0], bound)
    bound = rtol64 * np.abs(ref64[0]) + 1e-4 * own
    assert (np.abs(port64[0] - ref64[0]) <= bound).all(), (
        port64[0], ref64[0], bound)
    for g, g64, g_ref, g_ref64 in zip(port32[1], port64[1], ref32[1],
                                      ref64[1]):
        own = np.abs(g_ref - g_ref64).max()
        bound = max(1e-5 * np.abs(g_ref).max(), 3 * own)
        err = np.abs(g - g_ref).max()
        assert err <= bound, (err, bound)
        bound = rtol64 * np.abs(g_ref64).max() + 1e-4 * own
        err = np.abs(g64 - g_ref64).max()
        assert err <= bound, (err, bound)


def _compare(t_fn, j_fn, K, out, rtol64=1e-10):
    _check(_port(t_fn, K, out), _port(t_fn, K, out, torch.float64),
           _jax(j_fn, K, out), _jax(j_fn, K, out, x64=True), rtol64)


@pytest.mark.parametrize("n", [16, 17])
def test_fv_operator_helpers_match_jax(n):
    """Face conductivities, the operator and the interior mask: the same
    elementwise arithmetic, batched here and vmapped in JAX (rtol 1e-6)."""
    rng = np.random.default_rng(n)
    K = np.exp(rng.normal(0, 1, (B, n, n))).astype(np.float32)
    v = rng.normal(0, 1, (B, n, n)).astype(np.float32)
    t_faces = tfd._face_conductivities(torch.from_numpy(K))
    j_faces = jax.vmap(jfd._face_conductivities)(jnp.asarray(K))
    for t, j in zip(t_faces, j_faces):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    np.testing.assert_allclose(
        tfd._apply_operator(torch.from_numpy(v), t_faces).numpy(),
        np.asarray(jax.vmap(jfd._apply_operator)(jnp.asarray(v), j_faces)),
        rtol=1e-6, atol=1e-6)
    # a single (n, n) field against batched faces (the Dirichlet lift)
    u_d = np.zeros((n, n), np.float32)
    u_d[:, 0] = 1.0
    np.testing.assert_allclose(
        tfd._apply_operator(torch.from_numpy(u_d), t_faces).numpy(),
        np.asarray(jax.vmap(jfd._apply_operator, (None, 0))(
            jnp.asarray(u_d), j_faces)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tfd._interior_mask(n).numpy(),
                                  np.asarray(jfd._interior_mask(n)))


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("kind", ["random", "labels", "bump"])
@pytest.mark.parametrize("n_cg", [0, 8, None])
def test_fv_losses_match_jax(n, kind, n_cg):
    """fv_mixed_residual_loss (its four outputs), fv_cg_u_error,
    fv_cg_anchors (both anchors) and fv_cg_error_loss (its four outputs):
    values and gradients with respect to the output."""
    K, out = _fields(n, kind)

    def t_fn(k, o):
        err_u, err_flux = td.fv_cg_anchors(k, o, n_cg)
        loss, parts = td.fv_cg_error_loss(k, o, 10.0, n_cg)
        return [td.fv_cg_u_error(k, o, n_cg), err_u, err_flux, loss, *parts]

    def j_fn(k, o):
        err_u, err_flux = jd.fv_cg_anchors(k, o, n_cg)
        loss, parts = jd.fv_cg_error_loss(k, o, 10.0, n_cg)
        return [jd.fv_cg_u_error(k, o, n_cg), err_u, err_flux, loss, *parts]

    _compare(t_fn, j_fn, K, out)
    if n_cg is None:
        _compare(lambda k, o: [td.fv_mixed_residual_loss(k, o, 7.0)[0],
                               *td.fv_mixed_residual_loss(k, o, 7.0)[1]],
                 lambda k, o: [jd.fv_mixed_residual_loss(k, o, 7.0)[0],
                               *jd.fv_mixed_residual_loss(k, o, 7.0)[1]],
                 K, out)


@pytest.mark.parametrize("physics", ["sobel", "fv", "fvcg", "sobel_fvcg"])
def test_physics_loss_matches_jax(physics):
    """The dispatch of the four label-free objectives (flux weight 1 and 8
    CG iterations for the hybrid): values and gradients of (loss, pde,
    dirichlet, neumann)."""
    n = 16
    K, out = _fields(n, "bump")
    kw = (100.0, 1.0, 8)

    def t_fn(k, o):
        loss, parts = t_loss(physics, k, o, TSobel(n), 10.0, None, *kw)
        return [loss, *parts]

    def j_fn(k, o):
        loss, parts = j_loss(physics, k, o, JSobel(n), 10.0, None, *kw)
        return [loss, *parts]

    _compare(t_fn, j_fn, K, out, 1e-6 if "sobel" in physics else 1e-10)


@pytest.mark.parametrize("physics,nonlinear,match", [
    ("nope", None, "unknown physics loss"),
    ("fv", "poly", "linear law only"),
    ("fvcg", "exp", "linear law only"),
    ("sobel_fvcg", "poly", "linear law only")])
def test_physics_loss_errors_match_jax(physics, nonlinear, match):
    n = 8
    K, out = _fields(n, "random")
    with pytest.raises(ValueError, match=match):
        t_loss(physics, torch.from_numpy(K), torch.from_numpy(out),
               TSobel(n), 10.0, nonlinear)
    with pytest.raises(ValueError, match=match):
        j_loss(physics, jnp.asarray(_nhwc(K)), jnp.asarray(_nhwc(out)),
               JSobel(n), 10.0, nonlinear)


def _labels(K):
    return tfd.solve_darcy_batch_fast(torch.from_numpy(K[:, 0]))


def _error_norm():
    """At the truth the fvcg loss is ~0; for a smooth self-consistent
    interior error the u anchor recovers the actual error energy, the flux
    anchor flags the self-consistent fluxes, and the raw FV residual
    under-reports the same error by orders of magnitude."""
    from pde_surrogate_torch.data.grf import sample_kle
    n = 32
    K = torch.from_numpy(sample_kle(2, n, 64, rng=7))[:, None]
    out = tfd.solve_darcy_batch_fast(K[:, 0])
    n_cg = 24 * n
    assert float(td.fv_cg_error_loss(K, out, n_cg=n_cg)[0]) < 1e-4
    bump = 0.15 * torch.sin(torch.linspace(0, np.pi, n))[None, None, :]
    drifted = tfd.darcy_fields(K[:, 0], out[:, 0] + bump)
    bump_mse = float(torch.mean(bump.expand(2, n, n) ** 2))
    err_u, err_flux = td.fv_cg_anchors(K, drifted, n_cg=n_cg)
    assert 0.3 * bump_mse < float(err_u) < 3.0 * bump_mse
    assert float(err_flux) > 1e-4
    _, (pde_cg, _, _) = td.fv_cg_error_loss(K, drifted, n_cg=n_cg)
    np.testing.assert_allclose(float(pde_cg), float(err_u) + float(err_flux),
                               rtol=1e-5)
    _, (pde_fv, _, _) = td.fv_mixed_residual_loss(K, drifted)
    assert float(pde_fv) < 0.1 * float(err_u)
    o = drifted.clone().requires_grad_(True)
    td.fv_cg_error_loss(K, o)[0].backward()
    assert torch.isfinite(o.grad).all()


def _hybrid_components():
    """sobel_fvcg = sobel + w * err_u: exact at the truth, and the u term
    sees an interior pressure bump; its gradient reaches u."""
    n = 17
    K = np.exp(np.random.default_rng(0).normal(0, 1, (2, 1, n, n))).astype(
        np.float32)
    Kt, out = torch.from_numpy(K), _labels(K)
    err_true = float(td.fv_cg_u_error(Kt, out, n_cg=2 * n))
    assert err_true < 1e-8
    drift = out.clone()
    drift[:, 0] += torch.from_numpy(_bump(n))
    err_drift = float(td.fv_cg_u_error(Kt, drift, n_cg=2 * n))
    assert err_drift > 1e3 * max(err_true, 1e-12)
    sobel, w = TSobel(n), 100.0
    l_h, (_, diri_h, _) = t_loss("sobel_fvcg", Kt, out, sobel, 10.0, None, w)
    l_s, (_, diri_s, _) = t_loss("sobel", Kt, out, sobel, 10.0, None)
    np.testing.assert_allclose(float(l_h), float(l_s) + w * err_true,
                               rtol=1e-5)
    np.testing.assert_allclose(float(diri_h), float(diri_s), rtol=1e-6)
    o = drift.clone().requires_grad_(True)
    t_loss("sobel_fvcg", Kt, o, sobel, 10.0, None, w)[0].backward()
    assert torch.isfinite(o.grad).all() and float(o.grad[:, 0].abs().sum()) > 0


def _flux_anchor():
    """The flux anchor against the CG-corrected pressure: both anchors
    vanish at the truth; with a corrupted u it stays near zero while the
    uncorrected target (n_cg = 0, e = 0 exactly) inherits the corruption;
    n_cg=None is n; the flux weight adds fw * err_flux."""
    n = 17
    K = np.exp(np.random.default_rng(0).normal(0, 1, (2, 1, n, n))).astype(
        np.float32)
    Kt, out = torch.from_numpy(K), _labels(K)
    err_u, err_flux = td.fv_cg_anchors(Kt, out, n_cg=2 * n)
    assert float(err_u) < 1e-8 and float(err_flux) < 1e-6
    drift = out.clone()
    drift[:, 0] += torch.from_numpy(_bump(n))
    err_u2, err_flux2 = td.fv_cg_anchors(Kt, drift, n_cg=2 * n)
    naive_u, naive_flux = td.fv_cg_anchors(Kt, drift, n_cg=0)
    assert float(naive_flux) > 1e-1
    assert float(err_flux2) < 1e-2 * float(naive_flux)
    assert float(naive_u) == 0.0
    np.testing.assert_allclose(float(td.fv_cg_u_error(Kt, drift)),
                               float(td.fv_cg_u_error(Kt, drift, n_cg=n)),
                               rtol=1e-7)
    sobel = TSobel(n)
    l0, _ = t_loss("sobel_fvcg", Kt, drift, sobel, 10.0, None, 100.0, 0.0,
                   2 * n)
    lf, _ = t_loss("sobel_fvcg", Kt, drift, sobel, 10.0, None, 100.0, 7.0,
                   2 * n)
    np.testing.assert_allclose(float(lf), float(l0) + 7.0 * float(err_flux2),
                               rtol=1e-5)
    o = drift.clone().requires_grad_(True)
    t_loss("sobel_fvcg", Kt, o, sobel, 10.0, None, 0.0, 1.0,
           2 * n)[0].backward()
    assert torch.isfinite(o.grad).all() and float(o.grad[:, 1:].abs().sum()) > 0


@pytest.mark.parametrize("check", [_error_norm, _hybrid_components,
                                   _flux_anchor],
                         ids=["error_norm", "hybrid_components",
                              "flux_anchor"])
def test_fvcg_properties(check):
    """The property checks of the JAX package's tests/test_darcy_losses.py
    (fvcg section), run on the port."""
    check()

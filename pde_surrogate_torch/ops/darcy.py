"""Darcy-flow physics losses.

Counterpart of pde_surrogate_tpu/ops/darcy.py.  The PDE:

    div(K(s) grad u(s)) = 0   on (0,1)^2
    u = 1 at x=0 (left),  u = 0 at x=1 (right),  zero vertical flux top/bottom

with the linear law sigma = -K grad u or a nonlinear one (polynomial or
exponential, reference models/darcy.py:179-208).  Three families:

* conv: fields are (B, C, H, W) with output channels (u, sigma1, sigma2) =
  (pressure, horizontal flux, vertical flux) and input K in channel 0;
  derivatives from the Sobel matrix stencils (``ops.filters``);
* finite volume (``fv_*``): the label solver's own discretization
  (``solvers/fd_darcy``); ``fvcg`` runs a differentiable Jacobi PCG on it
  inside the loss;
* FC (collocation points, the PINN solver): a network maps (N, 2) points
  in (y, x) order on [0, 1]^2 to (u, tau_ver, tau_hor); per-point
  Jacobians (and Hessians) with respect to the point come from
  ``torch.func`` (``vmap`` of ``jacfwd``), as the JAX package's
  ``vmap(jacfwd)``, and the parameter gradient flows through them.  The
  network is an ``nn.Module`` or a ``(module, params)`` pair evaluated with
  ``torch.func.functional_call``.

The conv losses also run on a row block (a ``SobelFilter`` ``on_rows``,
the data x space training step): there ``output`` carries the Sobel's
``halo()`` rows above and below the block (``mixed_residual_loss``
exchanges them), ``input`` is the block itself, and every mean becomes
this rank's partial sum over the global count, so that the sum over the
space ranks is the loss of the whole fields.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..solvers.fd_darcy import (_apply_operator, _dirichlet_lift,
                                _face_conductivities, _face_fluxes,
                                _face_kx_ky, _faces_to_nodes, _interior_mask,
                                _laplacian)
from ..parallel.halo import RowShard, exchange_rows, with_halo
from .filters import SobelFilter

__all__ = ["conv_constitutive_constraint",
           "conv_constitutive_constraint_nonlinear",
           "conv_constitutive_constraint_nonlinear_exp",
           "conv_continuity_constraint", "conv_boundary_condition",
           "energy_functional_exp", "mixed_residual_loss",
           "fv_mixed_residual_loss", "fv_cg_u_error", "fv_cg_anchors",
           "fv_cg_error_loss", "reconstruct_pressure",
           "flux_pressure_consistency", "bilinear_interpolate",
           "mixed_residual_fc", "primal_residual_fc", "primal_variational_fc",
           "neumann_boundary", "neumann_boundary_mixed"]


def _own_rows(t: torch.Tensor, sobel: SobelFilter) -> torch.Tensor:
    """``t``, or on a row block its own rows, without the Sobel's halo."""
    if sobel.rows is None:
        return t
    a, b = sobel.halo()
    return t[..., a:t.shape[-2] - b, :]


def _mean(t: torch.Tensor, rows: RowShard | None) -> torch.Tensor:
    """The mean of ``t`` over the whole fields; on a row block (every
    block holds as many elements) this block's sum over the global
    count."""
    if rows is None:
        return torch.mean(t)
    return torch.sum(t) / (t.numel() * rows.size)


def conv_constitutive_constraint(input: torch.Tensor, output: torch.Tensor,
                                 sobel: SobelFilter) -> torch.Tensor:
    """mean((sigma_hat - (-K grad u))^2) over both flux components
    (reference models/darcy.py:162-176).  input (B,1,H,W), output (B,3,H,W).
    """
    u = output[:, 0:1]
    est_sigma1 = -input * sobel.grad_h(u)
    est_sigma2 = -input * sobel.grad_v(u)
    own = _own_rows(output, sobel)
    return _mean((own[:, 1:2] - est_sigma1) ** 2
                 + (own[:, 2:3] - est_sigma2) ** 2, sobel.rows)


def conv_constitutive_constraint_nonlinear(input: torch.Tensor,
                                           output: torch.Tensor,
                                           sobel: SobelFilter, beta1: float,
                                           beta2: float) -> torch.Tensor:
    """Residual of the polynomial law -K grad u = sigma + beta1 sqrt(K)
    sigma^2 + beta2 K sigma^3, componentwise (models/darcy.py:179-191)."""
    u = output[:, 0:1]
    k_u_h = -input * sobel.grad_h(u)
    k_u_v = -input * sobel.grad_v(u)
    sigma = _own_rows(output, sobel)[:, 1:3]
    rhs = (sigma + beta1 * torch.sqrt(input) * sigma ** 2
           + beta2 * input * sigma ** 3)
    return _mean((k_u_h - rhs[:, 0:1]) ** 2 + (k_u_v - rhs[:, 1:2]) ** 2,
                 sobel.rows)


def conv_constitutive_constraint_nonlinear_exp(input: torch.Tensor,
                                               output: torch.Tensor,
                                               sobel: SobelFilter
                                               ) -> torch.Tensor:
    """Residual of the exponential law sigma = -exp(K u) grad u
    (models/darcy.py:193-208)."""
    u = output[:, 0:1]
    own = _own_rows(output, sobel)
    coef = torch.exp(input * own[:, 0:1])
    return _mean((own[:, 1:2] + coef * sobel.grad_h(u)) ** 2
                 + (own[:, 2:3] + coef * sobel.grad_v(u)) ** 2, sobel.rows)


def energy_functional_exp(input: torch.Tensor, output: torch.Tensor,
                          sobel: SobelFilter) -> torch.Tensor:
    """Variational energy of the exponential law, mean(0.5 exp(K u)
    |grad u|^2) (models/darcy.py:151-159); ``output`` is the field u
    (B, 1, H, W)."""
    grad_h = sobel.grad_h(output)
    grad_v = sobel.grad_v(output)
    return _mean(0.5 * torch.exp(input * _own_rows(output, sobel))
                 * (grad_h ** 2 + grad_v ** 2), sobel.rows)


def conv_continuity_constraint(output: torch.Tensor, sobel: SobelFilter,
                               use_tb: bool = True) -> torch.Tensor:
    """mean((d sigma1/dx + d sigma2/dy)^2) (models/darcy.py:210-224);
    ``use_tb=False`` leaves the top and bottom rows (of the whole fields)
    out of the mean."""
    div = (sobel.grad_h(output[:, 1:2]) + sobel.grad_v(output[:, 2:3])) ** 2
    rows = sobel.rows
    if use_tb:
        return _mean(div, rows)
    if rows is None:
        return torch.mean(div[:, :, 1:-1, :])
    h = div.shape[-2]
    lo = 1 if rows.index == 0 else 0
    hi = h - 1 if rows.index == rows.size - 1 else h
    count = div[:, :, :1].numel() * (rows.size * h - 2)
    return torch.sum(div[:, :, lo:hi, :]) / count


def conv_boundary_condition(output: torch.Tensor,
                            rows: RowShard | None = None):
    """(dirichlet, neumann) boundary MSEs (models/darcy.py:226-233):
    u = 1 on the left column, u = 0 on the right, sigma2 = 0 on the top and
    bottom rows.  On a row block (``rows``; ``output`` without a halo) the
    Dirichlet columns run through every block and the top and bottom rows
    lie in the edge blocks only."""
    left = output[:, 0, :, 0]
    right = output[:, 0, :, -1]
    loss_dirichlet = _mean((left - 1.0) ** 2, rows) + _mean(right ** 2, rows)
    if rows is None:
        return loss_dirichlet, torch.mean(output[:, 2, [0, -1], :] ** 2)
    h = output.shape[-2]
    walls = ([0] if rows.index == 0 else []) + (
        [h - 1] if rows.index == rows.size - 1 else [])
    top_down_flux = output[:, 2, torch.tensor(walls, dtype=torch.long,
                                              device=output.device), :]
    count = output[:, 2, :2, :].numel()
    return loss_dirichlet, torch.sum(top_down_flux ** 2) / count


def mixed_residual_loss(input: torch.Tensor, output: torch.Tensor,
                        sobel: SobelFilter, weight_bound: float = 10.0,
                        nonlinear: str | None = None, beta1: float = 1.0,
                        beta2: float = 1.0, halo=None):
    """constitutive + continuity + weight_bound * boundary; the law is
    linear (``nonlinear=None``), polynomial (``"poly"``, with beta1 and
    beta2) or exponential (``"exp"``).

    On a row block (``sobel.rows``) ``input`` and ``output`` are the
    block's rows, ``halo`` the ``(above, below)`` rows of ``output`` that
    the Sobel reads (exchanged with the neighbouring ranks when None), and
    the terms are this rank's partial sums.

    Returns ``(loss, (pde, dirichlet, neumann))``.
    """
    own = output
    if sobel.rows is not None:
        if halo is None:
            halo = exchange_rows(output, *sobel.halo(), sobel.rows)
        output = with_halo(output, *halo)
    if nonlinear is None:
        constitutive = conv_constitutive_constraint(input, output, sobel)
    elif nonlinear == "poly":
        constitutive = conv_constitutive_constraint_nonlinear(
            input, output, sobel, beta1, beta2)
    elif nonlinear == "exp":
        constitutive = conv_constitutive_constraint_nonlinear_exp(
            input, output, sobel)
    else:
        raise ValueError(f"unknown nonlinear law: {nonlinear}")
    continuity = conv_continuity_constraint(output, sobel)
    dirichlet, neumann = conv_boundary_condition(own, sobel.rows)
    pde = constitutive + continuity
    loss = pde + weight_bound * (dirichlet + neumann)
    return loss, (pde, dirichlet, neumann)


def _flux_mismatch(sigma: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
                   ) -> torch.Tensor:
    """mean((sigma - face fluxes averaged to nodes)^2), sigma (B, 2, n, n):
    the label convention of ``solvers/fd_darcy.darcy_fields``."""
    s1_ref, s2_ref = _faces_to_nodes(fx, fy)
    return torch.mean((sigma - torch.stack([s1_ref, s2_ref], dim=1)) ** 2)


def _dirichlet_neumann(output: torch.Tensor):
    """The FV objectives' boundary terms: u = 1 / u = 0 on the left / right
    columns, and sigma2 on the top and bottom rows (logged only)."""
    u = output[:, 0]
    dirichlet = (torch.mean((u[..., :, 0] - 1.0) ** 2)
                 + torch.mean(u[..., :, -1] ** 2))
    neumann = (torch.mean(output[:, 2, 0, :] ** 2)
               + torch.mean(output[:, 2, -1, :] ** 2))
    return dirichlet, neumann


def fv_mixed_residual_loss(input: torch.Tensor, output: torch.Tensor,
                           weight_bound: float = 10.0):
    """Finite-volume mixed residual, the exactly identifiable label-free
    objective (JAX ops/darcy.py:176-249; no reference counterpart).

    * residual: the conservative FV divergence of u's face fluxes
      (harmonic faces, zero-flux top/bottom), divided by the operator
      diagonal, over the interior columns;
    * flux consistency: the flux channels against u's own conservative face
      fluxes averaged to nodes (the label convention);
    * dirichlet: the u = 1 - x boundary columns, weighted by
      ``weight_bound``.

    loss = 0 exactly when u is the FV solution and the fluxes are its
    labels.  Returns ``(loss, (pde, dirichlet, neumann))``; neumann is
    logged only (the zero walls enter through the flux reference).
    """
    K = input[:, 0]
    u = output[:, 0]
    h = 1.0 / (K.shape[-1] - 1)
    Kx, Ky = _face_kx_ky(K)
    fx, fy = _face_fluxes(Kx, Ky, u)
    # missing boundary faces contribute 0: the zero-flux mirror walls
    div = (F.pad(fx, (0, 1)) - F.pad(fx, (1, 0))
           + F.pad(fy, (0, 0, 0, 1)) - F.pad(fy, (0, 0, 1, 0))) / h
    diag = (F.pad(Kx, (0, 1)) + F.pad(Kx, (1, 0))
            + F.pad(Ky, (0, 0, 0, 1)) + F.pad(Ky, (0, 0, 1, 0))) / (h * h)
    r = div / torch.clamp(diag, min=1e-30)
    residual = torch.mean(r[..., :, 1:-1] ** 2)
    flux_consistency = _flux_mismatch(output[:, 1:], fx, fy)
    dirichlet, neumann = _dirichlet_neumann(output)
    pde = residual + flux_consistency
    loss = pde + weight_bound * dirichlet
    return loss, (pde, dirichlet, neumann)


def _resolve_n_cg(n_cg: int | None, n: int) -> int:
    """The in-loss CG depth: ``None`` -> n iterations (kappa(A) ~ n^2 *
    contrast, so the Krylov depth that reaches the smooth error modes grows
    ~ n)."""
    return n if n_cg is None else n_cg


def _cg_pressure_errors(input: torch.Tensor, output: torch.Tensor,
                        n_cg: int | None = None) -> torch.Tensor:
    """Per-field CG-recovered pressure error e_k, (B, n, n).

    ``n_cg`` Jacobi-PCG iterations on A(K) e = r(u_hat), r the FV residual
    of the predicted pressure, so u_hat + e_k approaches the FV solution
    whatever u_hat is.  Label-free: only K and the prediction enter.  The
    iterations run batched with per-field dots and the JAX package's
    guards (+1e-30 on both divisions, the diagonal clamped at 1e-30);
    autograd through the unrolled loop is the reverse mode of JAX's
    ``fori_loop``.  p and e stay zero on the Dirichlet columns, so the
    loop's matvec skips the input mask of ``A(v * mask) * mask``.
    """
    K = input[:, 0]
    u = output[:, 0]
    n = K.shape[-1]
    n_cg = _resolve_n_cg(n_cg, n)
    faces = _face_conductivities(K)
    aE, aW, aN, aS = faces
    mask = _interior_mask(n, K.dtype, K.device)
    neg_mask = -mask
    u_d = _dirichlet_lift(n, K)
    b = -_apply_operator(u_d, faces) * mask
    inv_diag = mask / torch.clamp(aE + aW + aN + aS, min=1e-30)

    def matvec(v):
        return _laplacian(v, faces) * neg_mask

    def dot(a, c):
        return torch.sum(a * c, dim=(-2, -1), keepdim=True)

    r = (b - matvec((u - u_d) * mask)) * mask
    e = torch.zeros_like(r)
    z = r * inv_diag
    p = z
    rz = dot(r, z)
    for _ in range(n_cg):
        ap = matvec(p)
        alpha = rz / (dot(p, ap) + 1e-30)
        e = e + alpha * p
        r = r - alpha * ap
        z = r * inv_diag
        rz_new = dot(r, z)
        p = z + rz_new / (rz + 1e-30) * p
        rz = rz_new
    return e


def fv_cg_u_error(input: torch.Tensor, output: torch.Tensor,
                  n_cg: int | None = None) -> torch.Tensor:
    """mean(e_k^2), the CG-recovered pressure-error estimate: the u term of
    ``fv_cg_error_loss`` and the u anchor of the ``sobel_fvcg`` hybrid."""
    return torch.mean(_cg_pressure_errors(input, output, n_cg) ** 2)


def fv_cg_anchors(input: torch.Tensor, output: torch.Tensor,
                  n_cg: int | None = None):
    """Pressure and flux anchors from the CG-corrected pressure:
    ``(err_u, err_flux)`` with err_u = mean(e_k^2) and err_flux the flux
    channels against the conservative face fluxes of u_hat + e_k, averaged
    to nodes as the labels are.

    The Dirichlet columns of the corrected pressure are clamped to their
    exact values: e_k is zero there, and u_hat's own boundary error would
    otherwise pollute the boundary-adjacent flux target through the 1/h
    face gradient.
    """
    K = input[:, 0]
    n = K.shape[-1]
    e = _cg_pressure_errors(input, output, n_cg)
    err_u = torch.mean(e ** 2)
    u_corr = ((output[:, 0] + e) * _interior_mask(n, K.dtype, K.device)
              + _dirichlet_lift(n, K))
    fx, fy = _face_fluxes(*_face_kx_ky(K), u_corr)
    return err_u, _flux_mismatch(output[:, 1:], fx, fy)


def fv_cg_error_loss(input: torch.Tensor, output: torch.Tensor,
                     weight_bound: float = 10.0, n_cg: int | None = None):
    """The CG-preconditioned error objective (JAX ops/darcy.py:389-433):
    pde = err_u + err_flux of ``fv_cg_anchors`` (n_cg PCG iterations on
    the FV residual inside the loss, so the objective sees the smooth error
    modes the raw residual cannot), plus ``weight_bound`` x dirichlet.
    Returns ``(loss, (pde, dirichlet, neumann))``."""
    err_u, flux_consistency = fv_cg_anchors(input, output, n_cg)
    dirichlet, neumann = _dirichlet_neumann(output)
    pde = err_u + flux_consistency
    loss = pde + weight_bound * dirichlet
    return loss, (pde, dirichlet, neumann)


def reconstruct_pressure(input: torch.Tensor, output: torch.Tensor
                         ) -> torch.Tensor:
    """Pressure from the predicted horizontal flux, label-free, (B, H, W).

    u(x) = 1 - int_0^x sigma1_hat / K: trapezoid cumulative integral along x
    from both edges, blended linearly toward the nearer Dirichlet anchor.
    The spacing is 1/n, not 1/(n-1), because the Sobel operators scale by
    the image size n: a self-consistent net then scores exactly 0.
    """
    K = input[:, 0]
    n = output.shape[-1]
    dudx = -output[:, 1] / K
    mids = 0.5 * (dudx[:, :, 1:] + dudx[:, :, :-1]) / n
    cum = torch.cat([torch.zeros_like(mids[:, :, :1]),
                     torch.cumsum(mids, dim=2)], dim=2)
    u_left = 1.0 + cum
    u_right = cum - cum[:, :, -1:]
    w = torch.linspace(0.0, 1.0, n, device=output.device,
                       dtype=output.dtype)[None, None, :]
    return (1.0 - w) * u_left + w * u_right


def flux_pressure_consistency(input: torch.Tensor, output: torch.Tensor
                              ) -> torch.Tensor:
    """Label-free drift metric: batch mean of the rel-L2 between the net's u
    and the flux-integrated u (``reconstruct_pressure``)."""
    u_hat = output[:, 0]
    u_rec = reconstruct_pressure(input, output)
    num = torch.sqrt(torch.sum((u_hat - u_rec) ** 2, dim=(1, 2)))
    den = torch.sqrt(torch.sum(u_rec ** 2, dim=(1, 2)))
    return torch.mean(num / den)


# ---------------------------------------------------------------------------
# FC family (collocation points, per-point Jacobians by torch.func)
# ---------------------------------------------------------------------------


def _net(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """pts -> outputs for an ``nn.Module`` or a ``(module, params)`` pair
    (``params`` a dict of name -> tensor for ``functional_call``)."""
    if isinstance(model, tuple):
        module, params = model
        return lambda pts: torch.func.functional_call(module, params, (pts,))
    return model


def bilinear_interpolate(im: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Bilinearly interpolate the image ``im`` (H, W) at pixel coordinates
    (x, y), each (N,): the reference's gather and lerp
    (models/darcy.py:18-48), with the cell index clamped to size - 2 so
    that points on the top or right edge interpolate (the reference's
    double clamp zeroes all four weights there)."""
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, im.shape[1] - 2).long()
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, im.shape[0] - 2).long()
    x1, y1 = x0 + 1, y0 + 1
    x0f, x1f = x0.to(x.dtype), x1.to(x.dtype)
    y0f, y1f = y0.to(y.dtype), y1.to(y.dtype)
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0f)
    wc = (x - x0f) * (y1f - y)
    wd = (x - x0f) * (y - y0f)
    return (im[y0, x0] * wa + im[y1, x0] * wb + im[y0, x1] * wc
            + im[y1, x1] * wd)


def _pointwise_val_jac(model, x: torch.Tensor):
    """Per-point (value, Jacobian d out / d point): ((N, out), (N, out, 2)).

    Forward mode over the 2-D input (``jacfwd``, two tangents) vmapped over
    the points, as the JAX package's ``vmap(jacfwd(..., has_aux=True))``:
    the primal comes from the same evaluation.  The result stays
    differentiable with respect to the network's parameters.
    """
    net = _net(model)

    def f(pt):
        out = net(pt[None, :])[0]
        return out, out

    jac, val = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(x)
    return val, jac


def _u_single(model):
    net = _net(model)
    return lambda pt: net(pt[None, :])[0, 0]


def mixed_residual_fc(model, x: torch.Tensor, K: torch.Tensor,
                      rand_colloc: bool = False,
                      imsize: int | None = None) -> torch.Tensor:
    """Mixed-form residual at collocation points, constitutive +
    continuity (models/darcy.py:113-144).

    ``model`` emits (u, tau_ver, tau_hor), the reference's FC channel order
    (y-flux, then x-flux); ``x`` is (N, 2) in (y, x) order; ``K`` is the
    (N, 1) on-grid permeability or, with ``rand_colloc``, the (H*W, 1) grid,
    interpolated at the points in pixel space (``imsize`` required).
    """
    y, u_x = _pointwise_val_jac(model, x)      # (N, 3), (N, 3, 2)
    tau = y[:, 1:3]
    grad_u = u_x[:, 0, :]                       # (du/dy, du/dx)
    grad_tau_ver = u_x[:, 1, 0]                 # d tau_ver / dy
    grad_tau_hor = u_x[:, 2, 1]                 # d tau_hor / dx
    if rand_colloc:
        if imsize is None:
            raise ValueError("imsize required for off-grid collocation")
        grid = K.reshape(imsize, imsize)
        kx = x[:, 1] * (imsize - 1)
        ky = x[:, 0] * (imsize - 1)
        K = bilinear_interpolate(grid, kx, ky)[:, None]
    loss_constitutive = torch.mean((K * grad_u + tau) ** 2)
    loss_continuity = torch.mean((grad_tau_ver + grad_tau_hor) ** 2)
    return loss_constitutive + loss_continuity


def primal_residual_fc(model, x: torch.Tensor, K_grad_ver: torch.Tensor,
                       K_grad_hor: torch.Tensor, K: torch.Tensor
                       ) -> torch.Tensor:
    """Second-order primal residual, div(K grad u) = grad K . grad u +
    K lap u (models/darcy.py:51-78), with per-point gradients and Hessians
    of u (``torch.func.grad`` and ``hessian``, vmapped)."""
    u = _u_single(model)
    grad_u = torch.func.vmap(torch.func.grad(u))(x)           # (N, 2)
    hess_u = torch.func.vmap(torch.func.hessian(u))(x)        # (N, 2, 2)
    div = (K_grad_ver * grad_u[:, 0] + K * hess_u[:, 0, 0]
           + K_grad_hor * grad_u[:, 1] + K * hess_u[:, 1, 1])
    return torch.mean(div ** 2)


def primal_variational_fc(model, x: torch.Tensor, K: torch.Tensor
                          ) -> torch.Tensor:
    """Energy functional mean(0.5 K |grad u|^2) (models/darcy.py:97-110)."""
    grad_u = torch.func.vmap(torch.func.grad(_u_single(model)))(x)
    return torch.mean(0.5 * K * torch.sum(grad_u ** 2, dim=1))


def neumann_boundary_mixed(model, x: torch.Tensor) -> torch.Tensor:
    """mean(tau_ver^2) on top/bottom points (models/darcy.py:88-94)."""
    return torch.mean(_net(model)(x)[:, 1] ** 2)


def neumann_boundary(model, x: torch.Tensor) -> torch.Tensor:
    """Primal-form Neumann penalty mean((du/dy)^2) on top/bottom points:
    coordinate 0 is y under the (y, x) ordering, as in the reference."""
    grad_u = torch.func.vmap(torch.func.grad(_u_single(model)))(x)
    return torch.mean(grad_u[:, 0] ** 2)

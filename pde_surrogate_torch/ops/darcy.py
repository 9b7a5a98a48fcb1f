"""Darcy-flow physics losses, linear law (NCHW).

Counterpart of pde_surrogate_tpu/ops/darcy.py (conv family and the
finite-volume objectives).  The PDE:

    div(K(s) grad u(s)) = 0   on (0,1)^2
    u = 1 at x=0 (left),  u = 0 at x=1 (right),  zero vertical flux top/bottom

Fields are (B, C, H, W) with output channels (u, sigma1, sigma2) =
(pressure, horizontal flux, vertical flux) and input K in channel 0.
The conv family takes its derivatives from the Sobel matrix stencils
(``ops.filters``); the finite-volume family (``fv_*``) uses the label
solver's own discretization (``solvers/fd_darcy``), and ``fvcg`` runs a
differentiable Jacobi PCG on it inside the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..solvers.fd_darcy import (_apply_operator, _face_conductivities,
                                _face_fluxes, _face_kx_ky, _faces_to_nodes,
                                _interior_mask, _laplacian)
from .filters import SobelFilter

__all__ = ["conv_constitutive_constraint", "conv_continuity_constraint",
           "conv_boundary_condition", "mixed_residual_loss",
           "fv_mixed_residual_loss", "fv_cg_u_error", "fv_cg_anchors",
           "fv_cg_error_loss", "reconstruct_pressure",
           "flux_pressure_consistency"]


def conv_constitutive_constraint(input: torch.Tensor, output: torch.Tensor,
                                 sobel: SobelFilter) -> torch.Tensor:
    """mean((sigma_hat - (-K grad u))^2) over both flux components
    (reference models/darcy.py:162-176).  input (B,1,H,W), output (B,3,H,W).
    """
    u = output[:, 0:1]
    est_sigma1 = -input * sobel.grad_h(u)
    est_sigma2 = -input * sobel.grad_v(u)
    return torch.mean((output[:, 1:2] - est_sigma1) ** 2
                      + (output[:, 2:3] - est_sigma2) ** 2)


def conv_continuity_constraint(output: torch.Tensor, sobel: SobelFilter,
                               use_tb: bool = True) -> torch.Tensor:
    """mean((d sigma1/dx + d sigma2/dy)^2) (models/darcy.py:210-224);
    ``use_tb=False`` leaves the top and bottom rows out of the mean."""
    div = (sobel.grad_h(output[:, 1:2]) + sobel.grad_v(output[:, 2:3])) ** 2
    if use_tb:
        return torch.mean(div)
    return torch.mean(div[:, :, 1:-1, :])


def conv_boundary_condition(output: torch.Tensor):
    """(dirichlet, neumann) boundary MSEs (models/darcy.py:226-233):
    u = 1 on the left column, u = 0 on the right, sigma2 = 0 on the top and
    bottom rows."""
    left = output[:, 0, :, 0]
    right = output[:, 0, :, -1]
    top_down_flux = output[:, 2, [0, -1], :]
    loss_dirichlet = torch.mean((left - 1.0) ** 2) + torch.mean(right ** 2)
    loss_neumann = torch.mean(top_down_flux ** 2)
    return loss_dirichlet, loss_neumann


def mixed_residual_loss(input: torch.Tensor, output: torch.Tensor,
                        sobel: SobelFilter, weight_bound: float = 10.0):
    """constitutive + continuity + weight_bound * boundary, linear law.

    Returns ``(loss, (pde, dirichlet, neumann))``.
    """
    constitutive = conv_constitutive_constraint(input, output, sobel)
    continuity = conv_continuity_constraint(output, sobel)
    dirichlet, neumann = conv_boundary_condition(output)
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


def _dirichlet_lift(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n): u = 1 on the left column, 0 elsewhere."""
    u_d = like.new_zeros(n, n)
    u_d[:, 0] = 1.0
    return u_d


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

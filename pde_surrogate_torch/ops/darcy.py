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

from ..parallel.halo import RowShard, exchange_rows, with_halo
from ..parallel.mesh import all_reduce_sum
from ..solvers.fd_darcy import (_at_walls, _dirichlet_lift,
                                _face_conductivities, _face_fluxes,
                                _faces_to_nodes, _interior_mask, _laplacian,
                                _wall_rows)
from ..utils.metrics import field_sum
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


def _wall_square_sum(t: torch.Tensor, rows: RowShard | None
                     ) -> torch.Tensor:
    """The sum of t^2 over the rows of t (..., h, n) on the top and bottom
    walls: on a row block, those it holds (``solvers/fd_darcy._wall_rows``)."""
    return sum((torch.sum(t[..., r, :] ** 2)
                for r in _wall_rows(rows, t.shape[-2])), t.new_zeros(()))


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
    h = div.shape[-2]
    top, bottom = _at_walls(rows)
    field_rows = h * (1 if rows is None else rows.size)
    count = div[:, :, :1].numel() * (field_rows - 2)
    return torch.sum(div[:, :, int(top):h - int(bottom), :]) / count


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
    return loss_dirichlet, (_wall_square_sum(output[:, 2], rows)
                            / output[:, 2, :2, :].numel())


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


def _halo(t: torch.Tensor, rows: RowShard | None):
    """One row of t from each neighbour of a row block (``exchange_rows``);
    ``(None, None)`` on the whole field."""
    return (None, None) if rows is None else exchange_rows(t, 1, 1, rows)


def _fv_halo(K: torch.Tensor, u: torch.Tensor, rows: RowShard | None):
    """``((K_above, K_below), (u_above, u_below))``: one row of K and of u
    from each neighbour of a row block, in one ``exchange_rows``."""
    if rows is None:
        return (None, None), (None, None)
    above, below = exchange_rows(torch.stack([K, u], 1), 1, 1, rows)
    return (above[:, 0], below[:, 0]), (above[:, 1], below[:, 1])


def _flux_mismatch(sigma: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                   rows: RowShard | None = None) -> torch.Tensor:
    """mean((sigma - face fluxes averaged to nodes)^2), sigma (B, 2, h, n)
    and the fluxes of ``solvers/fd_darcy._face_fluxes`` averaged as the
    labels are (``_faces_to_nodes``)."""
    ref = torch.stack(_faces_to_nodes(fx, fy, rows), dim=1)
    return _mean((sigma - ref) ** 2, rows)


def _dirichlet_neumann(output: torch.Tensor, rows: RowShard | None = None):
    """The FV objectives' boundary terms: u = 1 / u = 0 on the left / right
    columns, and sigma2 on the top and bottom rows (logged only); on a row
    block the partial sums, the wall rows on the edge blocks."""
    u = output[:, 0]
    dirichlet = (_mean((u[..., :, 0] - 1.0) ** 2, rows)
                 + _mean(u[..., :, -1] ** 2, rows))
    neumann = (_wall_square_sum(output[:, 2], rows)
               / output[:, 2, 0, :].numel())
    return dirichlet, neumann


def fv_mixed_residual_loss(input: torch.Tensor, output: torch.Tensor,
                           weight_bound: float = 10.0,
                           rows: RowShard | None = None, halo=None):
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

    On a row block (``rows``) ``input`` and ``output`` are the block's
    rows, ``halo`` the ``((K_above, K_below), (u_above, u_below))`` rows
    that the vertical faces read (exchanged with the neighbouring ranks
    when None), and the terms are this rank's partial sums.
    """
    K = input[:, 0]
    u = output[:, 0]
    h = 1.0 / (K.shape[-1] - 1)
    k_halo, u_halo = _fv_halo(K, u, rows) if halo is None else halo
    kx, fx, ky, fy = _face_fluxes(K, u, k_halo, u_halo, rows)
    # missing boundary faces contribute 0: the zero-flux mirror walls
    div = (F.pad(fx, (0, 1)) - F.pad(fx, (1, 0))
           + fy[..., 1:, :] - fy[..., :-1, :]) / h
    diag = (F.pad(kx, (0, 1)) + F.pad(kx, (1, 0))
            + ky[..., 1:, :] + ky[..., :-1, :]) / (h * h)
    r = div / torch.clamp(diag, min=1e-30)
    residual = _mean(r[..., :, 1:-1] ** 2, rows)
    flux_consistency = _flux_mismatch(output[:, 1:], fx, fy, rows)
    dirichlet, neumann = _dirichlet_neumann(output, rows)
    pde = residual + flux_consistency
    loss = pde + weight_bound * dirichlet
    return loss, (pde, dirichlet, neumann)


def _resolve_n_cg(n_cg: int | None, n: int) -> int:
    """The in-loss CG depth: ``None`` -> n iterations (kappa(A) ~ n^2 *
    contrast, so the Krylov depth that reaches the smooth error modes grows
    ~ n)."""
    return n if n_cg is None else n_cg


def _cg_pressure_errors(input: torch.Tensor, output: torch.Tensor,
                        n_cg: int | None = None,
                        rows: RowShard | None = None,
                        k_halo=None) -> torch.Tensor:
    """Per-field CG-recovered pressure error e_k, (B, n, n).

    ``n_cg`` Jacobi-PCG iterations on A(K) e = r(u_hat), r the FV residual
    of the predicted pressure, so u_hat + e_k approaches the FV solution
    whatever u_hat is.  Label-free: only K and the prediction enter.  The
    iterations run batched with per-field dots and the JAX package's
    guards (+1e-30 on both divisions, the diagonal clamped at 1e-30);
    autograd through the unrolled loop is the reverse mode of JAX's
    ``fori_loop``.  p and e stay zero on the Dirichlet columns, so the
    loop's matvec skips the input mask of ``A(v * mask) * mask``.

    On a row block (``rows``; ``k_halo`` one row of K from each neighbour,
    exchanged when None) e is the block's rows: every matvec exchanges one
    row of its input each side (``parallel.halo.exchange_rows``, under
    autograd) for the row-block Laplacian (``solvers/fd_darcy.
    _laplacian``), and each per-field dot is this block's partial sum
    all-reduced over the space group (``parallel.mesh.all_reduce_sum``,
    differentiable), in the one-process order: the first r.z, then p.Ap
    and r.z in every iteration, never fused.
    """
    K = input[:, 0]
    u = output[:, 0]
    n = K.shape[-1]
    n_cg = _resolve_n_cg(n_cg, n)
    mask = _interior_mask(n, K.dtype, K.device)[:K.shape[-2]]
    neg_mask = -mask
    u_d = _dirichlet_lift(n, K)[:K.shape[-2]]

    if k_halo is None:
        k_halo = _halo(K, rows)
    faces = _face_conductivities(K, *k_halo, rows)

    def lap(v, halo=None):
        return _laplacian(v, faces, *(halo or _halo(v, rows)))

    def dot(a, c):
        d = torch.sum(a * c, dim=(-2, -1), keepdim=True)
        return d if rows is None else all_reduce_sum(d, rows.group)

    # b = -A(u_d) on the interior columns; u_d is the same in every row, so
    # its halo rows are its own first row
    b = lap(u_d, (u_d[:1], u_d[:1])) * mask
    r = (b - lap((u - u_d) * mask) * neg_mask) * mask
    aE, aW, aN, aS = faces
    inv_diag = mask / torch.clamp(aE + aW + aN + aS, min=1e-30)
    e = torch.zeros_like(r)
    z = r * inv_diag
    p = z
    rz = dot(r, z)
    for _ in range(n_cg):
        ap = lap(p) * neg_mask
        alpha = rz / (dot(p, ap) + 1e-30)
        e = e + alpha * p
        r = r - alpha * ap
        z = r * inv_diag
        rz_new = dot(r, z)
        p = z + rz_new / (rz + 1e-30) * p
        rz = rz_new
    return e


def fv_cg_u_error(input: torch.Tensor, output: torch.Tensor,
                  n_cg: int | None = None,
                  rows: RowShard | None = None) -> torch.Tensor:
    """mean(e_k^2), the CG-recovered pressure-error estimate: the u term of
    ``fv_cg_error_loss`` and the u anchor of the ``sobel_fvcg`` hybrid (on
    a row block, this rank's partial sum)."""
    return _mean(_cg_pressure_errors(input, output, n_cg, rows) ** 2, rows)


def fv_cg_anchors(input: torch.Tensor, output: torch.Tensor,
                  n_cg: int | None = None, rows: RowShard | None = None):
    """Pressure and flux anchors from the CG-corrected pressure:
    ``(err_u, err_flux)`` with err_u = mean(e_k^2) and err_flux the flux
    channels against the conservative face fluxes of u_hat + e_k, averaged
    to nodes as the labels are.

    The Dirichlet columns of the corrected pressure are clamped to their
    exact values: e_k is zero there, and u_hat's own boundary error would
    otherwise pollute the boundary-adjacent flux target through the 1/h
    face gradient.

    On a row block (``rows``) both are this rank's partial sums: one row
    of K is exchanged each side for the faces, and the corrected pressure
    takes its own halo rows for its face fluxes.
    """
    K = input[:, 0]
    n = K.shape[-1]
    k_halo = _halo(K, rows)
    e = _cg_pressure_errors(input, output, n_cg, rows, k_halo)
    err_u = _mean(e ** 2, rows)
    u_corr = ((output[:, 0] + e)
              * _interior_mask(n, K.dtype, K.device)[:K.shape[-2]]
              + _dirichlet_lift(n, K)[:K.shape[-2]])
    _, fx, _, fy = _face_fluxes(K, u_corr, k_halo, _halo(u_corr, rows),
                                rows)
    return err_u, _flux_mismatch(output[:, 1:], fx, fy, rows)


def fv_cg_error_loss(input: torch.Tensor, output: torch.Tensor,
                     weight_bound: float = 10.0, n_cg: int | None = None,
                     rows: RowShard | None = None):
    """The CG-preconditioned error objective (JAX ops/darcy.py:389-433):
    pde = err_u + err_flux of ``fv_cg_anchors`` (n_cg PCG iterations on
    the FV residual inside the loss, so the objective sees the smooth error
    modes the raw residual cannot), plus ``weight_bound`` x dirichlet.
    Returns ``(loss, (pde, dirichlet, neumann))``; on a row block
    (``rows``) this rank's partial sums."""
    err_u, flux_consistency = fv_cg_anchors(input, output, n_cg, rows)
    dirichlet, neumann = _dirichlet_neumann(output, rows)
    pde = err_u + flux_consistency
    loss = pde + weight_bound * dirichlet
    return loss, (pde, dirichlet, neumann)


def reconstruct_pressure(input: torch.Tensor, output: torch.Tensor
                         ) -> torch.Tensor:
    """Pressure from the predicted horizontal flux, label-free, (B, H, W).

    u(x) = 1 - int_0^x sigma1_hat / K: trapezoid cumulative integral along x
    from both edges, blended linearly toward the nearer Dirichlet anchor.
    The spacing is 1/n, not 1/(n-1), because the Sobel operators scale by
    the image size n: a self-consistent net then scores exactly 0.  Each
    row is integrated alone, so a row block gives its own rows.
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


def flux_pressure_consistency(input: torch.Tensor, output: torch.Tensor,
                              rows: RowShard | None = None) -> torch.Tensor:
    """Label-free drift metric: batch mean of the rel-L2 between the net's u
    and the flux-integrated u (``reconstruct_pressure``); on a row block
    (``rows``) each sample's two norms are summed over the space group
    before the square roots."""
    u_hat = output[:, 0]
    u_rec = reconstruct_pressure(input, output)
    num = torch.sqrt(field_sum((u_hat - u_rec) ** 2, rows))
    den = torch.sqrt(field_sum(u_rec ** 2, rows))
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

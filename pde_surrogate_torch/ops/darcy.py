"""Darcy-flow physics losses, conv family, linear law (NCHW).

Counterpart of pde_surrogate_tpu/ops/darcy.py (conv family).  The PDE:

    div(K(s) grad u(s)) = 0   on (0,1)^2
    u = 1 at x=0 (left),  u = 0 at x=1 (right),  zero vertical flux top/bottom

Fields are (B, C, H, W) with output channels (u, sigma1, sigma2) =
(pressure, horizontal flux, vertical flux) and input K in channel 0.
Derivatives come from the Sobel matrix stencils (``ops.filters``).
"""

from __future__ import annotations

import torch

from .filters import SobelFilter

__all__ = ["conv_constitutive_constraint", "conv_continuity_constraint",
           "conv_boundary_condition", "mixed_residual_loss",
           "reconstruct_pressure", "flux_pressure_consistency"]


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

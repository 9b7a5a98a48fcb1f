"""The Darcy mixed-residual loss, as the source repository's
``models/darcy.py`` and ``utils/image_gradient.py`` write it: 3x3 Sobel
correlations of replicate-padded fields, scaled by the grid size, with the
one-sided boundary modifier; constitutive + continuity residuals plus the
weighted Dirichlet and Neumann boundary terms.  The program forms the same
operators as matrix products; this file keeps the convolutions."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_sided(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The boundary modifier: on the first and last lines along ``dim``,
    4 g - g(next inner line), which with the replicate-padded Sobel value
    there is a 3-point one-sided difference."""
    n = g.shape[dim]
    first = 4.0 * g.narrow(dim, 0, 1) - g.narrow(dim, 1, 1)
    last = 4.0 * g.narrow(dim, n - 1, 1) - g.narrow(dim, n - 2, 1)
    return torch.cat([first, g.narrow(dim, 1, n - 2), last], dim=dim)


def _pad_replicate(u: torch.Tensor) -> torch.Tensor:
    """One replicated edge line on each side of H and W (concatenations,
    whose backward is deterministic on the card)."""
    u = torch.cat([u[..., :1, :], u, u[..., -1:, :]], dim=-2)
    return torch.cat([u[..., :1], u, u[..., -1:]], dim=-1)


def _sobel(u: torch.Tensor, horizontal: bool) -> torch.Tensor:
    smooth = torch.tensor([1.0, 2.0, 1.0], dtype=u.dtype, device=u.device)
    diff = torch.tensor([-1.0, 0.0, 1.0], dtype=u.dtype, device=u.device)
    k = (smooth[:, None] * diff[None, :] if horizontal
         else diff[:, None] * smooth[None, :]) / 8.0
    g = F.conv2d(_pad_replicate(u), k[None, None])
    return g * u.shape[-1]


def grad_h(u: torch.Tensor) -> torch.Tensor:
    """d/dx (along W) of (B, 1, n, n) fields on the unit square."""
    return _one_sided(_sobel(u, True), -1)


def grad_v(u: torch.Tensor) -> torch.Tensor:
    """d/dy (along H) of (B, 1, n, n) fields on the unit square."""
    return _one_sided(_sobel(u, False), -2)


def mixed_residual_loss(k: torch.Tensor, out: torch.Tensor,
                        weight_bound: float) -> torch.Tensor:
    """``k`` (B, 1, n, n), ``out`` (B, 3, n, n) = (u, sigma1, sigma2)."""
    u, s1, s2 = out[:, 0:1], out[:, 1:2], out[:, 2:3]
    constitutive = torch.mean((s1 + k * grad_h(u)) ** 2
                              + (s2 + k * grad_v(u)) ** 2)
    continuity = torch.mean((grad_h(s1) + grad_v(s2)) ** 2)
    dirichlet = (torch.mean((out[:, 0, :, 0] - 1.0) ** 2)
                 + torch.mean(out[:, 0, :, -1] ** 2))
    walls = torch.cat([out[:, 2, :1, :], out[:, 2, -1:, :]], dim=1)
    neumann = torch.mean(walls ** 2)
    return constitutive + continuity + weight_bound * (dirichlet + neumann)

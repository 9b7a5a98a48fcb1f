"""Finite-volume Darcy labels: the linear label path of the dataset factory.

Counterpart of pde_surrogate_tpu/solvers/fd_darcy.py (linear path only):

    div(K(s) grad u(s)) = 0        on (0,1)^2
    u = 1 at x=0,  u = 0 at x=1,   zero vertical flux at y in {0,1}

on the node-centred 5-point grid (h = 1/(n-1)) with harmonic-mean face
conductivities.  ``solve_darcy_batch_fast`` solves the pressure with the
fixed-iteration PCG (``ops/kernels/cg_darcy``: the CUDA kernel on a CUDA
tensor, its plain twin on a CPU tensor) and ``darcy_fields`` turns it into
the dataset's (u, sigma1, sigma2) channels.  The operator helpers
(``_face_conductivities``, ``_apply_operator``, ``_interior_mask``) take
fields with any leading batch dims, (..., n, n), and serve the in-loss PCG
of ``ops/darcy``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.cg_darcy import _harm, solve_darcy_cg

__all__ = ["darcy_fields", "solve_darcy_batch_fast"]


def _face_kx_ky(K: torch.Tensor):
    """Harmonic-mean conductivities of the vertical faces (..., n, n-1) and
    the horizontal faces (..., n-1, n) of K (..., n, n)."""
    return (_harm(K[..., :, :-1], K[..., :, 1:]),
            _harm(K[..., :-1, :], K[..., 1:, :]))


def _face_fluxes(kx: torch.Tensor, ky: torch.Tensor, u: torch.Tensor):
    """Conservative face fluxes of u (..., n, n) through the faces of
    ``_face_kx_ky``: fx (..., n, n-1), fy (..., n-1, n)."""
    h = 1.0 / (u.shape[-1] - 1)
    fx = -kx * (u[..., :, 1:] - u[..., :, :-1]) / h
    fy = -ky * (u[..., 1:, :] - u[..., :-1, :]) / h
    return fx, fy


def _face_conductivities(K: torch.Tensor):
    """Harmonic-mean conductivities on the east/west/north/south faces of
    every node of K (..., n, n) (rows = y, cols = x), each (..., n, n), zero
    where the face leaves the domain (top/bottom: built-in zero flux)."""
    kx, ky = _face_kx_ky(K)
    return (F.pad(kx, (0, 1)), F.pad(kx, (1, 0)),
            F.pad(ky, (0, 0, 1, 0)), F.pad(ky, (0, 0, 0, 1)))


def _laplacian(v: torch.Tensor, faces) -> torch.Tensor:
    """div(K grad v) * h^2 at every node, v taken as zero outside the grid.

    One zero pad of v gives the four neighbour shifts as views.
    """
    aE, aW, aN, aS = faces
    vp = F.pad(v, (1, 1, 1, 1))
    return (aE * (vp[..., 1:-1, 2:] - v) + aW * (vp[..., 1:-1, :-2] - v)
            + aN * (vp[..., :-2, 1:-1] - v) + aS * (vp[..., 2:, 1:-1] - v))


def _apply_operator(v: torch.Tensor, faces) -> torch.Tensor:
    """A v for the 5-point operator, v zero on the Dirichlet columns:
    -div(K grad v) * h^2 on the interior columns and the identity on the
    two Dirichlet columns, which keeps the operator SPD on the constrained
    subspace."""
    n = v.shape[-1]
    col = torch.arange(n, device=v.device)
    return torch.where((col == 0) | (col == n - 1), v, -_laplacian(v, faces))


def _interior_mask(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, n): 1 on the interior columns, 0 on the two Dirichlet columns."""
    m = torch.ones(n, n, dtype=dtype, device=device)
    m[:, 0] = 0.0
    m[:, -1] = 0.0
    return m


def _faces_to_nodes(fx: torch.Tensor, fy: torch.Tensor):
    """Average face fluxes to nodes; zero vertical flux on top/bottom walls.

    The load-bearing label convention: conservative face fluxes averaged to
    nodes, one-sided (edge-replicated) at the domain boundary, exact Neumann
    values on the horizontal walls.
    """
    sigma1 = (torch.cat([fx, fx[..., -1:]], -1)
              + torch.cat([fx[..., :1], fx], -1)) / 2.0
    sigma2 = (torch.cat([fy, fy[..., -1:, :]], -2)
              + torch.cat([fy[..., :1, :], fy], -2)) / 2.0
    sigma2[..., 0, :] = 0.0
    sigma2[..., -1, :] = 0.0
    return sigma1, sigma2


def darcy_fields(K: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stack (u, sigma1, sigma2) = (pressure, horizontal flux, vertical
    flux): (..., n, n) inputs -> (..., 3, n, n), the dataset channel layout.

    Fluxes are conservative face fluxes averaged to nodes (discretely
    divergence-free), not ``-K_node * grad_fd(u)``.
    """
    sigma1, sigma2 = _faces_to_nodes(*_face_fluxes(*_face_kx_ky(K), u))
    return torch.stack([u, sigma1, sigma2], dim=-3)


def solve_darcy_batch_fast(K_batch: torch.Tensor,
                           n_iter: int | None = None) -> torch.Tensor:
    """(B, n, n) permeabilities -> (B, 3, n, n) labels.

    ``n_iter`` defaults to ``24 * n`` (1536 at 64x64): sized at 64x64 for
    channelized contrast (K ratio 100, the hardest shipped family) and
    scaled with the grid size, as CG iteration counts grow ~1/h.  A CUDA
    tensor goes through the CUDA kernel or raises; a CPU tensor through the
    kernel's plain twin.  (The JAX package's CPU path is the tolerance
    solver instead, so CPU labels of the two packages agree to the solver
    bound, not bitwise.)
    """
    if n_iter is None:
        n_iter = 24 * K_batch.shape[-1]
    u = solve_darcy_cg(K_batch, n_iter)
    return darcy_fields(K_batch, u)

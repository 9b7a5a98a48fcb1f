"""Spatial (domain-decomposition) parallelism: the Darcy solve with its rows
sharded over ranks.

Counterpart of pde_surrogate_tpu/parallel/spatial.py.  Fields are split
along H over a ``('space',)`` mesh; rank r holds rows
``[r n/P, (r+1) n/P)``.  Every Jacobi-PCG iteration touches the local rows
plus one halo row from each neighbour (``parallel.halo.exchange_rows``,
point to point), and each dot product is a local sum plus one all-reduce
of the per-field partials, so the traffic per iteration is O(W) whatever
H is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..solvers.fd_darcy import _face_conductivities, _laplacian
from .halo import RowShard, exchange_rows
from .mesh import Mesh, _mesh, all_gather

__all__ = ["spatial_mesh", "solve_darcy_spatial", "gather_rows"]


def spatial_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The ``('space',)`` mesh over every rank of the process group."""
    return _mesh(n_devices, device, "space")


def solve_darcy_spatial(K: torch.Tensor, mesh: Mesh, n_iter: int = 2000
                        ) -> torch.Tensor:
    """Darcy pressure of ``K`` (n, n) or (B, n, n) with H sharded over
    ``mesh``; returns this rank's rows of u on ``mesh.device``
    (``gather_rows`` assembles the field).

    Every rank passes the whole field.  The discretisation is the PCG
    label solver's: harmonic-mean faces, zero flux through the top and
    bottom walls (kN = 0 on global row 0, kS = 0 on global row n-1), the
    Dirichlet columns (u = 1 left, 0 right) eliminated, Jacobi-PCG for a
    fixed ``n_iter`` with per-field alpha and beta and the JAX package's
    1e-30 guards.  The faces and the matvec are the row-block ones of
    ``solvers/fd_darcy`` (``_face_conductivities``, ``_laplacian``),
    shared with the in-loss PCG on a data x space
    mesh; the halo rows come from ``parallel.halo.exchange_rows``.

    The exchange is NOT circular: rank 0 gets zeros above and the last
    rank zeros below.  The JAX package's ``ppermute`` ring is circular, so
    its edge shards receive the opposite edge of the domain; there, as
    here, the halo is multiplied by the wall faces' conductivity, which is
    zero, so both give the same solve.
    """
    n = K.shape[-1]
    P = mesh.world_size
    if K.shape[-2] % P:
        raise ValueError(f"H={K.shape[-2]} not divisible by the mesh's {P} "
                         f"ranks")
    rows = K.shape[-2] // P
    r0 = mesh.rank * rows
    K_local = K[..., r0:r0 + rows, :].to(mesh.device)
    shard = RowShard(mesh.group, mesh.rank, P)
    faces = _face_conductivities(
        K_local, *exchange_rows(K_local, 1, 1, shard), shard)
    kE, kW, kN, kS = faces
    mask = torch.ones(n, dtype=K_local.dtype, device=mesh.device)
    mask[0] = mask[-1] = 0.0
    mask = mask.expand_as(K_local)
    inv_diag = mask / torch.clamp(kE + kW + kN + kS, min=1e-30)

    def matvec(v):
        return -_laplacian(v, faces, *exchange_rows(v, 1, 1, shard)) * mask

    def dot(a, b):
        # per-field CG scalars: the local rows' sum, then the mesh's
        s = torch.sum(a * b, dim=(-2, -1), keepdim=True)
        dist.all_reduce(s, group=mesh.group)
        return s

    b = torch.zeros_like(K_local)
    b[..., :, 1] = kW[..., :, 1]
    v = torch.zeros_like(K_local)
    r = b
    z = r * inv_diag
    p = z
    rz = dot(r, z)
    for _ in range(n_iter):
        ap = matvec(p)
        alpha = rz / (dot(p, ap) + 1e-30)
        v = v + alpha * p
        r = r - alpha * ap
        z = r * inv_diag
        rz_new = dot(r, z)
        p = z + rz_new / (rz + 1e-30) * p
        rz = rz_new
    u = v * mask
    u[..., :, 0] = 1.0
    return u


def gather_rows(u_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole field from every rank's rows (on every rank)."""
    return all_gather(u_local, mesh, dim=-2)

"""Finite-volume Darcy solvers: the label path of the dataset factory and
the solvers' oracles.

Counterpart of pde_surrogate_tpu/solvers/fd_darcy.py:

    div(K(s) grad u(s)) = 0        on (0,1)^2
    u = 1 at x=0,  u = 0 at x=1,   zero vertical flux at y in {0,1}

on the node-centred 5-point grid (h = 1/(n-1)) with harmonic-mean face
conductivities.

* ``solve_darcy_batch_fast`` solves the pressure with the fixed-iteration
  PCG (``ops/kernels/cg_darcy``: the CUDA kernel on a CUDA tensor, its
  plain twin on a CPU tensor) and ``darcy_fields`` turns it into the
  dataset's (u, sigma1, sigma2) channels.
* ``solve_darcy`` / ``solve_darcy_batch`` are the tolerance solver: Jacobi
  PCG with ``jax.scipy.sparse.linalg.cg``'s stopping rule, batched with
  converged fields frozen on the device (``_pcg``).
* ``solve_nonlinear_darcy`` solves the polynomial law
  -K grad u = sigma + alpha1 sqrt(K) sigma^2 + alpha2 K sigma^3 by damped
  Newton on the pressure (the FV-Newton oracle that replaces the
  reference's FEniCS); the face fluxes come from ``_sigma_from_grad``, a
  componentwise cubic solve with an implicit derivative.

The operator helpers (``_face_conductivities``, ``_laplacian``,
``_face_fluxes``, ``_faces_to_nodes``, ``_interior_mask``) take fields
with any leading batch dims, (..., n, n), or a row block (..., h, n) of a
field split along H with one row from each neighbour, and serve the
in-loss objectives of ``ops/darcy`` and the row-sharded solve of
``parallel/spatial`` too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.cg_darcy import _harm, solve_darcy_cg

__all__ = ["darcy_fields", "solve_darcy", "solve_darcy_batch",
           "solve_darcy_batch_fast", "solve_nonlinear_darcy"]


def _at_walls(rows) -> tuple[bool, bool]:
    """Whether the whole field (``rows`` None) or the row block ``rows``
    (a ``parallel.halo.RowShard``) touches the top and the bottom wall."""
    return (rows is None or rows.index == 0,
            rows is None or rows.index == rows.size - 1)


def _wall_rows(rows, h: int) -> list[int]:
    """The rows of a block of ``h`` rows (``rows``, as ``_at_walls``) on
    the top and bottom walls."""
    top, bottom = _at_walls(rows)
    return ([0] if top else []) + ([h - 1] if bottom else [])


def _with_rows(t: torch.Tensor, above, below) -> torch.Tensor:
    """t (..., h, n) with one row above and one below: the neighbours'
    rows, or t's own edge rows where they are None (a wall of the whole
    field, where the faces that read them are zero)."""
    return torch.cat([t[..., :1, :] if above is None else above, t,
                      t[..., -1:, :] if below is None else below], -2)


def _vertical_faces(K: torch.Tensor, above=None, below=None, rows=None
                    ) -> torch.Tensor:
    """The harmonic conductivities of the h + 1 horizontal faces around a
    row block K (..., h, n) of a field split along H (``rows``; None: the
    whole field), from the face above its first row to the face below its
    last; ``above`` / ``below`` are one row of K from each neighbour
    (None or anything at a wall).  A face through the top or bottom wall
    is zero: the built-in zero flux."""
    kp = _with_rows(K, above, below)
    ky = _harm(kp[..., :-1, :], kp[..., 1:, :])
    top, bottom = _at_walls(rows)
    if top or bottom:
        keep = torch.ones_like(ky[..., :, :1])
        if top:
            keep[..., 0, :] = 0.0
        if bottom:
            keep[..., -1, :] = 0.0
        ky = ky * keep
    return ky


def _face_conductivities(K: torch.Tensor, above=None, below=None,
                         rows=None):
    """Harmonic-mean conductivities on the east/west/north/south faces of
    every node of K (..., h, n) (rows = y, cols = x), each (..., h, n),
    zero where the face leaves the domain (top/bottom: built-in zero
    flux); on a row block the arguments of ``_vertical_faces``."""
    kx = _harm(K[..., :, :-1], K[..., :, 1:])
    ky = _vertical_faces(K, above, below, rows)
    return (F.pad(kx, (0, 1)), F.pad(kx, (1, 0)), ky[..., :-1, :],
            ky[..., 1:, :])


def _laplacian(v: torch.Tensor, faces, above=None, below=None
               ) -> torch.Tensor:
    """div(K grad v) * h^2 at every node of v (..., h, n), v taken as zero
    outside the grid, or on a row block with ``above`` / ``below`` the
    neighbours' rows next to it (zero at a wall, where the faces are zero
    too).  The label solvers' PCGs, the row-sharded one
    (``parallel/spatial.py``) and the in-loss PCG (``ops/darcy.py``)
    share it.

    One pad of v gives the four neighbour shifts as views.
    """
    aE, aW, aN, aS = faces
    if above is None:
        vp = F.pad(v, (1, 1, 1, 1))
    else:
        vp = F.pad(torch.cat([above, v, below], -2), (1, 1))
    return (aE * (vp[..., 1:-1, 2:] - v) + aW * (vp[..., 1:-1, :-2] - v)
            + aN * (vp[..., :-2, 1:-1] - v) + aS * (vp[..., 2:, 1:-1] - v))


def _face_fluxes(K: torch.Tensor, u: torch.Tensor, k_halo=(None, None),
                 u_halo=(None, None), rows=None):
    """The conservative fluxes of u around the nodes of K and u
    (..., h, n), the whole field or a row block (``rows``; ``k_halo`` /
    ``u_halo`` one row of K / u from each neighbour): ``(kx, fx)`` on
    the vertical faces (..., h, n-1); ``(ky, fy)`` on the h + 1
    horizontal faces from the one above the first row to the one below
    the last, zero through the top and bottom walls."""
    h = 1.0 / (K.shape[-1] - 1)
    kx = _harm(K[..., :, :-1], K[..., :, 1:])
    fx = -kx * (u[..., :, 1:] - u[..., :, :-1]) / h
    ky = _vertical_faces(K, *k_halo, rows)
    up = _with_rows(u, *u_halo)
    fy = -ky * (up[..., 1:, :] - up[..., :-1, :]) / h
    return kx, fx, ky, fy


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


def _faces_to_nodes(fx: torch.Tensor, fy: torch.Tensor, rows=None):
    """Average face fluxes to nodes: fx (..., h, n-1) and the h + 1
    horizontal faces fy of ``_face_fluxes``; zero vertical flux on the
    top and bottom walls (those a row block ``rows`` holds).

    The load-bearing label convention: conservative face fluxes averaged to
    nodes, one-sided (edge-replicated) at the domain boundary, exact Neumann
    values on the horizontal walls.
    """
    sigma1 = (torch.cat([fx, fx[..., -1:]], -1)
              + torch.cat([fx[..., :1], fx], -1)) / 2.0
    sigma2 = (fy[..., 1:, :] + fy[..., :-1, :]) / 2.0
    for r in _wall_rows(rows, sigma2.shape[-2]):
        sigma2[..., r, :] = 0.0
    return sigma1, sigma2


def darcy_fields(K: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stack (u, sigma1, sigma2) = (pressure, horizontal flux, vertical
    flux): (..., n, n) inputs -> (..., 3, n, n), the dataset channel layout.

    Fluxes are conservative face fluxes averaged to nodes (discretely
    divergence-free), not ``-K_node * grad_fd(u)``.
    """
    _, fx, _, fy = _face_fluxes(K, u)
    return torch.stack([u, *_faces_to_nodes(fx, fy)], dim=-3)


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


def _dirichlet_lift(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n): u = 1 on the left column, 0 elsewhere."""
    u_d = like.new_zeros(n, n)
    u_d[:, 0] = 1.0
    return u_d


# iterations between two reads of the tolerance PCG's stop flag by the host
_CHECK_EVERY = 32


def _pcg(matvec, b: torch.Tensor, inv_diag: torch.Tensor, tol: float,
         maxiter: int) -> torch.Tensor:
    """Jacobi-preconditioned CG from x0 = 0 with the semantics of
    ``jax.scipy.sparse.linalg.cg(matvec, b, tol=tol, maxiter=maxiter,
    M=lambda v: v * inv_diag)``, for every field of b (..., n, n) at once.

    A field iterates while r.r > (tol ||b||)^2 and it has taken fewer than
    ``maxiter`` iterations; gamma = r.z on the preconditioned residual and
    no guard on the divisions, as in JAX.  A field that meets the test is
    frozen on the device (``torch.where``), so the host reads the stop
    flag only every ``_CHECK_EVERY`` iterations and the answer is that of a
    check at every iteration.
    """
    def dot(a, c):
        return torch.sum(a * c, dim=(-2, -1), keepdim=True)

    atol2 = tol * tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = r * inv_diag
    p = z
    gamma = dot(r, z)
    for k in range(maxiter):
        active = dot(r, r) > atol2
        if k % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        ap = matvec(p)
        alpha = gamma / dot(p, ap)
        r_new = r - alpha * ap
        z = r_new * inv_diag
        gamma_new = dot(r_new, z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


def solve_darcy(K: torch.Tensor, tol: float = 1e-8, maxiter: int = 4000
                ) -> torch.Tensor:
    """Pressure u (..., n, n) of the linear law for K (..., n, n).

    Jacobi PCG on the eliminated-Dirichlet system until r.r <= (tol
    ||b||)^2 or ``maxiter`` iterations, per field (``_pcg``).  In float32
    the default tolerances are below the rounding floor (~6.5e-6 relative
    at 64^2), so the solve runs ``maxiter`` iterations, as the JAX
    package's does.
    """
    n = K.shape[-1]
    faces = _face_conductivities(K)
    aE, aW, aN, aS = faces
    mask = _interior_mask(n, K.dtype, K.device)
    u_d = _dirichlet_lift(n, K)
    b = -_apply_operator(u_d, faces) * mask
    inv_diag = mask / torch.clamp(aE + aW + aN + aS, min=1e-30) + (1.0 - mask)

    def matvec(v):
        return _apply_operator(v * mask, faces) * mask + v * (1.0 - mask)

    v = _pcg(matvec, b, inv_diag, tol, maxiter)
    return u_d + v * mask


def solve_darcy_batch(K_batch: torch.Tensor, tol: float = 1e-8,
                      maxiter: int = 4000) -> torch.Tensor:
    """(B, n, n) permeabilities -> (B, 3, n, n) fields by the tolerance
    solver."""
    return darcy_fields(K_batch, solve_darcy(K_batch, tol, maxiter))


def _grad_fd(u: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Second-order FD gradient along ``axis`` (central inside, one-sided
    3-point at both ends)."""
    u = torch.movedim(u, axis, -1)
    interior = (u[..., 2:] - u[..., :-2]) / (2 * h)
    first = (-3 * u[..., 0] + 4 * u[..., 1] - u[..., 2]) / (2 * h)
    last = (3 * u[..., -1] - 4 * u[..., -2] + u[..., -3]) / (2 * h)
    g = torch.cat([first[..., None], interior, last[..., None]], dim=-1)
    return torch.movedim(g, -1, axis)


def _cubic_terms(K, g, s, alpha1: float, alpha2: float):
    """(f_sigma, f_K) of f(s; K, g) = s + a1 sqrt(K) s^2 + a2 K s^3 + K g,
    with sqrt(K) kept off zero in f_K; f_g is K."""
    sq_k = torch.sqrt(K)
    f_sigma = 1.0 + 2.0 * alpha1 * sq_k * s + 3.0 * alpha2 * K * s * s
    f_k = (alpha1 * s * s / (2.0 * torch.clamp(sq_k, min=1e-30))
           + alpha2 * s ** 3 + g)
    return f_sigma, f_k


class _SigmaFromGrad(torch.autograd.Function):
    """sigma of sigma + a1 sqrt(K) sigma^2 + a2 K sigma^3 = -K g,
    componentwise, with the implicit derivative ds = -(f_K dK + f_g dg) /
    f_sigma in both modes (JAX fd_darcy.py:212-247)."""

    @staticmethod
    def forward(K, g, alpha1, alpha2, newton_iters):
        rhs = -K * g
        sq_k = torch.sqrt(K)
        s = rhs                                   # the linear law's sigma
        for _ in range(newton_iters):
            f = s + alpha1 * sq_k * s * s + alpha2 * K * s ** 3 - rhs
            fp = 1.0 + 2.0 * alpha1 * sq_k * s + 3.0 * alpha2 * K * s * s
            s = s - f / fp
        return s

    @staticmethod
    def setup_context(ctx, inputs, output):
        K, g, alpha1, alpha2, _ = inputs
        ctx.alphas = (alpha1, alpha2)
        ctx.save_for_backward(K, g, output)
        ctx.save_for_forward(K, g, output)

    @staticmethod
    def backward(ctx, grad_s):
        K, g, s = ctx.saved_tensors
        f_sigma, f_k = _cubic_terms(K, g, s, *ctx.alphas)
        w = -grad_s / f_sigma
        return w * f_k, w * K, None, None, None

    @staticmethod
    def jvp(ctx, dK, dg, *_):
        K, g, s = ctx.saved_tensors
        f_sigma, f_k = _cubic_terms(K, g, s, *ctx.alphas)
        num = 0.0
        if dK is not None:
            num = f_k * dK
        if dg is not None:
            num = num + K * dg
        return -num / f_sigma


def _sigma_from_grad(K: torch.Tensor, g: torch.Tensor, alpha1: float,
                     alpha2: float, newton_iters: int = 20) -> torch.Tensor:
    """Componentwise solve of sigma + a1 sqrt(K) sigma^2 + a2 K sigma^3 =
    -K g by ``newton_iters`` scalar Newton sweeps from the linear guess.
    The cubic is strictly monotone for a2 >= a1^2/3.  Differentiable in
    reverse and forward mode by the implicit function theorem, never
    through the sweeps."""
    return _SigmaFromGrad.apply(K, g, alpha1, alpha2, newton_iters)


class _NonlinearFV:
    """The nonlinear law's finite-volume residual for K (..., n, n):
    N(v) = div sigma(grad u) on the interior columns, u = u_d + v * mask,
    harmonic face permeabilities, zero flux through the top and bottom
    walls (JAX fd_darcy.py:270-292)."""

    def __init__(self, K: torch.Tensor, alpha1: float, alpha2: float):
        n = K.shape[-1]
        self.h = 1.0 / (n - 1)
        self.alphas = (alpha1, alpha2)
        self.mask = _interior_mask(n, K.dtype, K.device)
        self.u_d = _dirichlet_lift(n, K)
        self.kx = _harm(K[..., :, :-1], K[..., :, 1:])
        self.ky = _vertical_faces(K)[..., 1:-1, :]

    def _grads(self, w):
        return ((w[..., :, 1:] - w[..., :, :-1]) / self.h,
                (w[..., 1:, :] - w[..., :-1, :]) / self.h)

    def fluxes(self, v):
        gx, gy = self._grads(self.u_d + v * self.mask)
        return (_sigma_from_grad(self.kx, gx, *self.alphas),
                _sigma_from_grad(self.ky, gy, *self.alphas))

    def div_of(self, sx, sy):
        div = (F.pad(sx, (0, 1)) - F.pad(sx, (1, 0))
               + F.pad(sy, (0, 0, 0, 1)) - F.pad(sy, (0, 0, 1, 0)))
        return div / self.h * self.mask

    def residual(self, v):
        return self.div_of(*self.fluxes(v))

    def linearize(self, v):
        """(N(v), J, inv_diag) at v: the residual, the Jacobian matvec and
        the Jacobi preconditioner, from one flux solve.

        J is ``jax.jvp(residual)`` assembled once: the derivative of a face
        flux with respect to its gradient is -K / f_sigma(sigma) (f_K
        drops out, K being fixed), so J is the linear FV operator on the
        linearised face conductivities K_eff = K / f_sigma, and each CG
        iteration costs one stencil instead of the 20 Newton sweeps of the
        flux solve.  diag(J) ~= the sum of the adjacent K_eff / h^2.
        """
        sx, sy = self.fluxes(v)
        r = self.div_of(sx, sy)
        a1, a2 = self.alphas
        kx_eff = self.kx / (1.0 + 2.0 * a1 * torch.sqrt(self.kx) * sx
                            + 3.0 * a2 * self.kx * sx * sx)
        ky_eff = self.ky / (1.0 + 2.0 * a1 * torch.sqrt(self.ky) * sy
                            + 3.0 * a2 * self.ky * sy * sy)
        diag = (F.pad(kx_eff, (0, 1)) + F.pad(kx_eff, (1, 0))
                + F.pad(ky_eff, (0, 0, 0, 1)) + F.pad(ky_eff, (0, 0, 1, 0)))
        diag = diag / (self.h * self.h)
        inv_diag = (self.mask / torch.clamp(diag, min=1e-30)
                    + (1.0 - self.mask))

        def jac(dv):
            gx, gy = self._grads(dv * self.mask)
            return self.div_of(-kx_eff * gx, -ky_eff * gy)

        return r, jac, inv_diag


def solve_nonlinear_darcy(K: torch.Tensor, alpha1: float = 1.0,
                          alpha2: float = 1.0, newton_iters: int = 12,
                          cg_tol: float = 1e-6, cg_maxiter: int = 2000
                          ) -> torch.Tensor:
    """(u, sigma1, sigma2) of the nonlinear law for K (..., n, n), as
    (..., 3, n, n): the FV-Newton oracle (JAX fd_darcy.py:250-341, in
    place of the reference's FEniCS, utils/fenics.py:13-91).

    Warm start from the linear law (``solve_darcy``), then
    ``newton_iters`` damped Newton steps on the pressure: J dv = -N(v) by
    Jacobi PCG (``_pcg``, the same stopping rule), and of the steps
    {1, 1/2, ..., 1/16} the one with the smallest residual norm if it is
    below the current one (a NaN candidate never wins).  The fluxes are
    the conservative face fluxes averaged to nodes, the linear path's
    label convention (``_faces_to_nodes``).
    """
    if alpha2 < (alpha1 ** 2) / 3.0 - 1e-12:
        # f'(sigma) must have no real root, or the componentwise Newton can
        # divide by ~0 and the implicit derivative blows up
        raise ValueError(
            f"nonlinear law needs alpha2 >= alpha1^2/3 for monotonicity "
            f"(got alpha1={alpha1}, alpha2={alpha2}, "
            f"alpha1^2/3={alpha1 ** 2 / 3.0:.4g})")
    fv = _NonlinearFV(K, alpha1, alpha2)

    def norm2(a):
        return torch.sum(a * a, dim=(-2, -1), keepdim=True)

    v = (solve_darcy(K, tol=cg_tol, maxiter=cg_maxiter) - fv.u_d) * fv.mask
    for _ in range(newton_iters):
        r, jac, inv_diag = fv.linearize(v)
        dv = _pcg(jac, -r, inv_diag, cg_tol, cg_maxiter)
        best_v, best_norm = v, norm2(r)
        for k in range(5):
            cand = v + dv * (0.5 ** k)
            norm = norm2(fv.residual(cand))
            better = norm < best_norm
            best_v = torch.where(better, cand, best_v)
            best_norm = torch.where(better, norm, best_norm)
        v = best_v
    u = fv.u_d + v * fv.mask
    sx, sy = fv.fluxes(v)
    sigma1, sigma2 = _faces_to_nodes(sx, F.pad(sy, (0, 0, 1, 1)))
    return torch.stack([u, sigma1, sigma2], dim=-3)

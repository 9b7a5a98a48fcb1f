"""Random permeability-field generators (GRF-KLE, warped GRF, channelized).

The reference *downloads* its input families (scripts/download_datasets.sh;
naming at train_codec_mixed_residual.py:128-139): Gaussian random fields with
truncated Karhunen-Loeve expansions (kle{100,128,512,1024,2048}), warped
GRFs, and channelized fields.  This module generates statistically matching
families locally, so the framework is self-contained (and the GPU solves the
PDE labels — see solvers.fd_darcy).  numpy copy of
pde_surrogate_tpu/data/grf.py: the same seed gives byte-identical fields.

KLE construction: the log-permeability is a zero-mean GRF with separable
exponential covariance

    c(s, s') = exp(-|x-x'|/l - |y-y'|/l)

whose 2-D KLE eigenpairs are exact products of 1-D eigenpairs — so the basis
costs two n x n symmetric eigendecompositions instead of an (n^2)^2 one.
Sampling is a single (n_terms x n^2) matmul per batch.

KLE coefficients are drawn by Latin-hypercube sampling mapped through the
standard-normal quantile (the datasets are named ``kle512_lhs10000_*``:
LHS designs over the KLE coefficients).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
from scipy import special as _special  # erfinv for normal quantile

from ..ops.lhs import lhs

__all__ = ["KLEBasis", "kle_basis", "sample_kle_logk", "sample_kle",
           "sample_warped_grf", "sample_channelized", "norm_ppf"]


class KLEBasis(NamedTuple):
    """Truncated KLE basis: eigvals (k,), modes (k, n, n)."""
    eigvals: np.ndarray
    modes: np.ndarray
    length_scale: float


def _exp_cov_1d(n: int, length_scale: float) -> np.ndarray:
    x = np.linspace(0.0, 1.0, n)
    return np.exp(-np.abs(x[:, None] - x[None, :]) / length_scale)


@functools.lru_cache(maxsize=8)
def kle_basis(n: int, n_terms: int, length_scale: float = 0.25) -> KLEBasis:
    """Top ``n_terms`` KLE eigenpairs of the separable exponential GRF.

    2-D eigenpairs are tensor products of the 1-D ones; we enumerate the
    n_terms largest lambda_i * lambda_j products.
    """
    c1 = _exp_cov_1d(n, length_scale) / n  # 1/n: discrete quadrature weight
    w1, v1 = np.linalg.eigh(c1)
    order = np.argsort(w1)[::-1]
    w1, v1 = w1[order], v1[:, order]
    # keep min(n, n_terms) 1-D pairs per axis: any product using a 1-D index
    # >= n_terms is outranked by >= n_terms larger products, so the true
    # top-n_terms selection never needs more.  (A sqrt(n_terms) grid is NOT
    # enough: anisotropic pairs like (0, j>sqrt) outrank deep-interior ones —
    # at kle512/n=64 that dropped 166 of the true top-512 modes, ~2.3% of
    # the retained energy.)
    m = min(n, n_terms)
    w1, v1 = w1[:m], v1[:, :m]
    # discrete eigenvectors are orthonormal wrt counting measure; rescale so
    # that sum_i lambda_i phi_i(s)^2 -> pointwise variance ~= 1
    v1 = v1 * np.sqrt(n)
    w2 = np.outer(w1, w1).ravel()
    # a coarse grid caps the available modes at m^2 (<= n^2)
    n_terms = min(n_terms, len(w2))
    top = np.argsort(w2)[::-1][:n_terms]
    eigvals = w2[top]
    ii, jj = np.unravel_index(top, (m, m))
    # mode_(i,j)(y, x) = v_i(y) v_j(x)
    modes = np.einsum("yk,xk->kyx", v1[:, ii], v1[:, jj])
    return KLEBasis(eigvals.astype(np.float64), modes.astype(np.float64),
                    length_scale)


def norm_ppf(p: np.ndarray) -> np.ndarray:
    """Standard-normal quantile function."""
    return np.sqrt(2.0) * _special.erfinv(2.0 * p - 1.0)


def sample_kle_logk(basis: KLEBasis, xi: np.ndarray) -> np.ndarray:
    """log-permeability fields from KLE coefficients xi (B, k) -> (B, n, n)."""
    amp = np.sqrt(np.maximum(basis.eigvals, 0.0))
    k = basis.modes.shape[0]
    n = basis.modes.shape[1]
    flat = basis.modes.reshape(k, n * n)
    g = (xi * amp[None, :]) @ flat
    return g.reshape(xi.shape[0], n, n)


def sample_kle(n_samples: int, n: int, n_terms: int,
               length_scale: float = 0.25,
               rng: np.random.Generator | int | None = None,
               use_lhs: bool = True) -> np.ndarray:
    """Sample permeability K = exp(GRF_KLE) fields, (B, n, n) float32.

    ``use_lhs``: draw the KLE coefficients from a Latin-hypercube design
    mapped through the normal quantile (dataset convention 'kle*_lhs*').
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    basis = kle_basis(n, n_terms, length_scale)
    k = len(basis.eigvals)  # may be capped by the grid size
    if use_lhs:
        u = lhs(k, n_samples, rng=rng)
        u = np.clip(u, 1e-12, 1 - 1e-12)
        xi = norm_ppf(u)
    else:
        xi = rng.standard_normal((n_samples, k))
    return np.exp(sample_kle_logk(basis, xi)).astype(np.float32)


def _bilinear_sample_np(field: np.ndarray, ys: np.ndarray,
                        xs: np.ndarray) -> np.ndarray:
    """Bilinear interpolation of (n, n) field at pixel coords (clamped)."""
    n = field.shape[0]
    y0 = np.clip(np.floor(ys).astype(int), 0, n - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, n - 2)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    f00 = field[y0, x0]
    f01 = field[y0, x0 + 1]
    f10 = field[y0 + 1, x0]
    f11 = field[y0 + 1, x0 + 1]
    return ((1 - wy) * (1 - wx) * f00 + (1 - wy) * wx * f01
            + wy * (1 - wx) * f10 + wy * wx * f11)


def sample_warped_grf(n_samples: int, n: int, n_terms: int = 128,
                      length_scale: float = 0.25,
                      warp_scale: float = 0.08,
                      warp_length_scale: float = 0.5,
                      rng: np.random.Generator | int | None = None
                      ) -> np.ndarray:
    """Warped-GP permeability family ('warped_gp_ng64_n1000' analog).

    A base GRF evaluated at smoothly warped coordinates: the warp is a random
    displacement field built from two long-correlation GRFs, producing the
    non-stationary, locally stretched structures of a warped GP.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    # sample the log-fields directly (same draws as sample_kle(use_lhs=False)
    # without its exp -> log float32 roundtrip)
    basis = kle_basis(n, n_terms, length_scale)
    base = sample_kle_logk(
        basis, rng.standard_normal((n_samples, len(basis.eigvals))))
    wbasis = kle_basis(n, 32, warp_length_scale)
    disp = sample_kle_logk(
        wbasis, rng.standard_normal((2 * n_samples, len(wbasis.eigvals))))
    dy = disp[:n_samples] * warp_scale * (n - 1)
    dx = disp[n_samples:] * warp_scale * (n - 1)
    yy, xx = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float),
                         indexing="ij")
    out = np.empty_like(base)
    for b in range(n_samples):
        ys = np.clip(yy + dy[b], 0, n - 1)
        xs = np.clip(xx + dx[b], 0, n - 1)
        out[b] = _bilinear_sample_np(base[b], ys, xs)
    return np.exp(out).astype(np.float32)


def sample_channelized(n_samples: int, n: int,
                       k_low: float = 0.01, k_high: float = 1.0,
                       length_scale_x: float = 0.5,
                       length_scale_y: float = 0.08,
                       rng: np.random.Generator | int | None = None
                       ) -> np.ndarray:
    """Binary channelized permeability ('channel_ng64' analog).

    Thresholded anisotropic GRF (long correlation along x, short along y)
    yields high-contrast channel structures with ~50% facies fraction.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    cy = _exp_cov_1d(n, length_scale_y) / n
    cx = _exp_cov_1d(n, length_scale_x) / n
    wy, vy = np.linalg.eigh(cy)
    wx, vx = np.linalg.eigh(cx)
    wy, wx = np.maximum(wy, 0), np.maximum(wx, 0)
    ay = vy * np.sqrt(wy)[None, :] * np.sqrt(n)
    ax = vx * np.sqrt(wx)[None, :] * np.sqrt(n)
    xi = rng.standard_normal((n_samples, n, n))
    # optimize=True factors into two O(B n^3) GEMMs; the default single
    # C loop is O(B n^4) — minutes vs seconds at 10k samples on one core
    g = np.einsum("yi,bij,xj->byx", ay, xi, ax, optimize=True)
    return np.where(g > np.median(g, axis=(1, 2), keepdims=True),
                    k_high, k_low).astype(np.float32)

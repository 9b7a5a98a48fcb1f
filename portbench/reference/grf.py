"""The cells' input fields: permeability K = exp(GRF) from a truncated
Karhunen-Loeve expansion (KLE) of a separable exponential covariance, its
coefficients drawn by a classic Latin-hypercube design mapped through the
normal quantile.

A frozen numpy copy of the program's KLE sampler and classic LHS design
(``data/grf.py`` ``kle_basis`` / ``sample_kle``, ``ops/lhs.py``
``_classic``): the same seed gives the same fields as the program's
dataset generator, without importing it.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import special


@functools.lru_cache(maxsize=4)
def kle_basis(n: int, n_terms: int, length_scale: float = 0.25):
    """(eigvals (k,), modes (k, n, n)) of the top ``n_terms`` 2-D KLE
    eigenpairs, products of the 1-D ones."""
    x = np.linspace(0.0, 1.0, n)
    c1 = np.exp(-np.abs(x[:, None] - x[None, :]) / length_scale) / n
    w1, v1 = np.linalg.eigh(c1)
    order = np.argsort(w1)[::-1]
    w1, v1 = w1[order], v1[:, order]
    m = min(n, n_terms)
    w1, v1 = w1[:m], v1[:, :m] * np.sqrt(n)
    w2 = np.outer(w1, w1).ravel()
    n_terms = min(n_terms, len(w2))
    top = np.argsort(w2)[::-1][:n_terms]
    ii, jj = np.unravel_index(top, (m, m))
    modes = np.einsum("yk,xk->kyx", v1[:, ii], v1[:, jj])
    return w2[top].astype(np.float64), modes.astype(np.float64)


def lhs_classic(n: int, samples: int, rng: np.random.Generator) -> np.ndarray:
    """(samples, n) classic Latin-hypercube design in [0, 1)."""
    cut = np.linspace(0, 1, samples + 1)
    u = rng.random((samples, n))
    points = cut[:samples, None] + u * (1.0 / samples)
    h = np.empty_like(points)
    for j in range(n):
        h[:, j] = points[rng.permutation(samples), j]
    return h


def sample_kle(n_samples: int, n: int, n_terms: int, seed) -> np.ndarray:
    """(n_samples, n, n) float32 fields K = exp(sum_k sqrt(lambda_k) xi_k
    phi_k), xi from an LHS design drawn from ``seed`` (an int or a
    ``np.random.SeedSequence``)."""
    rng = np.random.default_rng(seed)
    eigvals, modes = kle_basis(n, n_terms)
    k = len(eigvals)
    u = np.clip(lhs_classic(k, n_samples, rng), 1e-12, 1 - 1e-12)
    xi = np.sqrt(2.0) * special.erfinv(2.0 * u - 1.0)
    amp = np.sqrt(np.maximum(eigvals, 0.0))
    g = (xi * amp[None, :]) @ modes.reshape(k, n * n)
    return np.exp(g.reshape(n_samples, n, n)).astype(np.float32)

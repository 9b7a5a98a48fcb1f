"""Latin hypercube sampling designs.

Capability parity with the reference's scilab-derived ``utils/lhs.py``
(classic / centered / maximin / centermaximin / correlation criteria), built
on explicit numpy Generators instead of global RNG state so designs are
reproducible from a seed.  numpy copy of pde_surrogate_tpu/ops/lhs.py: the
same seed gives a byte-identical design (designs are not prefix-stable, so
the two packages must agree bit for bit to name the same dataset).

The maximin criterion's pairwise-distance search (reference
``_pdist``, utils/lhs.py:208-251, a Python double loop) is vectorized.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lhs"]


def lhs(n: int, samples: int | None = None, criterion: str | None = None,
        iterations: int | None = None,
        rng: np.random.Generator | int | None = None) -> np.ndarray:
    """Generate a Latin-hypercube design (reference: utils/lhs.py:21-120).

    Args:
      n: number of factors (dimensions).
      samples: number of samples (default ``n``).
      criterion: None (randomized), 'center'/'c', 'maximin'/'m',
        'centermaximin'/'cm', or 'correlation'/'corr'.
      iterations: search iterations for maximin/correlation (default 5).
      rng: numpy Generator or seed.

    Returns:
      (samples, n) design in [0, 1).
    """
    if samples is None:
        samples = n
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)

    if criterion is None:
        return _classic(n, samples, rng)

    crit = criterion.lower()
    if iterations is None:
        iterations = 5
    if crit in ("center", "c"):
        return _centered(n, samples, rng)
    if crit in ("maximin", "m"):
        return _maximin(n, samples, iterations, rng, centered=False)
    if crit in ("centermaximin", "cm"):
        return _maximin(n, samples, iterations, rng, centered=True)
    if crit in ("correlate", "correlation", "corr"):
        return _correlate(n, samples, iterations, rng)
    raise ValueError(f'Invalid value for "criterion": {criterion}')


def _classic(n: int, samples: int, rng: np.random.Generator) -> np.ndarray:
    cut = np.linspace(0, 1, samples + 1)
    u = rng.random((samples, n))
    points = cut[:samples, None] + u * (1.0 / samples)
    h = np.empty_like(points)
    for j in range(n):
        h[:, j] = points[rng.permutation(samples), j]
    return h


def _centered(n: int, samples: int, rng: np.random.Generator) -> np.ndarray:
    cut = np.linspace(0, 1, samples + 1)
    centers = (cut[:samples] + cut[1:]) / 2
    h = np.empty((samples, n))
    for j in range(n):
        h[:, j] = rng.permutation(centers)
    return h


def _min_pdist(x: np.ndarray) -> float:
    """Minimum pairwise Euclidean distance, vectorized (vs utils/lhs.py:208-251)."""
    d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.sqrt(d2.min()))


def _maximin(n: int, samples: int, iterations: int, rng: np.random.Generator,
             centered: bool) -> np.ndarray:
    best, maxdist = None, 0.0
    for _ in range(iterations):
        cand = _centered(n, samples, rng) if centered else _classic(n, samples, rng)
        d = _min_pdist(cand)
        if d > maxdist:
            maxdist, best = d, cand
    return best


def _correlate(n: int, samples: int, iterations: int,
               rng: np.random.Generator) -> np.ndarray:
    best, mincorr = None, np.inf
    for _ in range(iterations):
        cand = _classic(n, samples, rng)
        r = np.corrcoef(cand.T)
        offdiag = np.max(np.abs(r - np.eye(n)))
        if offdiag < mincorr:
            mincorr, best = offdiag, cand
    return best

"""Spatial collocation and boundary points on the unit square.

numpy copy of pde_surrogate_tpu/ops/sampling.py (the reference's
``SampleSpatial2d``, utils/sampling.py:16-99): points are (y, x) ordered,
scaled to [0, 1] by (ngrid - 1), and drawn from an explicit numpy Generator,
so the same seed gives bit-identical points in both packages.
"""

from __future__ import annotations

import numpy as np

from .lhs import lhs

__all__ = ["SampleSpatial2d"]


class SampleSpatial2d:
    """Uniform-grid and LHS samplers for collocation and boundary points.

    h is the vertical (y) axis, w the horizontal (x) axis; outputs are
    float32 (N, 2) arrays in (y, x) order scaled to [0, 1].
    """

    def __init__(self, ngrid_h: int, ngrid_w: int,
                 rng: np.random.Generator | int | None = None):
        self.ngrid_h = int(ngrid_h)
        self.ngrid_w = int(ngrid_w)
        self.n_grids = self.ngrid_h * self.ngrid_w
        self.refactor = np.array([[self.ngrid_h - 1, self.ngrid_w - 1]],
                                 dtype=np.float32)
        self._rng = (rng if isinstance(rng, np.random.Generator)
                     else np.random.default_rng(rng))
        self.coordinates = self._coordinates(no_boundary=False)
        self.coordinates_no_boundary = self._coordinates(no_boundary=True)

    def _coordinates(self, no_boundary: bool) -> np.ndarray:
        grid_x, grid_y = np.meshgrid(np.arange(self.ngrid_w),
                                     np.arange(self.ngrid_h))
        if no_boundary:
            grid_x, grid_y = grid_x[1:-1, 1:-1], grid_y[1:-1, 1:-1]
        return np.stack((grid_y.ravel(), grid_x.ravel()), 1).astype(np.float32)

    def _sample2d(self, on_grid: bool, n_samples: int | None,
                  no_boundary: bool) -> np.ndarray:
        if n_samples is None:
            n_samples = self.n_grids
        if on_grid:
            pts = (self.coordinates_no_boundary if no_boundary
                   else self.coordinates) / self.refactor
            if n_samples < len(pts):
                pts = pts[self._rng.permutation(len(pts))[:n_samples]]
            elif n_samples > len(pts):
                # the reference caps on-grid sampling at the grid size
                print(f"n_samples {n_samples} > grid size {len(pts)}; "
                      "returning the full grid")
            return pts.astype(np.float32)
        return lhs(2, n_samples, rng=self._rng).astype(np.float32)

    def _sample1d(self, horizontal: bool, on_grid: bool,
                  n_samples: int | None) -> np.ndarray:
        # horizontal=True samples along the y axis (the left/right edges),
        # the reference's naming (utils/sampling.py:64-80)
        ngrid = self.ngrid_h if horizontal else self.ngrid_w
        if n_samples is None:
            n_samples = ngrid
        if on_grid:
            pts = np.arange(ngrid, dtype=np.float32) / (ngrid - 1)
            if n_samples <= len(pts):
                pts = pts[self._rng.permutation(ngrid)[:n_samples]]
            else:
                print(f"n_samples {n_samples} > grid size {ngrid}; "
                      "returning the full grid edge")
            return pts
        return self._rng.random(n_samples).astype(np.float32)

    def left(self, on_grid: bool = True, n_samples: int | None = None):
        p = self._sample1d(True, on_grid, n_samples)
        return np.stack((p, np.zeros_like(p)), 1)

    def right(self, on_grid: bool = True, n_samples: int | None = None):
        p = self._sample1d(True, on_grid, n_samples)
        return np.stack((p, np.ones_like(p)), 1)

    def top(self, on_grid: bool = True, n_samples: int | None = None):
        p = self._sample1d(False, on_grid, n_samples)
        return np.stack((np.zeros_like(p), p), 1)

    def bottom(self, on_grid: bool = True, n_samples: int | None = None):
        p = self._sample1d(False, on_grid, n_samples)
        return np.stack((np.ones_like(p), p), 1)

    def colloc(self, on_grid: bool = True, n_samples: int | None = None,
               no_boundary: bool = False):
        return self._sample2d(on_grid, n_samples, no_boundary)

"""Image-gradient stencils as matrix products (Sobel with boundary fix).

Counterpart of pde_surrogate_tpu/ops/filters.py (SobelFilter and its
builders).  The reference estimates derivatives of field images with Sobel
correlations (replicate padding), scaled by the image size, and corrects the
domain boundary with a one-sided 3-point modifier (reference
utils/image_gradient.py:24-92).  A correlation with a separable (or rank-2)
kernel is a pair of dense matrix products,

    grad_h(u) = sum_r Lh[r] @ u @ Rh[r],    grad_v(u) = sum_r Lv[r] @ u @ Rv[r],

with replicate padding and the modifier folded into the operator matrices.
Here they run as two ``torch.matmul`` calls in f32 (the second contracts the
rank axis with the columns, as the JAX einsum does).  Images are NCHW, or
any (..., H, W).

On a row block (``SobelFilter.on_rows``) the left operators, the only ones
that act on H, are cut to the block's rows and to the columns of the block
and its halo, with the replicate padding and the boundary modifier already
in them; the halo is derived from where the operators are nonzero
(``parallel.halo.block_operator``).

The Gaussian smoother and the Farid-Simoncelli ("Fourier") derivative
filters (reference utils/image_gradient.py:95-293) are exploratory in the
reference (no driver uses them); they are ported for parity and run the
same way, with reflect-padded and replicate-padded operator matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel.halo import RowShard, block_operator

__all__ = ["SobelFilter", "FourierFilter", "GaussianFilter",
           "gaussian_filter1d_weights", "stencil_matrix"]


def stencil_matrix(n: int, stencil, offset: int | None = None) -> np.ndarray:
    """(n, n) float64 operator of a 1-D correlation with replicate padding.

    Row i computes ``sum_k stencil[k] * x[clip(i + k - c, 0, n-1)]`` with
    ``c`` the stencil centre (default ``len(stencil)//2``).
    """
    stencil = np.asarray(stencil, dtype=np.float64)
    c = len(stencil) // 2 if offset is None else offset
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k, w in enumerate(stencil):
            j = min(max(i + k - c, 0), n - 1)
            m[i, j] += w
    return m


def _boundary_modifier(n: int) -> np.ndarray:
    """Identity with corners [4, -1] / [-1, 4] (utils/image_gradient.py:43-46):
    with the replicate-padded Sobel value at the edge this realizes a
    3-point one-sided difference on the domain boundary."""
    m = np.eye(n, dtype=np.float64)
    m[0:2, 0] = np.array([4.0, -1.0])
    m[-2:, -1] = np.array([-1.0, 4.0])
    return m


# Separable decompositions of the reference Sobel kernels: rank-1
# (smooth, diff) components and the normalizer (utils/image_gradient.py:28-41)
_SOBEL_COMPONENTS = {
    3: ([([1.0, 2.0, 1.0], [-1.0, 0.0, 1.0])], 8.0),
    5: (
        [
            ([5.0, 8.0, 10.0, 8.0, 5.0], [-1.0, 0.0, 0.0, 0.0, 1.0]),
            ([4.0, 10.0, 20.0, 10.0, 4.0], [0.0, -1.0, 0.0, 1.0, 0.0]),
        ],
        240.0,
    ),
}


@functools.lru_cache(maxsize=32)
def _sobel_operators(imsize: int, filter_size: int, correct: bool):
    """(Lh, Rh, Lv, Rv) float32 numpy stacks, rank r on the leading axis.

    grad_h(u) = sum_r Lh[r] @ u @ Rh[r] == imsize * corrected d/dx, and
    likewise grad_v for d/dy.
    """
    comps, norm = _SOBEL_COMPONENTS[filter_size]
    mod = _boundary_modifier(imsize) if correct else np.eye(imsize)
    lh, rh, lv, rv = [], [], [], []
    for smooth, diff in comps:
        s = stencil_matrix(imsize, smooth)
        d = stencil_matrix(imsize, diff)
        lh.append(s / norm)
        rh.append(imsize * d.T @ mod)
        lv.append(imsize * mod.T @ d / norm)
        rv.append(s.T)
    return tuple(np.stack(x).astype(np.float32) for x in (lh, rh, lv, rv))


@functools.lru_cache(maxsize=32)
def _sobel_row_blocks(imsize: int, filter_size: int, correct: bool,
                      index: int, size: int):
    """(Lh, Lv, a, b): the left operators' block ``index`` of ``size``
    over one halo window, ``a`` rows above and ``b`` below, the largest
    that either operator needs on any block."""
    lh, _, lv, _ = _sobel_operators(imsize, filter_size, correct)
    block, a, b = block_operator(np.concatenate([lh, lv]), index, size)
    block = block.astype(np.float32)
    return block[:len(lh)], block[len(lh):], a, b


def _apply_lr(image: torch.Tensor, left: torch.Tensor,
              right_cat: torch.Tensor) -> torch.Tensor:
    """sum_r L[r] @ image @ R[r] for image (..., H, W).

    ``right_cat`` is the rank stack concatenated along rows, (r*W, W), so
    the second product contracts (rank, column) together.
    """
    y = torch.matmul(left, image.unsqueeze(-3))          # (..., r, H, W)
    y = y.transpose(-3, -2).flatten(-2)                  # (..., H, r*W)
    return torch.matmul(y, right_cat)


class SobelFilter:
    """Sobel image-gradient estimator with FD boundary correction.

    ``grad_h`` is d/dx (along W), ``grad_v`` is d/dy (along H), both scaled
    by the image size, i.e. derivatives on the unit square.  Operators are
    built once per (filter size, device, dtype) and kept on that device;
    a float64 image gets the float32 coefficients in float64.

    With ``rows`` (``on_rows``) the images are this rank's row block of
    ``imsize / rows.size`` rows, padded with ``halo()`` rows above and
    below (``parallel.halo.with_halo``), and the results are the block's
    own rows.
    """

    def __init__(self, imsize: int, correct: bool = True,
                 filter_size: int = 3):
        self.imsize = int(imsize)
        self.correct = bool(correct)
        self.filter_size = int(filter_size)
        self.rows: RowShard | None = None
        self._cache: dict = {}

    def on_rows(self, rows: RowShard) -> "SobelFilter":
        """This filter on the row blocks of ``rows``."""
        f = SobelFilter(self.imsize, self.correct, self.filter_size)
        f.rows = rows
        return f

    def halo(self) -> tuple[int, int]:
        """The rows above and below a block that the row-block operators
        read."""
        return _sobel_row_blocks(self.imsize, self.filter_size, self.correct,
                                 self.rows.index, self.rows.size)[2:]

    def _ops(self, filter_size: int, image: torch.Tensor):
        if filter_size not in _SOBEL_COMPONENTS:
            raise ValueError(f"filter_size must be 3 or 5, got {filter_size}")
        key = (filter_size, image.device, image.dtype)
        ops = self._cache.get(key)
        if ops is None:
            lh, rh, lv, rv = _sobel_operators(self.imsize, filter_size,
                                              self.correct)
            if self.rows is not None:
                lh, lv, _, _ = _sobel_row_blocks(
                    self.imsize, filter_size, self.correct, self.rows.index,
                    self.rows.size)
            t = lambda a: torch.from_numpy(a).to(image.device,  # noqa: E731
                                                 image.dtype)
            ops = (t(lh), t(rh.reshape(-1, rh.shape[-1])),
                   t(lv), t(rv.reshape(-1, rv.shape[-1])))
            self._cache[key] = ops
        return ops

    def grad_h(self, image: torch.Tensor, filter_size: int | None = None
               ) -> torch.Tensor:
        """d/dx of (..., H, W) images (unit square, corrected boundary)."""
        lh, rh, _, _ = self._ops(filter_size or self.filter_size, image)
        return _apply_lr(image, lh, rh)

    def grad_v(self, image: torch.Tensor, filter_size: int | None = None
               ) -> torch.Tensor:
        """d/dy of (..., H, W) images (unit square, corrected boundary)."""
        _, _, lv, rv = self._ops(filter_size or self.filter_size, image)
        return _apply_lr(image, lv, rv)


def _to_tensors(left: np.ndarray, right: np.ndarray, image: torch.Tensor):
    """numpy operator stacks (r, H, H) and (r, W, W) as tensors on the
    image's device and dtype, the right one concatenated along rows for
    ``_apply_lr``."""
    return (torch.from_numpy(left).to(image.device, image.dtype),
            torch.from_numpy(right.reshape(-1, right.shape[-1])).to(
                image.device, image.dtype))


def gaussian_filter1d_weights(sigma: float, order: int = 0,
                              truncate: float = 4.0) -> np.ndarray:
    """1-D Gaussian (derivative) filter weights, orders 0..3 (the
    scipy-derived table of the reference, utils/image_gradient.py:95-161).
    """
    if order not in range(4):
        raise ValueError("Order outside 0..3 not implemented")
    sd = float(sigma)
    var = sd * sd
    lw = int(truncate * sd + 0.5)
    x = np.arange(-lw, lw + 1, dtype=np.float64)
    w = np.exp(-0.5 * x * x / var)
    w /= w.sum()
    if order == 1:
        w = (x / var) * w
    elif order == 2:
        w = (x * x / var - 1.0) * w / var
    elif order == 3:
        w = -(3.0 - x * x / var) * x * w / (var * var)
    return w


@functools.lru_cache(maxsize=32)
def _reflect_stencil_matrix(weights: tuple, n: int) -> np.ndarray:
    """(n, n) float32 operator of a 1-D correlation with reflect padding
    (the edge is not repeated: index -1 mirrors to 1, as torch's 'reflect'
    pad)."""
    c = len(weights) // 2
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k, wk in enumerate(weights):
            j = i + k - c
            while j < 0 or j >= n:
                j = -j if j < 0 else 2 * (n - 1) - j
            m[i, j] += wk
    return m.astype(np.float32)


class GaussianFilter:
    """Separable Gaussian smoother with reflect padding
    (utils/image_gradient.py:164-184) on (..., H, W) images, as two matrix
    products."""

    def __init__(self, sigma: float = 1.0, truncate: float = 4.0,
                 order: int = 0):
        self.weights1d = gaussian_filter1d_weights(sigma, order, truncate)
        self._cache: dict = {}

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        h, w = image.shape[-2], image.shape[-1]
        key = (h, w, image.device, image.dtype)
        ops = self._cache.get(key)
        if ops is None:
            weights = tuple(self.weights1d)
            ops = _to_tensors(
                _reflect_stencil_matrix(weights, h)[None],
                np.ascontiguousarray(
                    _reflect_stencil_matrix(weights, w).T)[None],
                image)
            self._cache[key] = ops
        return _apply_lr(image, *ops)


class FourierFilter:
    """Farid-Simoncelli matched derivative filters
    (utils/image_gradient.py:241-293): 3/5/7-tap interpolator and
    differentiator pairs, replicate padding, no boundary modifier, scaled
    by the image size."""

    _TAPS = {
        3: (np.array([0.229879, 0.540242, 0.229879]),
            np.array([-0.425287, 0.0, 0.425287])),
        5: (np.array([0.037659, 0.249153, 0.426375, 0.249153, 0.037659]),
            np.array([-0.109604, -0.276691, 0.0, 0.276691, 0.109604])),
        7: (np.array([0.005412, 0.069591, 0.244560, 0.360875, 0.244560,
                      0.069591, 0.005412]),
            np.array([-0.019479, -0.123915, -0.193555, 0.0, 0.193555,
                      0.123915, 0.019479])),
    }

    def __init__(self, imsize: int):
        self.imsize = int(imsize)
        self._cache: dict = {}

    def _ops(self, filter_size: int, horizontal: bool, image: torch.Tensor):
        key = (filter_size, horizontal, image.device, image.dtype)
        ops = self._cache.get(key)
        if ops is None:
            lh, rh, lv, rv = _fourier_operators(self.imsize, filter_size)
            ops = _to_tensors(*((lh, rh) if horizontal else (lv, rv)), image)
            self._cache[key] = ops
        return ops

    def grad_h(self, image: torch.Tensor, filter_size: int = 5
               ) -> torch.Tensor:
        """d/dx of (..., H, W) images."""
        return _apply_lr(image, *self._ops(filter_size, True, image))

    def grad_v(self, image: torch.Tensor, filter_size: int = 5
               ) -> torch.Tensor:
        """d/dy of (..., H, W) images."""
        return _apply_lr(image, *self._ops(filter_size, False, image))


@functools.lru_cache(maxsize=8)
def _fourier_operators(imsize: int, filter_size: int):
    p, d = FourierFilter._TAPS[filter_size]
    s = stencil_matrix(imsize, p)
    df = stencil_matrix(imsize, d)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return (f32(s[None]), f32((imsize * df.T)[None]), f32((imsize * df)[None]),
            f32(s.T[None]))

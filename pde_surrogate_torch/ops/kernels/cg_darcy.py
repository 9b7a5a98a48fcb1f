"""Batched fixed-iteration PCG Darcy solve: CUDA kernel and its plain twin.

Counterpart of pde_surrogate_tpu/ops/kernels/cg_darcy.py::solve_darcy_pallas.
``solve_darcy_cg`` takes K (B, n, n) float32 and returns the pressure u
(B, n, n) after ``n_iter`` Jacobi-preconditioned CG iterations on the
node-centred 5-point finite-volume grid (harmonic-mean faces, zero-flux top
and bottom, Dirichlet u = 1 / u = 0 columns eliminated).

* On a CUDA tensor it launches ``csrc/cg_darcy.cu`` (one CTA per field; the
  design note is in that file) or raises.  It never falls back.
* On a CPU tensor it runs ``solve_darcy_cg_plain``, the same algorithm in
  torch ops (batched, per-field sums, the same +1e-30 guards and masks).
  On the GPU the twin is only the kernel's oracle: the main path does not
  call it.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["solve_darcy_cg", "solve_darcy_cg_plain", "MAX_N"]

# 3 n^2 f32 of dynamic shared memory (227 KB per block) and 16 cells per
# thread of a 1024-thread block both cap the kernel at n = 128
MAX_N = 128

_lib = None


def _harm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Harmonic mean: the face-conductivity convention of every solve and
    label (``solvers/fd_darcy`` uses it too)."""
    return 2.0 * a * b / (a + b)


def solve_darcy_cg_plain(K: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The kernel's algorithm in torch ops; any float dtype and device."""
    _, n, _ = K.shape
    dt = K.dtype
    col = torch.arange(n, device=K.device).view(1, 1, n)
    row = torch.arange(n, device=K.device).view(1, n, 1)
    zero = K.new_zeros(())
    kE = torch.where(col == n - 1, zero, _harm(K, torch.roll(K, -1, 2)))
    kW = torch.where(col == 0, zero, _harm(K, torch.roll(K, 1, 2)))
    kS = torch.where(row == n - 1, zero, _harm(K, torch.roll(K, -1, 1)))
    kN = torch.where(row == 0, zero, _harm(K, torch.roll(K, 1, 1)))
    mask = ((col > 0) & (col < n - 1)).to(dt)
    inv_diag = mask / torch.clamp(kE + kW + kN + kS, min=1e-30)

    def matvec(v):
        lap = (kE * (torch.roll(v, -1, 2) - v) + kW * (torch.roll(v, 1, 2) - v)
               + kN * (torch.roll(v, 1, 1) - v)
               + kS * (torch.roll(v, -1, 1) - v))
        return -lap * mask

    def field_sum(a):
        return a.sum(dim=(1, 2), keepdim=True)

    r = torch.where(col == 1, kW, zero)
    v = torch.zeros_like(K)
    p = r * inv_diag
    rz = field_sum(r * p)
    for _ in range(n_iter):
        ap = matvec(p)
        alpha = rz / (field_sum(p * ap) + 1e-30)
        v = v + alpha * p
        r = r - alpha * ap
        z = r * inv_diag
        rz_new = field_sum(r * z)
        p = z + rz_new / (rz + 1e-30) * p
        rz = rz_new
    return (col == 0).to(dt) + v * mask


def _library():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("cg_darcy")
        lib.cg_darcy_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.cg_darcy_launch.restype = ctypes.c_int
        lib.cg_darcy_error_string.argtypes = [ctypes.c_int]
        lib.cg_darcy_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def solve_darcy_cg(K: torch.Tensor, n_iter: int) -> torch.Tensor:
    """(B, n, n) permeabilities -> (B, n, n) pressures, fixed-iteration PCG.

    CUDA tensors go to the kernel (float32, contiguous, square, 3 <= n <=
    MAX_N; anything else raises); CPU tensors to the plain twin.
    """
    if K.device.type == "cpu":
        return solve_darcy_cg_plain(K, n_iter)
    if K.device.type != "cuda":
        raise ValueError(f"solve_darcy_cg: unsupported device {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"solve_darcy_cg kernel takes float32, got {K.dtype}")
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"solve_darcy_cg expects (B, n, n), got "
                         f"{tuple(K.shape)}")
    bsz, n, _ = K.shape
    if not 3 <= n <= MAX_N:
        raise ValueError(f"solve_darcy_cg kernel supports 3 <= n <= {MAX_N}, "
                         f"got n={n}")
    if not K.is_contiguous():
        raise ValueError("solve_darcy_cg expects a contiguous tensor")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    lib = _library()
    u = torch.empty_like(K)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = lib.cg_darcy_launch(K.data_ptr(), u.data_ptr(), bsz, n,
                                  int(n_iter), stream)
    if err != 0:
        raise RuntimeError("cg_darcy kernel launch failed: "
                           + lib.cg_darcy_error_string(err).decode())
    solve_darcy_cg.launches += 1
    return u


solve_darcy_cg.launches = 0

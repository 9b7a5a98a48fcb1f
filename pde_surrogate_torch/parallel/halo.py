"""Row halos: fields split along H over the ranks of a space group.

Rank ``index`` of the ``size`` ranks of a space group holds rows
``[index h, (index + 1) h)`` of every field of ``size h`` rows, at every
resolution of the DenseED (``RowShard``).  An operator that reads rows
beyond the block (a 3x3 conv, the Sobel stencils, an upsampling) needs
``a`` rows of the rank above and ``b`` rows of the rank below.  Two parts
are kept apart:

* the transport, ``exchange_rows``: those rows from the neighbours, point
  to point under autograd.  Its backward sends the halo's gradient back
  to its owner, who adds it into the gradient of its edge rows.  The
  exchange is not circular: a rank at a wall gets zeros there;
* the block arithmetic, pure functions of ``(block, above, below)``
  (``conv_rows``, ``upsample_conv_rows``, the block operators of
  ``block_operator``), so that one process can cut one tensor into blocks,
  hand each the rows of its neighbours, and compare with the whole field.

The JAX package leaves all of this to XLA's SPMD partitioner
(pde_surrogate_tpu/parallel/mesh.py ``dp_sp_mesh``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["RowShard", "exchange_rows", "with_halo", "conv_halo",
           "conv_rows", "block_operator", "upsample_matrix",
           "upsample_dtype", "upsample_operator", "upsample_conv_rows"]


@dataclass(frozen=True)
class RowShard:
    """This rank's place on the space axis: block ``index`` of ``size``,
    exchanged over ``group`` (None: no transport, the arithmetic alone)."""

    group: object
    index: int
    size: int


def _swap(rows: RowShard, send_up, recv_up, send_down, recv_down) -> None:
    """One ``batch_isend_irecv`` with both neighbours: ``send_up`` to the
    rank above and ``recv_up`` from it, likewise below; a rank at a wall
    posts one side only, and empty tensors are not posted."""
    ops = []
    for peer, send, recv in ((rows.index - 1, send_up, recv_up),
                             (rows.index + 1, send_down, recv_down)):
        if not 0 <= peer < rows.size:
            continue
        g = dist.get_global_rank(rows.group, peer)
        if send.shape[-2]:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), g,
                                  rows.group))
        if recv.shape[-2]:
            ops.append(dist.P2POp(dist.irecv, recv, g, rows.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _rows_like(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros(*x.shape[:-2], n, x.shape[-1])


class _HaloRows(torch.autograd.Function):
    """``(above, below)``: the last ``a`` rows of the rank above and the
    first ``b`` rows of the rank below (zeros at a wall).  Backward: the
    gradients of ``above`` and ``below`` go back to their owners, and the
    ones that come back are added into this block's edge rows."""

    @staticmethod
    def forward(ctx, x, a: int, b: int, rows: RowShard):
        ctx.a, ctx.b, ctx.rows, ctx.shape = a, b, rows, x.shape
        h = x.shape[-2]
        above, below = _rows_like(x, a), _rows_like(x, b)
        _swap(rows, x[..., :b, :], above, x[..., h - a:, :], below)
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        a, b, h = ctx.a, ctx.b, ctx.shape[-2]
        from_up = _rows_like(g_below, b)      # the rank above's g_below
        from_down = _rows_like(g_above, a)    # the rank below's g_above
        _swap(ctx.rows, g_above, from_up, g_below, from_down)
        grad = g_above.new_zeros(ctx.shape)
        grad[..., :b, :] += from_up
        grad[..., h - a:, :] += from_down
        return grad, None, None, None


def exchange_rows(x: torch.Tensor, a: int, b: int, rows: RowShard
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``a`` rows above and ``b`` rows below the block ``x``
    (..., h, W) on its neighbours of ``rows.group``: every rank of the
    group must call this with the same ``a`` and ``b``, in the same
    order."""
    h = x.shape[-2]
    if a > h or b > h:
        raise ValueError(f"a halo of {a} rows above and {b} below needs "
                         f"blocks of at least that many rows, not {h}")
    return _HaloRows.apply(x, a, b, rows)


def with_halo(x: torch.Tensor, above: torch.Tensor, below: torch.Tensor
              ) -> torch.Tensor:
    return torch.cat([above, x, below], dim=-2)


def conv_halo(kernel: int, stride: int, padding: int) -> tuple[int, int]:
    """``(a, b)``, the rows above and below a block of a conv's input that
    its output rows read: output row j reads input rows
    ``stride j - padding .. stride j - padding + kernel - 1``."""
    a, b = padding, kernel - stride - padding
    if b < 0:
        raise ValueError(f"a {kernel}x{kernel} conv of stride {stride} and "
                         f"padding {padding} has no row-block form")
    return a, b


def _wgrad_in_float64(weight: torch.Tensor, stride: int) -> bool:
    """Whether a row-block conv reduces its weight gradient in float64:
    the stride-1 convs wider than 1x1 (the DenseED's 3x3 and 5x5), the
    only kinds that cuDNN's Winograd algorithms take (they need stride 1).

    cuDNN chooses its weight-gradient algorithm by shape.  On an H100, for
    some block shapes of the DenseED at 64^2 (the 3x3 after an upsampling
    in 2 and 4 blocks, the dense 3x3 in 4) it runs its non-fused 4x4
    Winograd kernels, whose float32 result lies 0.8-1.8e-5 of its largest
    value from float64, where the whole field's FFT or direct kernels lie
    2-7e-7; every other kind, the strided and 1x1 convs among them, stays
    within 9e-7 (``tools/row_block_wgrad_probe.py``)."""
    return stride == 1 and weight.shape[-1] > 1


class _RowConv(torch.autograd.Function):
    """``F.conv2d(with_halo(x, above, below), weight, None, stride,
    (0, padding))``, whose weight gradient is reduced in float64 where
    ``_wgrad_in_float64`` says so: in float64 no algorithm loses that
    much, and the one rounding to the weight's dtype keeps the block path
    as close to the exact gradient as the whole field's.  The forward and
    the input gradient stay cuDNN's, in the input's dtype.  The float64
    copies hold twice the float32 they copy while the reduction runs, but
    they replace the Winograd algorithms' workspace: on an H100 a 1x1
    data x space step of DenseED [6,8,6]/16/48 at 64^2, batch 32, peaks
    at 1286 MiB this way and at 1620 MiB with cuDNN's float32 weight
    gradient (``tools/row_block_memory_probe.py``).

    It saves the block and its halo rows apart and joins them again in
    backward: the block is the tensor that the layer before keeps anyway
    (a plain conv saves it too), where a saved halo-padded copy holds one
    more activation per conv until the backward: on the same card the
    1x1 mesh step of the cGlow (enc [3,4,4], flow [6,6,6], 64^2, batch
    32) saved 1932 MiB more that way and peaked at 8372 MiB, against
    6509 MiB now and 6260 MiB on the data mesh alone."""

    @staticmethod
    def forward(ctx, x, above, below, weight, stride: int, padding: int):
        ctx.save_for_backward(x, above, below, weight)
        ctx.conv = (stride, (0, padding))
        return F.conv2d(with_halo(x, above, below), weight, None, stride,
                        (0, padding))

    @staticmethod
    def backward(ctx, g):
        x, above, below, weight = ctx.saved_tensors
        heights = [above.shape[-2], x.shape[-2], below.shape[-2]]
        gx = ga = gb = gw = None
        if any(ctx.needs_input_grad[:3]):
            gxp = torch.nn.grad.conv2d_input(
                x.shape[:-2] + (sum(heights), x.shape[-1]), weight, g,
                *ctx.conv)
            ga, gx, gb = torch.split(gxp, heights, -2)
        if ctx.needs_input_grad[3]:
            xp = with_halo(x, above, below)
            if _wgrad_in_float64(weight, ctx.conv[0]):
                gw = torch.nn.grad.conv2d_weight(
                    xp.double(), weight.shape, g.double(), *ctx.conv
                ).to(weight.dtype)
            else:
                gw = torch.nn.grad.conv2d_weight(xp, weight.shape, g,
                                                 *ctx.conv)
        return gx, ga, gb, gw, None, None


def conv_rows(x, above, below, weight, stride: int, padding: int,
              bias=None) -> torch.Tensor:
    """This block's rows of ``F.conv2d(field, weight, bias, stride,
    padding)``: the block with its halo (zeros at a wall, the conv's zero
    padding) convolved without padding along H, the bias added after.
    The block's rows must be a multiple of the stride."""
    if x.shape[-2] % stride:
        raise ValueError(f"a block of {x.shape[-2]} rows under a conv of "
                         f"stride {stride}")
    y = _RowConv.apply(x, above, below, weight, stride, padding)
    return y if bias is None else y + bias[:, None, None]


def block_operator(op: np.ndarray, index: int, size: int, extra: int = 0):
    """Block ``index`` of ``size`` of a linear map over H.

    ``op`` (..., n_out, n_in) maps a field's rows to rows; padded with
    ``extra`` zero rows above and below, its rows
    ``[index h_out, (index + 1) h_out + 2 extra)`` are the ones this block
    computes (``h_out = n_out / size``).  Returns ``(block, a, b)``:
    those rows restricted to the columns ``[index h_in - a,
    (index + 1) h_in + b)``, zero outside the field, where ``a`` and ``b``
    are the largest halo any block needs, derived from where ``op`` is
    nonzero.  Raises when a block holds fewer rows than the halo."""
    n_out, n_in = op.shape[-2:]
    if n_out % size or n_in % size:
        raise ValueError(f"an operator of {n_out}x{n_in} rows over {size} "
                         f"blocks")
    h_out, h_in = n_out // size, n_in // size
    padded = np.zeros(op.shape[:-2] + (n_out + 2 * extra, n_in))
    padded[..., extra:extra + n_out, :] = op
    support = (padded != 0).reshape(-1, n_out + 2 * extra, n_in).any(0)
    a = b = 0
    for j in range(size):
        cols = np.flatnonzero(
            support[j * h_out:(j + 1) * h_out + 2 * extra].any(0))
        if cols.size:
            a = max(a, j * h_in - int(cols[0]))
            b = max(b, int(cols[-1]) + 1 - (j + 1) * h_in)
    if a > h_in or b > h_in:
        raise ValueError(f"blocks of {h_in} rows are narrower than the "
                         f"operator's halo ({a} above, {b} below)")
    rows = padded[..., index * h_out:(index + 1) * h_out + 2 * extra, :]
    lo, hi = index * h_in - a, (index + 1) * h_in + b
    c0, c1 = max(lo, 0), min(hi, n_in)
    block = np.zeros(rows.shape[:-1] + (hi - lo,))
    block[..., c0 - lo:c1 - lo] = rows[..., c0:c1]
    outside = rows.copy()
    outside[..., c0:c1] = 0.0
    if np.any(outside != 0):
        raise AssertionError("the operator reads rows outside its block's "
                             "halo")
    return block, a, b


def upsample_matrix(n_in: int, mode: str, scale: int = 2) -> np.ndarray:
    """(scale n_in, n_in) float64 operator of x``scale`` upsampling along
    one axis: ``nearest`` (torch's UpsamplingNearest2d) or ``bilinear``
    with align_corners=True (the DenseED's bilinear mode)."""
    n_out = n_in * scale
    m = np.zeros((n_out, n_in))
    if mode == "nearest":
        m[np.arange(n_out), np.arange(n_out) // scale] = 1.0
        return m
    if mode != "bilinear":
        raise ValueError(f"unknown upsample mode: {mode}")
    if n_in == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        src = i * (n_in - 1) / (n_out - 1)
        lo = min(int(np.floor(src)), n_in - 2)
        m[i, lo] += 1.0 - (src - lo)
        m[i, lo + 1] += src - lo
    return m


def upsample_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype upsampling's products run in: f32 for an f32 or narrower
    input (the JAX package's f32 matrices promote a bf16 input), f64 for
    f64."""
    return torch.promote_types(dtype, torch.float32)


@functools.lru_cache(maxsize=32)
def upsample_operator(n_in: int, mode: str, device: torch.device,
                      dtype: torch.dtype, scale: int = 2) -> torch.Tensor:
    """``upsample_matrix`` on ``device`` in ``upsample_dtype(dtype)``, made
    once per shape (read only).  Upsampling runs as products with it: the
    backward of torch's bilinear ``F.interpolate`` on CUDA sums by atomics
    and has no deterministic implementation."""
    return torch.from_numpy(upsample_matrix(n_in, mode, scale)).to(
        device, upsample_dtype(dtype))


def upsample_conv_rows(x, above, below, op: torch.Tensor, weight,
                       mode: str) -> torch.Tensor:
    """This block's rows of ``F.conv2d(upsample(field), weight,
    padding=p)``, a stride-1 (2p+1)x(2p+1) conv: ``op`` is the block
    operator of the upsampling over H with ``extra = p``
    (``block_operator(upsample_matrix(...), ..., p)``), so the low-resolution
    halo becomes the p upsampled rows the conv reads on each side, zero at
    a wall (the conv's zero padding, not the upsampling's clamp); W is
    upsampled as in the whole field.  Both products run in
    ``upsample_dtype(x.dtype)``, the conv in ``x``'s dtype."""
    p = weight.shape[-2] // 2
    ct = upsample_dtype(x.dtype)
    y = op.to(ct) @ with_halo(x, above, below).to(ct)
    y = (y @ upsample_operator(y.shape[-1], mode, y.device, ct).T).to(x.dtype)
    none = y[..., :0, :]
    return _RowConv.apply(y, none, none, weight, 1, p)

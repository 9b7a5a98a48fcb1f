"""The conv solver with its Decoder's convs at a TPU's DEFAULT f32 precision,
emulated on any device.

ROADMAP F1's hypothesis: the JAX Decoder's flax convs set no precision,
and an f32 conv at DEFAULT precision on a TPU multiplies bf16-rounded
operands and accumulates in f32; the port runs true f32 (TF32 off).  Under
``tpu_default_convs()`` every codec ``Conv2d`` (the Decoder's every conv)
rounds its input and weight to bf16 (round to nearest even), multiplies
and accumulates in f32, and its backward rounds the incoming gradient
likewise before the two transposed convs, as a DEFAULT-precision backward
would.  The Sobel products and BatchNorm stay f32.  This is a diagnostic,
not an option of the solver or the model.

Run:  python3 -m pde_surrogate_torch.tools.f1_tpu_precision <solver flags>
      (the flags of ``cli.solve_conv_mixed_residual``; ``tools/f1_seeds.py
      --conv-operands f32 bf16`` runs both side by side)
"""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.nn.functional as F


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Bf16OperandConv(torch.autograd.Function):
    """``F.conv2d`` of bf16-rounded operands in f32, both ways."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        xr, wr = _bf16(x), _bf16(weight)
        ctx.save_for_backward(xr, wr)
        ctx.conv = (stride, padding)
        ctx.has_bias = bias is not None
        return F.conv2d(xr, wr, bias, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _bf16(g)
        gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, *ctx.conv)
        gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, *ctx.conv)
        gb = g.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return gx, gw, gb, None, None


@contextlib.contextmanager
def tpu_default_convs():
    """Every codec ``Conv2d`` on whole fields at emulated DEFAULT
    precision while the block runs."""
    from ..models import codec
    plain = codec.Conv2d.forward

    def forward(self, x):
        if self.rows is not None:
            raise ValueError("the emulation covers whole fields only")
        return _Bf16OperandConv.apply(x, self.weight.to(x.dtype), self.bias,
                                      self.stride, self.padding)

    codec.Conv2d.forward = forward
    try:
        yield
    finally:
        codec.Conv2d.forward = plain


def main(argv=None):
    from ..cli.solve_conv_mixed_residual import main as solve
    print("Decoder convs: bf16-rounded operands, f32 accumulation "
          "(emulated TPU DEFAULT precision)")
    with tpu_default_convs():
        return solve(argv)


if __name__ == "__main__":
    main(sys.argv[1:])

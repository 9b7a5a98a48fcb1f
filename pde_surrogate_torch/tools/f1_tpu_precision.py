"""The conv solver or the codec CLI with every codec conv at a TPU's DEFAULT
f32 precision, emulated on any device.

The JAX package's flax convs (the solver's Decoder, the DenseED) set no
precision, and an f32 conv at DEFAULT precision on a TPU multiplies
bf16-rounded operands and accumulates in f32; the port runs true f32
(TF32 off).  Under ``tpu_default_convs()`` every codec ``Conv2d`` (the
Decoder's and the DenseED's every conv, the ones after an upsampling and
the strided in-conv too) rounds its input and weight to bf16 (round to
nearest even), multiplies and accumulates in f32, and its backward rounds
the incoming gradient likewise before the two transposed convs, as a
DEFAULT-precision backward would.  The Sobel products, the upsampling and
BatchNorm stay f32.  Row blocks (a data x space mesh) are refused.  This
is a diagnostic, not an option of the CLIs or the model.

Run:  python3 -m pde_surrogate_torch.tools.f1_tpu_precision [--cli solver] \
          <flags of cli.solve_conv_mixed_residual>
      python3 -m pde_surrogate_torch.tools.f1_tpu_precision --cli codec \
          <flags of cli.train_codec_mixed_residual>
      (``tools/f1_seeds.py --conv-operands f32 bf16`` runs the solver both
      ways side by side)
"""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.nn.functional as F

CLIS = ("solver", "codec")


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
        need_x, need_w = ctx.needs_input_grad[:2]
        gx = (torch.nn.grad.conv2d_input(xr.shape, wr, gr, *ctx.conv)
              if need_x else None)
        gw = (torch.nn.grad.conv2d_weight(xr, wr.shape, gr, *ctx.conv)
              if need_w else None)
        gb = g.sum(dim=(0, 2, 3)) if ctx.has_bias else None
        return gx, gw, gb, None, None


@contextlib.contextmanager
def tpu_default_convs():
    """Every codec ``Conv2d`` on whole fields at emulated DEFAULT
    precision while the block runs; the plain ``forward`` is back on exit,
    also when the block raises."""
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
    argv = list(sys.argv[1:] if argv is None else argv)
    cli = "solver"
    if argv[:1] == ["--cli"]:
        cli, argv = argv[1], argv[2:]
    if cli not in CLIS:
        raise SystemExit(f"--cli takes one of {CLIS}, not {cli!r}")
    if cli == "codec":
        from ..cli.train_codec_mixed_residual import main as run
        what = "DenseED"
    else:
        from ..cli.solve_conv_mixed_residual import main as run
        what = "Decoder"
    print(f"{what} convs: bf16-rounded operands, f32 accumulation "
          f"(emulated TPU DEFAULT precision)", flush=True)
    with tpu_default_convs():
        return run(argv)


if __name__ == "__main__":
    main()

"""Physics-constrained codec surrogate, label-free mixed-residual training.

Counterpart of pde_surrogate_tpu/cli/train_codec_mixed_residual.py: the same
flags, defaults and run-dir naming, plus ``--device`` (default ``cuda``).
``--find-lr`` runs the LR-range test instead of training; ``--init-from``
warm-starts the weights; ``--dtype bf16`` runs the convolutions in bf16
with f32 parameters; ``--concat-free`` drops the dense blocks' per-layer
concats; ``--profile-epoch N`` writes a profiler trace of epoch N to
``<run dir>/training/profile/trace.json``.  ``--n-devices > 1`` is not
ported yet and raises ``NotImplementedError`` (ROADMAP E3).

Run:  python -m pde_surrogate_torch.cli.train_codec_mixed_residual \
          --data grf_kle512 --ntrain 4096 --batch-size 32
"""

from __future__ import annotations

import argparse

from ..utils.config import BaseParser, int_list
from ._codec_common import reject_unported, run_codec_training, run_find_lr


class Parser(BaseParser):
    def __init__(self):
        super().__init__(
            description="Learning surrogate with mixed residual norm loss")
        self.add_argument("--exp-name", type=str,
                          default="codec/mixed_residual")
        self.add_argument("--exp-dir", type=str, default="./experiments")
        # codec
        self.add_argument("--blocks", type=int_list, default=[6, 8, 6])
        self.add_argument("--growth-rate", type=int, default=16)
        self.add_argument("--init-features", type=int, default=48)
        self.add_argument("--drop-rate", type=float, default=0.0)
        self.add_argument("--upsample", type=str, default="nearest",
                          choices=["nearest", "bilinear"])
        # data
        self.add_argument("--data-dir", type=str, default="./datasets")
        self.add_argument("--data", type=str, default="grf_kle512",
                          choices=["grf_kle512", "channelized", "warped_grf"])
        self.add_argument("--kle", type=int, default=512,
                          help="KLE truncation for the grf family")
        self.add_argument("--ntrain", type=int, default=4096)
        self.add_argument("--ntest", type=int, default=512)
        self.add_argument("--imsize", type=int, default=64)
        # training
        self.add_argument("--run", type=int, default=1)
        self.add_argument("--epochs", type=int, default=300)
        self.add_argument("--lr", type=float, default=1e-3)
        self.add_argument("--lr-div", type=float, default=2.0)
        self.add_argument("--lr-pct", type=float, default=0.3)
        self.add_argument("--weight-decay", type=float, default=0.0)
        self.add_argument("--weight-bound", type=float, default=10.0)
        self.add_argument("--sobel-size", type=int, default=3, choices=[3, 5],
                          help="derivative stencil for the physics loss")
        self.add_argument("--physics", type=str, default="sobel",
                          choices=["sobel", "fv", "fvcg", "sobel_fvcg"],
                          help="label-free objective: 'sobel' = the "
                               "reference's mixed residual (models/darcy.py"
                               ":162-233); 'fv' = the exactly-identifiable "
                               "finite-volume residual "
                               "(ops/darcy.fv_mixed_residual_loss, "
                               "ill-conditioned); 'fvcg' = the "
                               "CG-preconditioned error objective "
                               "(ops/darcy.fv_cg_error_loss); 'sobel_fvcg' "
                               "= sobel + the CG-recovered pressure-error "
                               "anchor (hybrid)")
        self.add_argument("--fvcg-weight", type=float, default=100.0,
                          help="weight of the CG pressure-error term in "
                               "the sobel_fvcg hybrid objective")
        self.add_argument("--fvcg-flux-weight", type=float, default=0.0,
                          help="weight of the flux anchor against the "
                               "CG-corrected pressure's conservative face "
                               "fluxes (ops/darcy.fv_cg_anchors) in the "
                               "sobel_fvcg hybrid")
        self.add_argument("--fvcg-iters", type=int, default=None,
                          help="CG depth of the fvcg objectives (default: "
                               "the grid size; kappa(A) ~ n^2 needs Krylov "
                               "depth ~ n)")
        self.add_argument("--dtype", type=str, default="f32",
                          choices=["f32", "bf16"],
                          help="conv compute dtype (parameters and BN "
                               "statistics stay f32)")
        self.add_argument("--shared-stats", action=argparse.BooleanOptionalAction,
                          default=True,
                          help="accepted for run-dir compatibility: shared "
                               "and per-layer BN statistics are the same "
                               "math, which the port computes per layer "
                               "(and per group with --concat-free)")
        self.add_argument("--concat-free", action="store_true", default=False,
                          help="dense blocks without the per-layer prefix "
                               "concats: per-group batch moments and "
                               "sum-of-sliced-kernel convs (same math and "
                               "checkpoint names; models/codec.DenseBlock)")
        self.add_argument("--batch-size", type=int, default=32)
        self.add_argument("--test-batch-size", type=int, default=64)
        self.add_argument("--seed", type=int, default=1)
        self.add_argument("--n-devices", type=int, default=None,
                          help="data-parallel devices; only one is ported")
        self.add_argument("--find-lr", action="store_true", default=False,
                          help="run the LR-range test instead of training "
                               "(utils/practices.py:45-83)")
        self.add_argument("--no-scan-epochs", dest="scan_epochs",
                          action="store_false", default=True,
                          help="accepted for compatibility: the port always "
                               "runs the per-step loop (the same semantics)")
        self.add_argument("--init-from", type=str, default=None,
                          help="run dir (or 'dir:epoch') to warm-start "
                               "weights from, with a fresh optimizer and lr "
                               "schedule; the source may be trained at "
                               "another imsize (the codec is fully "
                               "convolutional). A --ckpt-epoch resume wins "
                               "over it. Use a distinct --run to keep the "
                               "run dir separate")
        self.add_device_arg()
        self.add_logging_args(ckpt_freq=100, log_freq=1, plot_freq=50)

    def parse(self, argv=None):
        args = self.parse_args(argv)
        reject_unported(args)
        hparams = (f"{args.data}_ntrain{args.ntrain}_run{args.run}_"
                   f"bs{args.batch_size}_lr{args.lr}_epochs{args.epochs}")
        if args.kle != 512:
            hparams += f"_kle{args.kle}"
        if args.imsize != 64:
            hparams += f"_im{args.imsize}"
        if args.weight_bound != 10.0:
            hparams += f"_wb{args.weight_bound:g}"
        if args.sobel_size != 3:
            hparams += f"_sobel{args.sobel_size}"
        if args.physics != "sobel":
            hparams += f"_{args.physics}"
            if args.physics == "sobel_fvcg" and args.fvcg_weight != 100.0:
                hparams += f"_w{args.fvcg_weight:g}"
            if args.physics == "sobel_fvcg" and args.fvcg_flux_weight != 0.0:
                hparams += f"_fw{args.fvcg_flux_weight:g}"
            if args.fvcg_iters is not None:
                hparams += f"_cg{args.fvcg_iters}"
        if args.upsample != "nearest":
            hparams += f"_{args.upsample}"
        if args.dtype != "f32":
            hparams += f"_{args.dtype}"
        if args.concat_free:
            args.shared_stats = True
            hparams += "_cf"
        elif not args.shared_stats:
            hparams += "_nss"
        if args.ntrain % args.batch_size or args.ntest % args.test_batch_size:
            self.error("--ntrain and --ntest must be multiples of "
                       "--batch-size and --test-batch-size")
        return self.finalize(args, hparams)


def main(argv=None):
    args = Parser().parse(argv)
    if args.find_lr:
        return run_find_lr(args, loss_kind="mixed_residual")
    return run_codec_training(args, loss_kind="mixed_residual")


if __name__ == "__main__":
    main()

"""Data-driven codec baseline: maximum-likelihood (MSE) training.

Counterpart of pde_surrogate_tpu/cli/train_codec_max_likelihood.py (the
reference's train_codec_max_likelihood.py: the mixed-residual driver's
skeleton with the MSE against solver labels, default 200 epochs): the same
flags, defaults and run-dir naming, plus ``--device`` (default ``cuda``).
The training split's labels come from the PCG solver, attached in place to
an inputs-only file.  ``--dtype bf16``, ``--profile-epoch`` and, beyond the
JAX driver's flags, ``--concat-free`` (run dir suffix ``_cf``) work as in
the mixed-residual driver, and so does ``--n-devices N`` (data-parallel
on N ranks).

Run:  python -m pde_surrogate_torch.cli.train_codec_max_likelihood \
          --data grf_kle512 --ntrain 4096 --batch-size 32
"""

from __future__ import annotations

import argparse

from ..parallel.launch import check_devices
from ..utils.config import BaseParser, int_list
from ._codec_common import run_codec


class Parser(BaseParser):
    def __init__(self):
        super().__init__(description="Learning surrogate with MSE loss")
        self.add_argument("--exp-name", type=str,
                          default="codec/max_likelihood")
        self.add_argument("--exp-dir", type=str, default="./experiments")
        self.add_argument("--blocks", type=int_list, default=[6, 8, 6])
        self.add_argument("--growth-rate", type=int, default=16)
        self.add_argument("--init-features", type=int, default=48)
        self.add_argument("--drop-rate", type=float, default=0.0)
        self.add_argument("--upsample", type=str, default="nearest",
                          choices=["nearest", "bilinear"])
        self.add_argument("--data-dir", type=str, default="./datasets")
        self.add_argument("--data", type=str, default="grf_kle512",
                          choices=["grf_kle512", "channelized", "warped_grf"])
        self.add_argument("--kle", type=int, default=512,
                          help="KLE truncation for the grf family")
        self.add_argument("--ntrain", type=int, default=4096)
        self.add_argument("--ntest", type=int, default=512)
        self.add_argument("--imsize", type=int, default=64)
        self.add_argument("--run", type=int, default=1)
        self.add_argument("--epochs", type=int, default=200)
        self.add_argument("--lr", type=float, default=1e-3)
        self.add_argument("--lr-div", type=float, default=2.0)
        self.add_argument("--lr-pct", type=float, default=0.3)
        self.add_argument("--weight-decay", type=float, default=0.0)
        self.add_argument("--weight-bound", type=float, default=10.0,
                          help="used only in the physics test loss")
        self.add_argument("--dtype", type=str, default="f32",
                          choices=["f32", "bf16"],
                          help="conv compute dtype (parameters and BN "
                               "statistics stay f32)")
        self.add_argument("--shared-stats", action=argparse.BooleanOptionalAction,
                          default=True,
                          help="accepted for run-dir compatibility: shared "
                               "and per-layer BN statistics are the same "
                               "math, which the port computes per layer")
        self.add_argument("--concat-free", action="store_true", default=False,
                          help="dense blocks without the per-layer prefix "
                               "concats (models/codec.DenseBlock)")
        self.add_argument("--batch-size", type=int, default=32)
        self.add_argument("--test-batch-size", type=int, default=64)
        self.add_argument("--seed", type=int, default=1)
        self.add_argument("--n-devices", type=int, default=None,
                          help="train data-parallel on this many devices "
                               "(one rank each; parallel/launch.py)")
        self.add_argument("--find-lr", action="store_true", default=False,
                          help="run the LR-range test instead of training")
        self.add_argument("--no-scan-epochs", dest="scan_epochs",
                          action="store_false", default=True,
                          help="accepted for compatibility: the port always "
                               "runs the per-step loop (the same semantics)")
        self.add_device_arg()
        self.add_logging_args(ckpt_freq=100, log_freq=1, plot_freq=50)

    def parse(self, argv=None):
        args = self.parse_args(argv)
        check_devices(args.n_devices, args.device)
        hparams = (f"{args.data}_ntrain{args.ntrain}_run{args.run}_"
                   f"bs{args.batch_size}_lr{args.lr}_epochs{args.epochs}")
        if args.kle != 512:
            hparams += f"_kle{args.kle}"
        if args.imsize != 64:
            hparams += f"_im{args.imsize}"
        if args.upsample != "nearest":
            hparams += f"_{args.upsample}"
        if args.dtype != "f32":
            hparams += f"_{args.dtype}"
        if args.concat_free:
            args.shared_stats = True
            hparams += "_cf"
        if args.ntrain % args.batch_size or args.ntest % args.test_batch_size:
            self.error("--ntrain and --ntest must be multiples of "
                       "--batch-size and --test-batch-size")
        return self.finalize(args, hparams)


def main(argv=None):
    return run_codec(Parser().parse(argv), loss_kind="mle")


if __name__ == "__main__":
    main()

"""Post-processing of a trained cGlow run: the UQ suite.

Counterpart of pde_surrogate_tpu/cli/post_cglow.py: rebuild the model from
the run dir's args.txt, restore a checkpoint, then run prediction at x,
distribution estimates, the test metric, the reliability diagram and the
uncertainty propagation against a Monte-Carlo dataset (generated on demand,
labels by the PCG kernel).  Writes the figures, the numbers they show and
the prediction-at-x gif (``cglow_pred_at_x.gif``) under
``<run dir>/post_proc_epoch{E}`` and prints each task's wall time.

Run:  python -m pde_surrogate_torch.cli.post_cglow --run-dir <dir> \
          --ckpt-epoch 400
"""

from __future__ import annotations

import argparse
import os
import time

from ..data.hdf5 import load_args, load_data
from ..train.checkpoint import latest_epoch, restore_weights
from ..uq.uq import GlowSurrogate, UQCondGlow
from ..utils.config import select_device
from ..viz.plot import assemble_gif
from ._codec_common import uq_dataset_files
from .train_cglow_reverse_kl import build_model

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Post-process trained cGlow")
    parser.add_argument("--run-dir", type=str, required=True)
    parser.add_argument("--ckpt-epoch", type=int, default=None)
    parser.add_argument("--n-samples", type=int, default=20)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--n-monte-carlo", type=int, default=10000)
    parser.add_argument("--ntest", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--var-samples", type=int, default=10)
    parser.add_argument("--n-pred", type=int, default=6)
    parser.add_argument("--num-loc", type=int, default=6)
    parser.add_argument("--plot-samples", action="store_true",
                        help="keep 15 predictive samples per input of "
                             "prediction at x")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    device = select_device(args.device)

    run_args = load_args(args.run_dir)
    ckpt_dir = os.path.join(args.run_dir, "checkpoints")
    epoch = args.ckpt_epoch or latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    post_dir = os.path.join(args.run_dir, f"post_proc_epoch{epoch}")
    os.makedirs(post_dir, exist_ok=True)

    model = build_model(run_args, device)
    mc_file, test_file = uq_dataset_files(run_args, args.n_monte_carlo,
                                          args.ntest, device=device)
    mc_x, mc_y, _ = load_data(mc_file, args.n_monte_carlo, only_input=False)
    test_x, test_y, stats = load_data(test_file, args.ntest, only_input=False,
                                      return_stats=True)

    restore_weights(ckpt_dir, epoch, model)
    print(f"Loaded checkpoint at epoch {epoch}")

    surrogate = GlowSurrogate(model, n_samples=args.n_samples,
                              temperature=args.temperature)
    uq = UQCondGlow(surrogate, (mc_x, mc_y), (test_x, test_y),
                    stats["y_variation"], post_dir, run_args.imsize,
                    batch_size=args.batch_size,
                    ntrain=getattr(run_args, "ntrain", 0),
                    epochs=run_args.epochs)

    def predict_at_x():
        uq.plot_prediction_at_x(args.n_pred, plot_samples=args.plot_samples)
        gif = assemble_gif(os.path.join(post_dir, "predict_at_x"),
                           os.path.join(post_dir, "cglow_pred_at_x.gif"),
                           duration_ms=800)
        if gif:
            print(f"animation: {gif}")

    tasks = {
        "predict_at_x": predict_at_x,
        "dist": lambda: uq.plot_dist(args.num_loc),
        "test_metric": lambda: uq.test_metric(handle_nan=True),
        "reliability": uq.plot_reliability_diagram,
        "propagate": lambda: uq.propagate_uncertainty(
            var_samples=args.var_samples)}
    uq.seconds = {}
    for name, task in tasks.items():
        # every task ends by copying its numbers to the host
        tic = time.perf_counter()
        task()
        uq.seconds[name] = time.perf_counter() - tic
        print(f"[post] {name}: {uq.seconds[name]:.2f} s")
    return uq


if __name__ == "__main__":
    main()

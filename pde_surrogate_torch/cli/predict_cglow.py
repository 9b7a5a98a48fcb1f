"""Batch inference (serving) for a trained conditional-Glow run.

Counterpart of pde_surrogate_tpu/cli/predict_cglow.py: rebuild the model
from the run dir's args.txt, restore a checkpoint, and write the predictive
mean (``output``) and standard deviation (``output_std``) of p(y|x) over
``--n-samples`` draws per input, with the inputs, to HDF5 in the NCHW
layout of the datasets (numpy writer; h5py reads the file).  When the
input file carries labels it prints rel-L2 and R^2 of the mean, leaving
non-finite predictions out.

Run:  python -m pde_surrogate_torch.cli.predict_cglow \
          --run-dir <dir> [--ckpt-epoch N] --input K.hdf5 --output pred.hdf5
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.hdf5 import Writer, dataset_shapes, load_args, load_data
from ..train.checkpoint import latest_epoch, restore_weights
from ..uq.uq import GlowSurrogate
from ..utils.config import make_generator, select_device
from .train_cglow_reverse_kl import build_model

__all__ = ["main"]


def main(argv=None):
    parser = argparse.ArgumentParser(description="cGlow batch inference")
    parser.add_argument("--run-dir", type=str, required=True,
                        help="training run dir (args.txt and checkpoints/)")
    parser.add_argument("--ckpt-epoch", type=int, default=None,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--input", type=str, required=True,
                        help="HDF5 with 'input' (N,1,H,W); 'output' labels "
                             "optional (metrics printed when present)")
    parser.add_argument("--output", type=str, default=None,
                        help="HDF5 for the predictive mean/std (default: "
                             "<run-dir>/predictions_epoch<E>.hdf5)")
    parser.add_argument("--ndata", type=int, default=None,
                        help="predict only the first N samples")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--n-samples", type=int, default=20,
                        help="draws per input for the predictive moments")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    device = select_device(args.device)

    run_args = load_args(args.run_dir)
    ckpt_dir = os.path.join(args.run_dir, "checkpoints")
    epoch = args.ckpt_epoch or latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")

    shapes = dataset_shapes(args.input)
    n_total, has_labels = shapes["input"][0], "output" in shapes
    n = min(args.ndata or n_total, n_total)
    x, y, _ = load_data(args.input, n, only_input=not has_labels)

    model = build_model(run_args, device)
    restore_weights(ckpt_dir, epoch, model)
    print(f"[predict] restored {ckpt_dir} epoch {epoch}")

    surrogate = GlowSurrogate(model, n_samples=args.n_samples,
                              temperature=args.temperature)
    mean = np.empty((n, run_args.y_channels) + x.shape[2:], np.float32)
    std = np.empty_like(mean)
    for i in range(0, n, args.batch_size):
        m, v = surrogate.predict(x[i:i + args.batch_size],
                                 make_generator(device, args.seed, i))
        mean[i:i + len(m)] = m.cpu().numpy()
        std[i:i + len(m)] = v.sqrt().cpu().numpy()

    out_path = args.output or os.path.join(
        args.run_dir, f"predictions_epoch{epoch}.hdf5")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    arrays = {"input": x, "output": mean, "output_std": std}
    with Writer(out_path, {k: a.shape for k, a in arrays.items()}) as w:
        for k, a in arrays.items():
            w.write(k, 0, a)
    print(f"[predict] wrote {n} predictive mean/std fields "
          f"({args.n_samples} draws, T={args.temperature}) to {out_path}")

    if has_labels:
        finite = np.isfinite(mean).all(axis=(1, 2, 3))
        n_bad = int((~finite).sum())
        if n_bad:
            print(f"[predict] {n_bad}/{len(mean)} predictions non-finite — "
                  f"excluded from metrics")
        m, yy = mean[finite], y[finite]
        err2 = ((m - yy) ** 2).sum(axis=(2, 3))
        rel_l2 = np.sqrt(err2 / (yy ** 2).sum(axis=(2, 3))).mean(0)
        variation = ((yy - yy.mean(0, keepdims=True)) ** 2).sum(
            axis=(0, 2, 3))
        r2 = 1.0 - err2.sum(0) / variation
        print(f"[predict] rel-L2 per channel (predictive mean): {rel_l2}")
        print(f"[predict] R^2 per channel: {r2}")
        return mean, std, rel_l2, r2
    return mean, std, None, None


if __name__ == "__main__":
    main()

"""Dataset factory: generate the reference's dataset families locally.

Counterpart of pde_surrogate_tpu/cli/make_dataset.py: the same flags,
split names and seeds, so both factories write byte-identical inputs under
the same names.  Inputs are sampled on the host (GRF-KLE via LHS designs,
warped GRF, channelized); labels are solved on the device slice by slice
with ``solve_darcy_batch_fast`` (the CUDA PCG kernel on a GPU).

Run:  python -m pde_surrogate_torch.cli.make_dataset --imsize 64 --kle 512
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.grf import sample_channelized, sample_kle, sample_warped_grf
from ..data.hdf5 import dataset_path, save_dataset
from ..solvers.fd_darcy import solve_darcy_batch_fast
from ..utils.config import select_device

__all__ = ["main", "solve_labels"]


def solve_labels(read, n: int, solve_batch: int, device, write) -> None:
    """Solve the labels of ``n`` fields ``solve_batch`` at a time.

    ``read(i, j)`` returns the K fields i..j-1 as (j-i, H, W);
    ``write(i, j, y)`` takes their (j-i, 3, H, W) float32 labels.
    """
    tic = time.perf_counter()
    for i in range(0, n, solve_batch):
        j = min(i + solve_batch, n)
        k = torch.from_numpy(np.ascontiguousarray(read(i, j),
                                                  dtype=np.float32))
        y = solve_darcy_batch_fast(k.to(device))
        write(i, j, y.cpu().numpy())
        rate = j / max(time.perf_counter() - tic, 1e-9)
        print(f"  solved {j}/{n} ({rate:.1f} fields/sec)")


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate Darcy datasets")
    p.add_argument("--data-dir", type=str, default="./datasets")
    p.add_argument("--imsize", type=int, default=64)
    p.add_argument("--family", type=str, default="grf",
                   choices=["grf", "warped_grf", "channelized"])
    p.add_argument("--kle", type=int, default=512)
    p.add_argument("--length-scale", type=float, default=0.25)
    p.add_argument("--ntrain", type=int, default=10000)
    p.add_argument("--nval", type=int, default=1000)
    p.add_argument("--ntest", type=int, default=1000)
    p.add_argument("--n-monte-carlo", type=int, default=10000)
    p.add_argument("--solve-batch", type=int, default=64)
    p.add_argument("--train-labels", action="store_true", default=False,
                   help="also solve labels for the training split (needed "
                        "for MLE training / data-init)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for the label solves")
    args = p.parse_args(argv)
    device = select_device(args.device)

    n = args.imsize
    if args.family == "grf":
        k = args.kle
        splits = [
            (f"kle{k}_lhs{args.ntrain}_train", args.ntrain,
             10_000 + k, args.train_labels),
            (f"kle{k}_lhs{args.nval}_val", args.nval, 20_000 + k, True),
            (f"kle{k}_lhs{args.ntest}_test", args.ntest, 32_000 + k, True),
            (f"kle{k}_lhs{args.n_monte_carlo}_monte_carlo",
             args.n_monte_carlo, 40_000 + k, True),
        ]
        gen = lambda m, seed: sample_kle(m, n, k, args.length_scale,  # noqa: E731
                                         rng=seed)
    elif args.family == "channelized":
        # same seeds as the lazy paths (_codec_common.resolve_dataset_files:
        # 10_000/20_000 + kle with kle=0), so both write identical bytes
        splits = [(f"channel_ng{n}_n{args.ntrain}_train", args.ntrain,
                   10_000, args.train_labels),
                  (f"channel_ng{n}_n{args.ntest}_test", args.ntest,
                   20_000, True)]
        gen = lambda m, seed: sample_channelized(m, n, rng=seed)  # noqa: E731
    else:
        splits = [(f"warped_gp_ng{n}_n{args.ntest}", args.ntest, 30_000, True)]
        gen = lambda m, seed: sample_warped_grf(m, n, rng=seed)  # noqa: E731

    for name, count, seed, with_labels in splits:
        path = dataset_path(args.data_dir, n, name)
        if os.path.isfile(path):
            print(f"[skip] {path} exists")
            continue
        print(f"[gen] {path}: {count} samples...")
        k_fields = gen(count, seed + args.seed)
        y = None
        if with_labels:
            y = np.empty((count, 3, n, n), np.float32)
            solve_labels(lambda i, j: k_fields[i:j], count, args.solve_batch,
                         device, lambda i, j, out: y.__setitem__(slice(i, j),
                                                                 out))
        save_dataset(path, k_fields[:, None], y)
        print(f"[gen] wrote {path}")


if __name__ == "__main__":
    main()

"""Where a codec run's val R^2 goes: the val SSE split by sample.

R^2 = 1 - SSE / y_variation pools the squared error over the whole val
split, while the rel-L2 the CLI prints beside it is a mean of per-sample
ratios; a few samples, or an offset of each sample's mean, can carry the
SSE while the rel-L2 stays put.  This restores a checkpoint of a run made
by ``cli.train_codec_mixed_residual`` (or the MLE CLI), runs the CLI's
eval step over the run's val split in the CLI's batches and prints, per
channel (u, σ₁, σ₂):

* the SSE and the R^2 (as the CLI computes them: per-sample float32 sums,
  summed over the split on the device);
* the SSE carried by each sample's mean offset, H·W·(mean pred - mean
  y)^2, summed over the split, beside the rest, sum (e - mean e)^2 with
  e = pred - y, each computed on its own;
* how many samples carry half the SSE, and the 10 samples with the
  largest SSE: their index in the val file, their share of the total,
  their rel-L2, the share of their own SSE that is offset, and their
  field's mean log K with its rank in the split (0 the lowest);

then the CLI's R^2 for that epoch from the checkpoint's meta and the
relative difference, and one JSON line with the same numbers.
``--tpu-precision`` evaluates with the convs at the emulated TPU DEFAULT
precision the run was trained under (``tools/f1_tpu_precision.py --cli
codec``), as its CLI evaluated it.

``--val-ranks I [I ...]`` needs no run: it prints the mean log K of
those fields of the canonical val split (kle512 at 64², the inputs the
CLI generates) and their rank among its 512 fields.

Run:  python3 -m pde_surrogate_torch.tools.r2_breakdown --run-dir <run dir> \
          [--epoch N] [--tpu-precision] [--device cuda]
      python3 -m pde_surrogate_torch.tools.r2_breakdown --val-ranks 138 38 28
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from ..cli._codec_common import (_generate_inputs, _physics_kwargs,
                                 build_model, resolve_dataset_files)
from ..data.hdf5 import load_args, load_data
from ..data.pipeline import DeviceDataset
from ..ops.filters import SobelFilter
from ..train.checkpoint import latest_epoch, restore_checkpoint
from ..train.codec_trainer import create_state, make_eval_step
from ..utils.config import select_device
from ..utils.metrics import field_sum, r2_score
from .f1_tpu_precision import tpu_default_convs

__all__ = ["breakdown", "main"]

CHANNELS = ("u", "sigma1", "sigma2")
TOP = 10


def log_k_ranks(k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each field's mean log K and its rank among ``k``'s fields (0 the
    lowest); ``k`` is (N, [1,] H, W)."""
    mean = np.log(k).mean(axis=(-2, -1)).reshape(len(k))
    return mean, np.argsort(np.argsort(mean, kind="stable"), kind="stable")


def _cli_r2(ckpt_dir: str, epoch: int, log_freq: int):
    """The R^2 the training CLI logged at ``epoch`` (its checkpoint's
    meta), or None where that epoch logged none."""
    path = os.path.join(ckpt_dir, f"model_epoch{epoch}.json")
    if not os.path.isfile(path) or epoch % log_freq:
        return None
    with open(path) as f:
        r2 = json.load(f)["logger"]["r2_test"]
    return r2[-1] if r2 else None


def breakdown(run_dir: str, epoch: int | None = None, device="cuda",
              tpu_precision: bool = False) -> dict:
    """The numbers ``main`` prints, as a dict (per-sample arrays in
    ``samples``); ``tpu_precision``: the eval forward under
    ``tpu_default_convs()``."""
    device = select_device(device) if isinstance(device, str) else device
    run_args = load_args(run_dir)
    run_args.device = str(device)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    epoch = epoch or latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")

    model = build_model(run_args, device)
    state = create_state(model, lr_max=1e-3, total_steps=1,
                         weight_decay=getattr(run_args, "weight_decay", 0.0))
    restore_checkpoint(ckpt_dir, epoch, state)
    _, val_file = resolve_dataset_files(run_args)
    x, y, stats = load_data(val_file, run_args.ntest, only_input=False,
                            return_stats=True)
    ds = DeviceDataset(x, y, batch_size=run_args.test_batch_size,
                       seed=run_args.seed + 1, device=device, shuffle=False)
    sobel = SobelFilter(run_args.imsize, correct=True,
                        filter_size=getattr(run_args, "sobel_size", 3))
    eval_step = make_eval_step(state, sobel, run_args.weight_bound,
                               **_physics_kwargs(run_args))

    sse, rel, offset, rest = [], [], [], []
    precision = (tpu_default_convs() if tpu_precision
                 else contextlib.nullcontext())
    with precision:
        outs = [(eval_step(xb, yb), yb) for xb, yb in ds.batches(0)]
    for out, yb in outs:
        err = out["output"] - yb
        mean_err = err.mean(dim=(-2, -1))
        sse.append(out["sse"])
        rel.append(out["rel_l2"])
        offset.append(err[0, 0].numel() * mean_err ** 2)
        rest.append(field_sum((err - mean_err[..., None, None]) ** 2))
    sse_t = torch.cat(sse)
    y_variation = torch.as_tensor(stats["y_variation"], device=device)
    r2 = r2_score(sse_t.sum(0), y_variation).cpu().numpy()
    sse_s = sse_t.cpu().numpy().astype(np.float64)        # (N, C)
    rel_s = torch.cat(rel).cpu().numpy().astype(np.float64)
    off_s = torch.cat(offset).cpu().numpy().astype(np.float64)
    rest_s = torch.cat(rest).cpu().numpy().astype(np.float64)

    log_k, rank = log_k_ranks(x)
    cli_r2 = _cli_r2(ckpt_dir, epoch, getattr(run_args, "log_freq", 1))
    channels = {}
    for c, name in enumerate(CHANNELS):
        total = sse_s[:, c].sum()
        order = np.argsort(-sse_s[:, c], kind="stable")
        cum = np.cumsum(sse_s[order, c])
        channels[name] = {
            "sse": total, "r2": float(r2[c]),
            "y_variation": float(stats["y_variation"][c]),
            "offset_sse": off_s[:, c].sum(), "rest_sse": rest_s[:, c].sum(),
            "offset_share": off_s[:, c].sum() / total,
            "rel_l2_mean": rel_s[:, c].mean(),
            "n_half": int(np.searchsorted(cum, 0.5 * total) + 1),
            "top": [{"index": int(i), "share": sse_s[i, c] / total,
                     "rel_l2": rel_s[i, c],
                     "offset_share": off_s[i, c] / sse_s[i, c],
                     "log_k_mean": float(log_k[i]),
                     "log_k_rank": int(rank[i])}
                    for i in order[:TOP]]}
    r2_rel = (None if cli_r2 is None else
              float(np.max(np.abs(r2 - np.asarray(cli_r2))
                           / np.abs(np.asarray(cli_r2)))))
    return {"run_dir": run_dir, "epoch": epoch, "n": len(sse_s),
            "val_file": val_file, "r2": r2.tolist(), "cli_r2": cli_r2,
            "r2_rel_diff": r2_rel, "channels": channels,
            "samples": {"sse": sse_s, "offset": off_s, "rest": rest_s,
                        "rel_l2": rel_s}}


def _jsonable(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "samples"}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run-dir", type=str, default=None)
    parser.add_argument("--val-ranks", type=int, nargs="+", default=None,
                        help="only print these canonical val fields' mean "
                             "log K and its rank (no run needed)")
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default: the latest)")
    parser.add_argument("--tpu-precision", action="store_true",
                        help="evaluate with the convs at the emulated TPU "
                             "DEFAULT precision (a run of "
                             "tools/f1_tpu_precision.py --cli codec)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    if args.val_ranks:
        k = _generate_inputs("grf", 512, 64, 512, seed=20_000 + 512)
        log_k, rank = log_k_ranks(k)
        for i in args.val_ranks:
            print(f"[r2_breakdown] val field {i}: mean log K "
                  f"{log_k[i]:.4f}, rank {rank[i]} of {len(k)} (0 the "
                  f"lowest)")
        return {i: (float(log_k[i]), int(rank[i])) for i in args.val_ranks}
    if args.run_dir is None:
        parser.error("--run-dir is required unless --val-ranks is given")
    res = breakdown(args.run_dir, args.epoch, args.device,
                    args.tpu_precision)
    print(f"[r2_breakdown] {res['run_dir']} epoch {res['epoch']}: "
          f"{res['n']} val samples of {res['val_file']}")
    for name, ch in res["channels"].items():
        print(f"[r2_breakdown] {name}: SSE {ch['sse']:.6g} of variation "
              f"{ch['y_variation']:.6g}, R2 {ch['r2']:.6f}; mean offsets "
              f"{ch['offset_sse']:.6g} ({100 * ch['offset_share']:.2f} %), "
              f"the rest {ch['rest_sse']:.6g}; half the SSE in "
              f"{ch['n_half']} samples; mean rel-L2 {ch['rel_l2_mean']:.4f}")
        for t in ch["top"]:
            print(f"[r2_breakdown]   {name} sample {t['index']}: "
                  f"{100 * t['share']:.2f} % of the SSE, rel-L2 "
                  f"{t['rel_l2']:.4f}, offset {100 * t['offset_share']:.1f} "
                  f"% of its SSE, mean log K {t['log_k_mean']:.3f} (rank "
                  f"{t['log_k_rank']} of {res['n']})")
    if res["cli_r2"] is not None:
        print(f"[r2_breakdown] R2 {res['r2']} against the CLI's "
              f"{res['cli_r2']} at epoch {res['epoch']}: largest relative "
              f"difference {res['r2_rel_diff']:.2e}")
    print(json.dumps(_jsonable(res), default=float))
    return res


if __name__ == "__main__":
    main()

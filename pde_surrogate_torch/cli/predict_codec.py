"""Batch inference (serving) for a trained DenseED codec run.

Counterpart of pde_surrogate_tpu/cli/predict_codec.py for the port's runs:
rebuild the model from the run dir's ``args.txt``, restore a checkpoint,
predict (u, flux_hor, flux_ver) for a whole HDF5 file of permeability
inputs, write the reference's NCHW layout, and print rel-L2 and R^2 when
the file carries labels.

Run:  python -m pde_surrogate_torch.cli.predict_codec \
          --run-dir <dir> [--ckpt-epoch N] --input K.hdf5 --output pred.hdf5
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.hdf5 import dataset_shapes, load_args, load_data, save_dataset
from ..models.codec import DenseED
from ..train.checkpoint import (_meta_file, latest_epoch, latest_meta_epoch,
                                restore_checkpoint, select_consistency_epoch)
from ..train.codec_trainer import create_state
from ..utils.config import select_device
from ..utils.metrics import r2_score, relative_l2, squared_error_sum

__all__ = ["main"]


def _consistency_epoch(ckpt_dir: str, epoch: int) -> int:
    """The epoch with the lowest recorded flux-pressure consistency in the
    newest meta sidecar at or below ``epoch``."""
    meta_epoch = latest_meta_epoch(ckpt_dir, at_or_below=epoch)
    if meta_epoch is None:
        raise FileNotFoundError(
            f"no model_epoch*.json sidecar at or below epoch {epoch} in "
            f"{ckpt_dir} — --select-consistency needs the checkpoint meta "
            f"written by the training CLI")
    with open(_meta_file(ckpt_dir, meta_epoch)) as f:
        history = json.load(f).get("ckpt_consistency", [])
    selected = select_consistency_epoch(history)
    if selected is None:
        raise ValueError("no finite consistency records in the checkpoint "
                         "meta")
    print(f"[predict] consistency-selected epoch {selected[0]} "
          f"(flux-pressure consistency {selected[1]:.4f})")
    return selected[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Codec batch inference")
    parser.add_argument("--run-dir", type=str, required=True,
                        help="training run dir (args.txt and checkpoints/)")
    parser.add_argument("--ckpt-epoch", type=int, default=None,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--select-consistency", action="store_true",
                        help="restore the checkpoint with the lowest "
                             "recorded flux-pressure consistency")
    parser.add_argument("--input", type=str, required=True,
                        help="HDF5 with 'input' (N,1,H,W); 'output' labels "
                             "optional (metrics printed when present)")
    parser.add_argument("--output", type=str, default=None,
                        help="HDF5 for the predictions (default: "
                             "<run-dir>/predictions_epoch<E>.hdf5)")
    parser.add_argument("--ndata", type=int, default=None,
                        help="predict only the first N samples")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    device = select_device(args.device)

    run_args = load_args(args.run_dir)
    ckpt_dir = os.path.join(args.run_dir, "checkpoints")
    epoch = args.ckpt_epoch or latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    if args.select_consistency:
        epoch = _consistency_epoch(ckpt_dir, epoch)

    model = DenseED(in_channels=1, out_channels=3, imsize=run_args.imsize,
                    blocks=run_args.blocks, growth_rate=run_args.growth_rate,
                    init_features=run_args.init_features,
                    drop_rate=run_args.drop_rate,
                    upsample=run_args.upsample).to(device)
    state = create_state(model, lr_max=1e-3, total_steps=1,
                         weight_decay=getattr(run_args, "weight_decay", 0.0))
    restore_checkpoint(ckpt_dir, epoch, state)
    model.eval()
    print(f"[predict] restored {ckpt_dir} epoch {epoch}")

    shapes = dataset_shapes(args.input)
    n_total, has_labels = shapes["input"][0], "output" in shapes
    n = min(args.ndata or n_total, n_total)
    x, y, stats = load_data(args.input, n, only_input=not has_labels,
                            return_stats=True)

    pred = np.empty((n, 3) + x.shape[2:], np.float32)
    with torch.no_grad():
        for i in range(0, n, args.batch_size):
            xb = torch.from_numpy(x[i:i + args.batch_size]).to(device)
            pred[i:i + len(xb)] = model(xb).cpu().numpy()

    out_path = args.output or os.path.join(
        args.run_dir, f"predictions_epoch{epoch}.hdf5")
    save_dataset(out_path, x, pred)
    print(f"[predict] wrote {n} predictions to {out_path}")

    if has_labels:
        pt, yt = torch.from_numpy(pred), torch.from_numpy(y)
        rel_l2 = relative_l2(pt, yt).mean(0).numpy()
        r2 = r2_score(squared_error_sum(pt, yt).sum(0),
                      torch.from_numpy(stats["y_variation"])).numpy()
        print(f"[predict] rel-L2 per channel: {rel_l2}")
        print(f"[predict] R^2 per channel: {r2}")
        return pred, rel_l2, r2
    return pred, None, None


if __name__ == "__main__":
    main()

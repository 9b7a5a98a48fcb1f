"""HDF5 dataset IO, format-compatible with the reference datasets.

File layout (utils/load.py:18-37 of the reference): datasets ``input``
(N, 1, H, W) and ``output`` (N, 3, H, W) float32 under
``datasets/{imsize}x{imsize}/``.  The port is NCHW like the files, so
``load_data`` returns the arrays as stored.  The bytes are read and written
by ``h5format`` (numpy only, no HDF5 library): files written here are read
by ``pde_surrogate_tpu.data.hdf5.load_data`` and the other way round.
"""

from __future__ import annotations

import json
import os
from argparse import Namespace

import numpy as np

from .h5format import Writer, dataset_shapes, read_rows

__all__ = ["load_data", "save_dataset", "dataset_path", "dataset_shapes",
           "read_rows", "Writer", "load_args", "save_args"]


def dataset_path(data_dir: str, imsize: int, name: str) -> str:
    """Reference dataset naming: ``{data_dir}/{imsize}x{imsize}/{name}.hdf5``."""
    return os.path.join(data_dir, f"{imsize}x{imsize}", f"{name}.hdf5")


def save_dataset(path: str, x: np.ndarray, y: np.ndarray | None = None):
    """Write ``input`` (N,1,H,W) and optional ``output`` (N,3,H,W) float32.

    ``x`` may also be (N, H, W); it gains the channel axis.
    """
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 3:
        x = x[:, None]
    arrays = {"input": x}
    if y is not None:
        arrays["output"] = np.asarray(y, dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with Writer(path, {k: v.shape for k, v in arrays.items()}) as w:
        for k, v in arrays.items():
            w.write(k, 0, v)


def load_data(hdf5_file: str, ndata: int, only_input: bool = True,
              return_stats: bool = False):
    """Load the first ``ndata`` samples as NCHW float32 arrays.

    Returns ``(x, y, stats)``; ``y`` is None when ``only_input``; ``stats``
    holds ``y_variation`` (per-channel sum of squared deviations, the R^2
    denominator, reference utils/load.py:28-30) when ``return_stats``.
    """
    x = read_rows(hdf5_file, "input", 0, ndata).astype(np.float32)
    y = None
    if not only_input:
        y = read_rows(hdf5_file, "output", 0, ndata).astype(np.float32)
    stats = {}
    if return_stats and y is not None:
        stats["y_variation"] = (
            (y - y.mean(0, keepdims=True)) ** 2).sum(axis=(0, 2, 3))
    return x, y, stats


def load_args(run_dir: str) -> Namespace:
    """Re-read a run's persisted config (reference utils/load.py:11-15)."""
    with open(os.path.join(run_dir, "args.txt")) as f:
        return Namespace(**json.load(f))


def save_args(run_dir: str, args) -> None:
    """Persist config as args.txt JSON; values JSON cannot hold become str."""
    os.makedirs(run_dir, exist_ok=True)
    d = vars(args) if isinstance(args, Namespace) else dict(args)
    clean = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            clean[k] = v
        except TypeError:
            clean[k] = str(v)
    with open(os.path.join(run_dir, "args.txt"), "w") as f:
        json.dump(clean, f, indent=4)

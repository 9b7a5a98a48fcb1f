"""Import a reference PyTorch checkpoint (.pth) into a port run dir.

Counterpart of pde_surrogate_tpu/cli/import_torch_ckpt.py, with the same
flags plus ``--device`` (default ``cuda``).  The reference saves
``run_dir/checkpoints/model_epoch{N}.pth`` and ``args.txt``; this driver
writes the port's run-dir layout (``checkpoints/model_epoch{N}.pt`` and
``.json``, ``args.txt``), which ``predict_codec`` (``--model codec``) or
``predict_cglow`` and ``post_cglow`` (``--model glow``, recorded with
``squeeze_order='reference'``) serve.  It ends with one forward of the
imported model on the device and prints the output's range.

  python -m pde_surrogate_torch.cli.import_torch_ckpt \\
      --torch-run-dir <reference run dir> --out-run-dir <new run dir>

or, with an explicit .pth and hyperparameters:

  python -m pde_surrogate_torch.cli.import_torch_ckpt \\
      --pth model_epoch100.pth --epoch 100 --imsize 64 --blocks 6 8 6 \\
      --out-run-dir experiments/imported/run1
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import torch

from ..data.hdf5 import load_args, save_args
from ..models.codec import DenseED
from ..models.glow import MultiScaleCondGlow
from ..train.checkpoint import save_checkpoint
from ..train.codec_trainer import create_state
from ..train.glow_trainer import create_glow_state
from ..utils.config import make_generator, select_device
from ..utils.torch_import import (convert_glow_state_dict, load_into,
                                  load_state_dict)

__all__ = ["import_codec_ckpt", "import_glow_ckpt", "main"]


def _write_run(out_run_dir: str, epoch: int, state, run_args: dict,
               pth: str) -> None:
    save_args(out_run_dir, run_args)
    path = save_checkpoint(os.path.join(out_run_dir, "checkpoints"), epoch,
                           state, meta={"epoch": epoch,
                                        "imported_from": os.path.abspath(pth)})
    print(f"[import] wrote {path}")


def import_codec_ckpt(pth: str, epoch: int, out_run_dir: str, *,
                      imsize: int, blocks, growth_rate: int = 16,
                      init_features: int = 48, drop_rate: float = 0.0,
                      upsample: str = "nearest", extra_args: dict | None = None,
                      device="cpu") -> DenseED:
    """Convert one codec .pth into ``out_run_dir``; returns the model."""
    model = DenseED(1, 3, imsize, list(blocks), growth_rate=growth_rate,
                    init_features=init_features, drop_rate=drop_rate,
                    upsample=upsample)
    load_into(model, load_state_dict(pth),
              "--blocks/--growth-rate/--init-features")
    model.to(device)
    run_args = {
        "imsize": imsize, "blocks": list(blocks), "growth_rate": growth_rate,
        "init_features": init_features, "drop_rate": drop_rate,
        "upsample": upsample, "imported_from": os.path.abspath(pth),
        **(extra_args or {})}
    _write_run(out_run_dir, epoch, create_state(model, 1e-3, 1), run_args,
               pth)
    return model


def import_glow_ckpt(pth: str, epoch: int, out_run_dir: str, *,
                     imsize: int, enc_blocks, flow_blocks,
                     coupling: str = "dense", LU_decompose: bool = True,
                     x_channels: int = 1, y_channels: int = 3,
                     kle: int = 512, ntrain: int = 0,
                     extra_args: dict | None = None,
                     device="cpu") -> MultiScaleCondGlow:
    """Convert a reference cGlow .pth (its model state dict) into a run dir
    that ``predict_cglow`` and ``post_cglow`` serve; returns the model.
    ``epochs`` is recorded as the imported epoch (post_cglow reads it)."""
    model = MultiScaleCondGlow(imsize, x_channels, y_channels,
                               list(enc_blocks), list(flow_blocks),
                               flow_coupling=coupling,
                               LU_decompose=LU_decompose,
                               squeeze_order="reference")
    load_into(model, convert_glow_state_dict(load_state_dict(pth)),
              "--enc-blocks/--flow-blocks/--coupling")
    model.to(device)
    run_args = {
        "imsize": imsize, "x_channels": x_channels, "y_channels": y_channels,
        "enc_blocks": list(enc_blocks), "flow_blocks": list(flow_blocks),
        "coupling": coupling, "LU_decompose": LU_decompose,
        "squeeze_order": "reference", "kle": kle, "ntrain": ntrain,
        "epochs": epoch, "data_dir": "./datasets", "weight_decay": 0.0,
        "imported_from": os.path.abspath(pth), **(extra_args or {})}
    _write_run(out_run_dir, epoch, create_glow_state(model, 1e-3, 1),
               run_args, pth)
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description="Import torch codec checkpoint")
    p.add_argument("--model", type=str, default="codec",
                   choices=["codec", "glow"])
    p.add_argument("--torch-run-dir", type=str, default=None,
                   help="reference run dir (reads args.txt + latest "
                        "checkpoints/model_epoch*.pth)")
    p.add_argument("--pth", type=str, default=None, help="explicit .pth file")
    p.add_argument("--epoch", type=int, default=None,
                   help="epoch label (default: parsed from the filename)")
    p.add_argument("--out-run-dir", type=str, required=True)
    p.add_argument("--imsize", type=int, default=64)
    p.add_argument("--blocks", type=int, nargs="+", default=[6, 8, 6])
    p.add_argument("--growth-rate", type=int, default=16)
    p.add_argument("--init-features", type=int, default=48)
    p.add_argument("--drop-rate", type=float, default=0.0)
    p.add_argument("--upsample", type=str, default="nearest")
    # glow-only
    p.add_argument("--enc-blocks", type=int, nargs="+", default=[3, 3, 3, 3])
    p.add_argument("--flow-blocks", type=int, nargs="+", default=[4, 4, 4, 4])
    p.add_argument("--coupling", type=str, default="dense",
                   choices=["dense", "wide"])
    p.add_argument("--no-LU-decompose", action="store_true", default=False)
    p.add_argument("--kle", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on ('cuda' or 'cpu')")
    args = p.parse_args(argv)
    device = select_device(args.device)

    if args.model == "glow":
        hp = dict(imsize=args.imsize, enc_blocks=args.enc_blocks,
                  flow_blocks=args.flow_blocks, coupling=args.coupling,
                  LU_decompose=not args.no_LU_decompose, kle=args.kle)
    else:
        hp = dict(imsize=args.imsize, blocks=args.blocks,
                  growth_rate=args.growth_rate,
                  init_features=args.init_features,
                  drop_rate=args.drop_rate, upsample=args.upsample)
    pth, extra = args.pth, {}
    if args.torch_run_dir:
        ta = load_args(args.torch_run_dir)
        if args.model == "glow":
            # the reference cGlow args.txt stores the (type=list) block
            # flags as their default lists (train_cglow_reverse_kl.py:36-37)
            hp = dict(imsize=ta.imsize, enc_blocks=list(ta.enc_blocks),
                      flow_blocks=list(ta.flow_blocks),
                      coupling=getattr(ta, "coupling", "dense"),
                      LU_decompose=getattr(ta, "LU_decompose", True),
                      kle=getattr(ta, "kle", args.kle))
        else:
            hp = dict(imsize=ta.imsize, blocks=list(ta.blocks),
                      growth_rate=ta.growth_rate,
                      init_features=ta.init_features,
                      drop_rate=ta.drop_rate, upsample=ta.upsample)
        extra = {"torch_args": vars(ta)}
        if pth is None:
            cand = sorted(glob.glob(os.path.join(
                glob.escape(args.torch_run_dir), "checkpoints",
                "model_epoch*.pth")),
                key=lambda f: int(re.search(r"epoch(\d+)", f).group(1)))
            if not cand:
                raise FileNotFoundError(
                    f"no model_epoch*.pth under {args.torch_run_dir}")
            pth = cand[-1]
    if pth is None:
        p.error("one of --pth / --torch-run-dir is required")
    epoch = args.epoch
    if epoch is None:
        m = re.search(r"epoch(\d+)", os.path.basename(pth))
        epoch = int(m.group(1)) if m else 0
    importer = import_glow_ckpt if args.model == "glow" else import_codec_ckpt
    model = importer(pth, epoch, args.out_run_dir, extra_args=extra,
                     device=device, **hp).eval()
    n = hp["imsize"]
    with torch.no_grad():
        if args.model == "glow":
            out = model.sample(torch.ones(1, 1, n, n, device=device), 1,
                               generator=make_generator(device, 0),
                               temperature=1.0)
        else:
            out = model(torch.ones(1, 1, n, n, device=device))
    print(f"[import] one forward on {device}: output {tuple(out.shape)}, "
          f"range [{float(out.min()):.6g}, {float(out.max()):.6g}]")
    return model


if __name__ == "__main__":
    main()

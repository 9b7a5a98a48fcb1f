"""CLI configuration: argparse parsers with reference-compatible run dirs,
seeding and the device every entry point runs on.

Counterpart of pde_surrogate_tpu/utils/config.py.  List-valued flags
(``--blocks`` etc.) take comma-separated integers.  Configs round-trip
through ``args.txt`` JSON in the run dir.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import numpy as np
import torch

__all__ = ["int_list", "BaseParser", "seed_everything", "select_device",
           "make_generator"]


def int_list(s):
    """'6,8,6' or '[6,8,6]' -> [6, 8, 6]."""
    if isinstance(s, (list, tuple)):
        return list(s)
    s = s.strip().strip("[]")
    return [int(tok) for tok in s.replace(" ", "").split(",") if tok]


def seed_everything(seed: int | None) -> int:
    """Seed Python's, numpy's and torch's global RNGs; returns the seed."""
    if seed is None:
        seed = random.randint(1, 10000)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return seed


def make_generator(device, *entropy: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by a pure function of the
    integers ``entropy`` (e.g. (seed, step)): the JAX package's
    ``fold_in`` counters, so a resumed run draws what an uninterrupted
    run draws."""
    seed = int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def select_device(name: str = "cuda",
                  local_rank: int | None = None) -> torch.device:
    """The device an entry point runs on, with the port's numerics set.

    f32 convolutions and matmuls stay full f32 (TF32 off), as the JAX
    package runs f32 convs and HIGHEST-precision Sobel products.  Asking for
    CUDA without a GPU raises: the entry points never fall back to the CPU.
    ``local_rank`` (a data-parallel rank's index on its host) picks
    ``cuda:local_rank`` and makes it the current device; the CPU ignores it.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(or device='cpu') to run on the CPU")
    if device.type == "cuda" and local_rank is not None:
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank}: only "
                               f"{torch.cuda.device_count()} GPUs visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    return device


class BaseParser(argparse.ArgumentParser):
    """Shared experiment-management plumbing for the CLIs."""

    def add_device_arg(self):
        self.add_argument("--device", type=str, default="cuda",
                          help="torch device to run on ('cuda' or 'cpu')")

    def add_logging_args(self, ckpt_freq=100, log_freq=1, plot_freq=50):
        self.add_argument("--debug", action="store_true", default=False)
        self.add_argument("--ckpt-epoch", type=int, default=None,
                          help="epoch of checkpoint to load")
        self.add_argument("--ckpt-freq", type=int, default=ckpt_freq)
        self.add_argument("--log-freq", type=int, default=log_freq)
        self.add_argument("--plot-freq", type=int, default=plot_freq)
        self.add_argument("--plot-fn", type=str, default="imshow",
                          choices=["contourf", "imshow"])
        self.add_argument("--no-plot", action="store_true", default=False,
                          help="skip figure generation (pure training)")
        self.add_argument("--profile-epoch", type=int, default=0,
                          help="capture a profiler trace of this epoch "
                               "(0: off)")

    def finalize(self, args, hparams: str):
        """Create run/ckpt dirs, seed, persist args.txt."""
        try:
            # epoch prints are the liveness signal of redirected logs
            sys.stdout.reconfigure(line_buffering=True)
            sys.stderr.reconfigure(line_buffering=True)
        except (AttributeError, ValueError):
            pass  # non-reconfigurable streams (e.g. pytest capture)
        if args.debug:
            hparams = "debug/" + hparams
        args.run_dir = os.path.join(args.exp_dir, args.exp_name, hparams)
        args.ckpt_dir = os.path.join(args.run_dir, "checkpoints")
        os.makedirs(args.ckpt_dir, exist_ok=True)
        args.seed = seed_everything(getattr(args, "seed", None))
        with open(os.path.join(args.run_dir, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=4)
        return args

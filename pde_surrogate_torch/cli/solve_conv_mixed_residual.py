"""Solve ONE Darcy instance with a conv-decoder prior, Adam then L-BFGS.

Counterpart of pde_surrogate_tpu/cli/solve_conv_mixed_residual.py (the
reference's solve_conv_mixed_residual.py): a Decoder maps a fixed random
latent (1, nz, 16, 16) to the solution fields (u, sigma1, sigma2) and only
its weights are optimized against the Sobel mixed-residual loss, first by
Adam (``--adam-warmup`` steps), then by L-BFGS (zoom linesearch, or the
reference's fixed ``--lr`` steps with ``--linesearch fixed``), 20 steps an
epoch.  ``--nonlinear`` switches to the polynomial constitutive law, with
the finite-volume Newton solver (``solvers/fd_darcy.solve_nonlinear_darcy``,
cached as ``output_fv_newton.npy`` in the run dir) as the reference
solution.  The same flags, defaults, run-dir names and ``epoch{N}.npy``
predictions as the JAX package, plus ``--device`` (default ``cuda``).

The loss and the predictions run the Decoder with train-mode BatchNorm
(batch statistics), as the reference does; its running statistics are
never used.  Each epoch prints its loss, its loss evaluations and its wall
time; each test epoch saves a figure of target, prediction and error (with
``--animate`` a numbered frame, assembled into ``animation.gif`` at the
end), unless ``--no-plot``.

Run:  python -m pde_surrogate_torch.cli.solve_conv_mixed_residual \\
          --data grf --kle 1024 --idx 8
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.hdf5 import dataset_path, load_data
from ..models.codec import Decoder
from ..ops.darcy import (conv_boundary_condition,
                         conv_constitutive_constraint,
                         conv_constitutive_constraint_nonlinear,
                         conv_continuity_constraint)
from ..ops.filters import SobelFilter
from ..solvers.fd_darcy import solve_nonlinear_darcy
from ..train.checkpoint import save_weights
from ..train.lbfgs import (FlatParams, lbfgs_optimizer, make_lbfgs_epoch,
                           run_adam_warmup)
from ..utils.config import BaseParser, int_list, seed_everything, select_device
from ..viz.plot import (assemble_gif, plot_prediction_det,
                        plot_prediction_det_animate, save_stats)
from ._codec_common import ensure_dataset

__all__ = ["main", "adam_warmup", "ensure_test_dataset", "plot_prediction",
           "write_animation", "relative_l2", "sync"]


def ensure_test_dataset(args) -> str:
    """The test file of a family (reference solve_conv_mixed_residual.py
    :83-92), generated with solver labels on ``args.device`` when missing.

    Files are generated at the canonical size their name declares, so the
    content depends on (family, imsize, kle) only: a later run with a
    larger ``--idx`` never regenerates the file.  The channelized file is
    the codec drivers' test split (same name and seed 20 000).
    """
    if args.data == "grf":
        if args.kle not in (128, 512, 1024, 2048):
            raise ValueError(f"--kle {args.kle}: the grf test sets have KLE "
                             f"128, 512, 1024 or 2048")
        ntest = 1000 if args.kle == 512 else 1024
        name, family, n = f"kle{args.kle}_lhs{ntest}_test", "grf", ntest
        seed = 32_000 + args.kle
    elif args.data == "warped_grf":
        name, family, n, seed = ("warped_gp_ng64_n1000", "warped_grf", 1000,
                                 30_000)
    elif args.data == "channelized":
        name, family, n, seed = ("channel_ng64_n512_test", "channelized", 512,
                                 20_000)
    else:
        raise ValueError("No dataset found for the specified parameters")
    if not 0 <= args.idx < n:
        raise ValueError(f"--idx {args.idx} out of range for {name} ({n})")
    path = dataset_path(args.data_dir, args.imsize, name)
    ensure_dataset(path, family, n, args.imsize, getattr(args, "kle", 0),
                   seed=seed, with_output=True, device=args.device)
    return path


def plot_prediction(args, run_dir: str, target: np.ndarray,
                    prediction: np.ndarray, epoch: int) -> None:
    """A test epoch's figure of both solvers: target, prediction and error
    (``pred_epoch{E}_{idx}.png``), or with ``--animate`` the frame
    ``pred_{epoch // test_freq}.png``."""
    if args.no_plot:
        return
    if args.animate:
        plot_prediction_det_animate(run_dir, target, prediction, epoch,
                                    args.idx, epoch // args.test_freq,
                                    cmap=args.cmap,
                                    same_scale=args.same_scale)
    else:
        plot_prediction_det(run_dir, target, prediction, epoch, args.idx,
                            cmap=args.cmap, same_scale=args.same_scale)


def write_animation(args, run_dir: str) -> None:
    """With ``--animate``, the frames assembled into ``animation.gif``."""
    if args.animate and not args.no_plot:
        gif = assemble_gif(run_dir)
        if gif:
            print(f"animation: {gif}")


def relative_l2(prediction: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-channel rel-L2 of (3, H, W) fields."""
    return np.sqrt(((prediction - target) ** 2).sum((1, 2))
                   / (target ** 2).sum((1, 2)))


def sync(device: torch.device) -> None:
    """Wait for the device, so that host clocks time finished work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam_warmup(loss_fn, params, args, device, logger):
    """The Adam warmup of both solvers; logs its ms per step and the loss
    it ends at."""
    if args.adam_warmup <= 0:
        return params
    sync(device)
    tic = time.perf_counter()
    params, warm_loss = run_adam_warmup(loss_fn, params, args.adam_warmup,
                                        args.adam_lr)
    ms = (time.perf_counter() - tic) * 1e3 / args.adam_warmup
    logger["adam_ms_per_step"], logger["adam_loss"] = ms, warm_loss
    print(f"Adam warmup ({args.adam_warmup} steps): loss {warm_loss:.6f}, "
          f"{ms:.3f} ms/step")
    return params


class Parser(BaseParser):
    def __init__(self):
        super().__init__(description="CNN to solve PDE")
        self.add_argument("--exp-dir", type=str,
                          default="./experiments/solver")
        self.add_argument("--nonlinear", action="store_true", default=False)
        self.add_argument("--data-dir", type=str, default="./datasets")
        self.add_argument("--data", type=str, default="grf",
                          choices=["grf", "channelized", "warped_grf"])
        self.add_argument("--kle", type=int, default=512)
        self.add_argument("--imsize", type=int, default=64)
        self.add_argument("--idx", type=int, default=8)
        self.add_argument("--alpha1", type=float, default=1.0)
        self.add_argument("--alpha2", type=float, default=1.0)
        self.add_argument("--nz", type=int, default=1)
        self.add_argument("--blocks", type=int_list, default=[8, 6])
        self.add_argument("--weight-bound", type=float, default=10.0)
        self.add_argument("--lr", type=float, default=0.5)
        self.add_argument("--epochs", type=int, default=500)
        self.add_argument("--test-freq", type=int, default=50)
        self.add_argument("--ckpt-freq", type=int, default=250)
        self.add_argument("--cmap", type=str, default="jet")
        self.add_argument("--same-scale", action="store_true")
        self.add_argument("--animate", action="store_true")
        self.add_argument("--seed", type=int, default=1)
        self.add_argument("-v", "--verbose", action="store_true")
        self.add_argument("--no-plot", action="store_true", default=False)
        self.add_argument("--linesearch", type=str, default="zoom",
                          choices=["zoom", "fixed"],
                          help="zoom after an Adam warmup (default), or the "
                               "reference's fixed lr steps")
        self.add_argument("--adam-warmup", type=int, default=20000,
                          help="Adam steps before L-BFGS; 0 disables")
        self.add_argument("--adam-lr", type=float, default=2e-3)
        self.add_argument("--sobel-size", type=int, default=3, choices=[3, 5],
                          help="derivative stencil of the physics loss")
        self.add_device_arg()


def _oracle(args, run_dir: str, perm: torch.Tensor) -> np.ndarray:
    """The nonlinear reference solution, solved once per run dir and cached
    as output_fv_newton.npy (the reference caches output_fenics.npy)."""
    oracle_file = os.path.join(run_dir, "output_fv_newton.npy")
    if os.path.isfile(oracle_file):
        return np.load(oracle_file)
    print("Solving nonlinear Darcy with the FV Newton solver...")
    tic = time.perf_counter()
    target = solve_nonlinear_darcy(perm[0, 0], args.alpha1,
                                   args.alpha2).cpu().numpy()
    print(f"FV Newton solve: {time.perf_counter() - tic:.3f} s")
    np.save(oracle_file, target)
    return target


def main(argv=None):
    args = Parser().parse_args(argv)
    device = select_device(args.device)
    seed_everything(args.seed)
    dataset = (f"{args.data}_kle{args.kle}" if args.data == "grf"
               else args.data)
    hyparams = (f"{dataset}_idx{args.idx}_dz{args.nz}_blocks{args.blocks}_"
                f"lr{args.lr}_wb{args.weight_bound}_epochs{args.epochs}")
    exp_name = ("conv_mixed_residual_nonlinear" if args.nonlinear
                else "conv_mixed_residual")
    if args.nonlinear:
        hyparams += f"_alpha1_{args.alpha1}_alpha2_{args.alpha2}"
    run_dir = os.path.join(args.exp_dir, exp_name, hyparams)
    os.makedirs(run_dir, exist_ok=True)

    hdf5_file = ensure_test_dataset(args)
    x_all, y_all, _ = load_data(hdf5_file, args.idx + 1, only_input=False)
    perm = torch.from_numpy(x_all[[args.idx]]).to(device)     # (1, 1, H, W)
    target = (_oracle(args, run_dir, perm) if args.nonlinear
              else y_all[args.idx])                            # (3, H, W)

    model = Decoder(args.nz, out_channels=3, blocks=args.blocks).to(device)
    model.train()
    rng = np.random.default_rng(args.seed)
    # the JAX package's latent, drawn NHWC: 16x16 at imsize 64 (the decoder
    # upsamples x4)
    sz = args.imsize // 4
    latent = rng.standard_normal((1, sz, sz, args.nz)).astype(np.float32) * 0.5
    latent = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(latent, -1, 1))).to(device)
    sobel = SobelFilter(args.imsize, correct=True,
                        filter_size=args.sobel_size)
    flat = FlatParams(model)
    params = flat.vector()
    print(f"# params {params.numel()}")

    def forward(x):
        # train-mode BN as the reference (it never calls eval()); the
        # running statistics it updates are unused
        return torch.func.functional_call(model, flat.unflatten(x),
                                          (latent,))

    def loss_fn(x):
        output = forward(x)
        if args.nonlinear:
            energy = (conv_constitutive_constraint_nonlinear(
                perm, output, sobel, args.alpha1, args.alpha2)
                + conv_continuity_constraint(output, sobel))
        else:
            energy = (conv_constitutive_constraint(perm, output, sobel)
                      + conv_continuity_constraint(output, sobel))
        diri, neum = conv_boundary_condition(output)
        return energy + (diri + neum) * args.weight_bound

    logger = {"loss": [], "evals": [], "epoch_seconds": [], "rel_l2": []}
    params = adam_warmup(loss_fn, params, args, device, logger)

    fixed = args.linesearch == "fixed"

    def build_opt(lr_scale: float):
        opt = lbfgs_optimizer(
            memory_size=50,
            learning_rate=args.lr * lr_scale if fixed else None)
        return opt, make_lbfgs_epoch(loss_fn, opt, iters_per_epoch=20,
                                     with_linesearch=not fixed)

    lr_scale = 1.0
    opt, epoch_fn = build_opt(lr_scale)
    opt_state = opt.init(params)

    def test(epoch, params):
        if epoch % args.epochs == 0 or epoch % args.test_freq == 0:
            with torch.no_grad():
                output = forward(params)[0].cpu().numpy()
            plot_prediction(args, run_dir, target, output, epoch)
            np.save(os.path.join(run_dir, f"epoch{epoch}.npy"), output)
            rel = relative_l2(output, target)
            logger["rel_l2"].append((epoch, rel.tolist()))
            print(f"epoch {epoch}: relative l2 {rel}")

    print("start training...")
    tic = time.time()
    # divergence guard: fixed-step L-BFGS can overshoot and go NaN on this
    # objective; restart from the best params with fresh curvature memory
    best_loss, best_params = float("inf"), params
    bad_restarts = 0
    for epoch in range(1, args.epochs + 1):
        sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss = epoch_fn(params, opt_state)
        loss = float(loss)
        logger["epoch_seconds"].append(time.perf_counter() - t0)
        logger["evals"].append(opt_state.evals)
        if not np.isfinite(loss) or loss > 100.0 * max(best_loss, 1e-12):
            bad_restarts += 1
            if fixed:
                # the same point and step would re-diverge identically, so
                # each fixed-step restart also halves the step
                lr_scale *= 0.5
                opt, epoch_fn = build_opt(lr_scale)
                note = f"lr x{lr_scale}"
            else:
                # zoom picks its own steps: only the curvature memory resets
                note = "fresh curvature memory"
            print(f"epoch {epoch}: diverged (loss {loss}); restarting from "
                  f"best ({best_loss:.6f}) with {note}")
            params = best_params
            opt_state = opt.init(params)
            logger["loss"].append(best_loss if np.isfinite(best_loss)
                                  else float("nan"))
            if not fixed and bad_restarts >= 3:
                print("zoom linesearch re-diverged 3x from the same state; "
                      "stopping early at the best-seen params")
                break
            if fixed and bad_restarts >= 60:
                print("fixed-step L-BFGS re-diverged 60x consecutively; "
                      "stopping early at the best-seen params")
                break
            continue
        bad_restarts = 0
        if loss < best_loss:
            best_loss, best_params = loss, params
        logger["loss"].append(loss)
        print(f"epoch {epoch}: loss {loss:.6f}, {logger['evals'][-1]} loss "
              f"evaluations, {logger['epoch_seconds'][-1]:.3f} s")
        if epoch % args.ckpt_freq == 0:
            flat.load(params)
            save_weights(run_dir, epoch, model)
        test(epoch, params)
    print(f"Finished optimization for {args.epochs} epochs using "
          f"{(time.time() - tic) / 60:.3f} minutes")
    save_stats(run_dir, logger, "loss")
    write_animation(args, run_dir)
    flat.load(params)
    return params, logger, target


if __name__ == "__main__":
    main()

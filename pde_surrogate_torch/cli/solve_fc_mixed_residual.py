"""Solve ONE Darcy instance with an FC net (PINN style), Adam then L-BFGS.

Counterpart of pde_surrogate_tpu/cli/solve_fc_mixed_residual.py (the
reference's solve_fc_mixed_residual.py): a CPPN maps (y, x) coordinates to
(u, tau_ver, tau_hor); the loss is the mixed residual at collocation points
(per-point Jacobians by ``torch.func``) plus the Dirichlet and Neumann
penalties.  Adam runs ``--adam-warmup`` steps (4000 by default: longer
warmups let the deep tanh net collapse to the constant basin), then
L-BFGS 20 steps an epoch.  The same flags, defaults, run-dir names and
``epoch{N}.npy`` predictions as the JAX package, plus ``--device`` (default
``cuda``).

The net's flux channels are (flux_ver, flux_hor); the predictions are
saved in the dataset's order (u, flux_hor, flux_ver), as in the reference.
On the grid, K is gathered at the sampled points.  Plots, ``--animate`` and
the 640^2 render are not ported yet (ROADMAP E1): the run prints a note
and trains without them.

Run:  python -m pde_surrogate_torch.cli.solve_fc_mixed_residual \\
          --data grf --kle 512 --idx 8
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.hdf5 import load_data
from ..models.cppn import CPPN, fc_model_size
from ..ops.darcy import mixed_residual_fc, neumann_boundary_mixed
from ..ops.sampling import SampleSpatial2d
from ..train.checkpoint import save_weights
from ..train.lbfgs import FlatParams, lbfgs_optimizer, make_lbfgs_epoch
from ..utils.config import BaseParser, seed_everything, select_device
from ._codec_common import save_stats
from .solve_conv_mixed_residual import (adam_warmup, ensure_test_dataset,
                                        note_unported_plots, relative_l2,
                                        sync)

__all__ = ["main"]


class Parser(BaseParser):
    def __init__(self):
        super().__init__(description="FC nets to solve PDE")
        self.add_argument("--exp-dir", type=str,
                          default="./experiments/solver")
        self.add_argument("--data-dir", type=str, default="./datasets")
        self.add_argument("--data", type=str, default="grf",
                          choices=["grf", "channelized", "warped_grf"])
        self.add_argument("--kle", type=int, default=512)
        self.add_argument("--imsize", type=int, default=64)
        self.add_argument("--idx", type=int, default=8)
        self.add_argument("--alpha1", type=float, default=1.0)
        self.add_argument("--alpha2", type=float, default=1.0)
        self.add_argument("--dim-hidden", type=int, default=512)
        self.add_argument("--layers-hidden", type=int, default=8)
        self.add_argument("--off-grid", action="store_true")
        self.add_argument("--n-colloc", type=int, default=4096)
        self.add_argument("--weight-bound", type=float, default=10.0)
        self.add_argument("--lr", type=float, default=0.5)
        self.add_argument("--epochs", type=int, default=2000)
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
                          help="zoom: Wolfe linesearch (stable for the deep "
                               "FC net); fixed: the reference's lr steps")
        self.add_argument("--adam-warmup", type=int, default=4000,
                          help="Adam steps before L-BFGS; 0 disables")
        self.add_argument("--adam-lr", type=float, default=2e-3)
        self.add_device_arg()


def main(argv=None):
    args = Parser().parse_args(argv)
    device = select_device(args.device)
    seed_everything(args.seed)
    dataset = (f"{args.data}_kle{args.kle}" if args.data == "grf"
               else args.data)
    hyparams = (f"{dataset}_idx{args.idx}_dhid{args.dim_hidden}_"
                f"lhid{args.layers_hidden}_alpha1_{args.alpha1}_"
                f"alpha2_{args.alpha2}_lr{args.lr}_wb{args.weight_bound}_"
                f"epochs{args.epochs}_ongrid_{not args.off_grid}_"
                f"ncolloc{args.n_colloc}")
    run_dir = os.path.join(args.exp_dir, "fc_mixed_residual", hyparams)
    os.makedirs(run_dir, exist_ok=True)
    note_unported_plots(args)
    if not args.no_plot:
        print("[note] the 640^2 solution render is not ported yet "
              "(ROADMAP E1)")

    hdf5_file = ensure_test_dataset(args)
    x_all, y_all, _ = load_data(hdf5_file, args.idx + 1, only_input=False)
    perm_grid = x_all[args.idx, 0]                  # (H, W)
    target = y_all[args.idx]                        # (3, H, W): u, fh, fv

    model = CPPN(dim_in=2, dim_out=3, dim_hidden=args.dim_hidden,
                 layers_hidden=args.layers_hidden).to(device)
    print(fc_model_size(model))
    flat = FlatParams(model)
    params = flat.vector()

    def pts(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    sampler = SampleSpatial2d(args.imsize, args.imsize, rng=args.seed)
    on_grid = not args.off_grid
    colloc = sampler.colloc(on_grid, n_samples=args.n_colloc)
    x_colloc = pts(colloc)
    x_dirichlet = pts(np.concatenate(
        [sampler.left(on_grid=False, n_samples=256),
         sampler.right(on_grid=False, n_samples=256)], 0))
    y_dirichlet = torch.cat([torch.ones(256, 1), torch.zeros(256, 1)]).to(
        device)
    x_neumann = pts(np.concatenate([sampler.top(on_grid),
                                    sampler.bottom(on_grid)], 0))
    if on_grid:
        # K at the sampled points, so that any --n-colloc subset stays
        # aligned with its points (row-major order for the full grid)
        iy = np.rint(colloc[:, 0] * (args.imsize - 1)).astype(int)
        ix = np.rint(colloc[:, 1] * (args.imsize - 1)).astype(int)
        K_colloc = pts(perm_grid[iy, ix].reshape(-1, 1))
    else:
        K_colloc = pts(perm_grid.reshape(-1, 1))    # interpolated in the loss

    def loss_fn(x):
        net = (model, flat.unflatten(x))
        loss_colloc = mixed_residual_fc(net, x_colloc, K_colloc,
                                        rand_colloc=args.off_grid,
                                        imsize=args.imsize)
        loss_diri = torch.mean(
            (torch.func.functional_call(model, net[1], (x_dirichlet,))[:, 0:1]
             - y_dirichlet) ** 2)
        loss_neum = neumann_boundary_mixed(net, x_neumann)
        return loss_colloc + args.weight_bound * (loss_diri + loss_neum)

    logger = {"loss": [], "evals": [], "epoch_seconds": [], "rel_l2": []}
    params = adam_warmup(loss_fn, params, args, device, logger)

    fixed = args.linesearch == "fixed"
    opt = lbfgs_optimizer(memory_size=50,
                          learning_rate=args.lr if fixed else None)
    opt_state = opt.init(params)
    epoch_fn = make_lbfgs_epoch(loss_fn, opt, iters_per_epoch=20,
                                with_linesearch=not fixed)

    # full-grid prediction points, (y, x) ordering
    n = args.imsize
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    xy_test = pts(np.stack([yy.ravel() / (n - 1), xx.ravel() / (n - 1)], 1))

    def test(epoch, params):
        if epoch % args.epochs == 0 or epoch % args.test_freq == 0:
            with torch.no_grad():
                y_pred = torch.func.functional_call(
                    model, flat.unflatten(params), (xy_test,)).cpu().numpy()
            u = y_pred[:, 0].reshape(n, n)
            flux_ver = y_pred[:, 1].reshape(n, n)
            flux_hor = y_pred[:, 2].reshape(n, n)
            prediction = np.stack([u, flux_hor, flux_ver])  # dataset order
            np.save(os.path.join(run_dir, f"epoch{epoch}.npy"), prediction)
            rel = relative_l2(prediction, target)
            logger["rel_l2"].append((epoch, rel.tolist()))
            print(f"epoch {epoch}: relative l2 {rel}")

    print("start training...")
    tic = time.time()
    for epoch in range(1, args.epochs + 1):
        sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss = epoch_fn(params, opt_state)
        loss = float(loss)
        logger["epoch_seconds"].append(time.perf_counter() - t0)
        logger["evals"].append(opt_state.evals)
        logger["loss"].append(loss)
        print(f"epoch {epoch}: loss {loss:.10f}, {opt_state.evals} loss "
              f"evaluations, {logger['epoch_seconds'][-1]:.3f} s")
        if epoch % args.ckpt_freq == 0:
            flat.load(params)
            save_weights(run_dir, epoch, model)
        test(epoch, params)
    print(f"Finished training {args.epochs} epochs in "
          f"{(time.time() - tic) / 60:.3f} minutes")
    save_stats(run_dir, logger, "loss")
    flat.load(params)
    return params, logger, target


if __name__ == "__main__":
    main()

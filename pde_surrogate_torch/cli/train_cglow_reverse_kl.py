"""Probabilistic surrogate: multiscale conditional Glow, reverse-KL training.

Counterpart of pde_surrogate_tpu/cli/train_cglow_reverse_kl.py: the same
flags, defaults and run-dir names (the ``_im{N}`` suffix with its fallback
to a legacy run dir on resume, the ``_{physics}`` / ``_w`` / ``_fw`` /
``_cg`` suffixes, ``--squeeze-order`` inherited from the source run's
args.txt), plus ``--device`` (default ``cuda``).  Label-free: the loss is
beta * (physics residual + boundary) on generated samples plus the
predictive entropy in bits per pixel.  Every 10th epoch evaluates the mean
of 20 samples; the test entropy is the mean over the test batches.

Unless ``--no-plot``, every ``--plot-freq``-th and the last epoch draw
the predictive mean, std and error, and 15 samples, of random fields of
the first test batch (20 draws each) into ``training/predictions``.
``--no-scan-epochs`` is accepted and changes nothing (the port always runs
the per-step loop), nor does ``--profile-epoch``, as in the JAX CLI.
``--n-devices N`` trains data-parallel on N ranks (``parallel/launch.py``):
rank 0 generates the dataset files, the ActNorm data-init runs on the full
first global batch on every rank, each rank steps and evaluates on its
shard of every global batch with the global batch's noise, and rank 0
alone prints, logs, plots and saves.

Run:  python -m pde_surrogate_torch.cli.train_cglow_reverse_kl \
          --beta 150 --kle 512 --imsize 64 --data-init
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..data.hdf5 import load_data, save_args
from ..data.pipeline import DeviceDataset
from ..models.codec import module_size
from ..models.glow import MultiScaleCondGlow
from ..ops.filters import SobelFilter
from ..parallel.launch import check_devices, run_driver
from ..parallel.mesh import (all_gather, all_mean, is_main, rank0_first,
                             replicate)
from ..train.checkpoint import (latest_epoch, restore_checkpoint,
                                restore_weights, save_checkpoint)
from ..train.glow_trainer import (create_glow_state, data_init_actnorm,
                                  glow_lr, make_glow_eval_step,
                                  make_reverse_kl_step)
from ..utils.config import BaseParser, int_list, make_generator, select_device
from ..utils.metrics import r2_score
from ..utils.observability import JsonlLogger
from ..viz.plot import plot_prediction_bayes2, save_samples, save_stats
from ._codec_common import resolve_dataset_files

__all__ = ["Parser", "main", "train", "build_model"]


class Parser(BaseParser):
    def __init__(self):
        super().__init__(description="Training multiscale conditional Glows "
                                     "with reverse KLD loss")
        self.add_argument("--exp-name", type=str, default="cglow/reverse_kld")
        self.add_argument("--exp-dir", type=str, default="./experiments")
        # cglow
        self.add_argument("--enc-blocks", type=int_list, default=[3, 4, 4])
        self.add_argument("--flow-blocks", type=int_list, default=[6, 6, 6])
        self.add_argument("--no-LU-decompose", action="store_true",
                          default=False)
        self.add_argument("--coupling", type=str, default="dense",
                          choices=["dense", "wide"],
                          help="affine-coupling net type")
        self.add_argument("--squeeze-order", type=str, default=None,
                          choices=["subpixel", "reference"],
                          help="squeeze channel encoding (models/flow."
                               "Squeeze). Default: inherited from the "
                               "--resume/--init-from source run dir's "
                               "args.txt, else 'subpixel'")
        # data
        self.add_argument("--data-dir", type=str, default="./datasets")
        self.add_argument("--data", type=str, default="grf_kle512",
                          choices=["grf_kle512", "channelized", "warped_grf"],
                          help="input-field family")
        self.add_argument("--kle", type=int, default=100)
        self.add_argument("--ntrain", type=int, default=4096)
        self.add_argument("--ntest", type=int, default=512)
        self.add_argument("--x-channels", type=int, default=1)
        self.add_argument("--y-channels", type=int, default=3)
        self.add_argument("--imsize", type=int, default=32)
        # training
        self.add_argument("--data-init", action="store_true", default=False)
        self.add_argument("--epochs", type=int, default=400)
        self.add_argument("--lr", type=float, default=1.5e-3)
        self.add_argument("--lr-div", type=float, default=2.0)
        self.add_argument("--lr-pct", type=float, default=0.3)
        self.add_argument("--beta", type=float, default=150.0)
        self.add_argument("--weight-decay", type=float, default=0.0)
        self.add_argument("--weight-bound", type=float, default=50.0)
        self.add_argument("--physics", type=str, default="sobel",
                          choices=["sobel", "sobel_fvcg", "fvcg"],
                          help="per-sample physics loss: 'sobel' = the "
                               "reference's mixed residual; 'sobel_fvcg' "
                               "adds the label-free CG anchors "
                               "(ops/darcy.fv_cg_anchors) to every drawn "
                               "sample; 'fvcg' = the pure CG-anchor "
                               "objective (no Sobel terms)")
        self.add_argument("--fvcg-weight", type=float, default=100.0,
                          help="weight of the CG pressure-error anchor "
                               "under --physics sobel_fvcg")
        self.add_argument("--fvcg-flux-weight", type=float, default=0.0,
                          help="weight of the CG-corrected-pressure flux "
                               "anchor under --physics sobel_fvcg")
        self.add_argument("--fvcg-iters", type=int, default=None,
                          help="CG depth of the fvcg anchors (default: "
                               "the grid size)")
        self.add_argument("--batch-size", type=int, default=32)
        self.add_argument("--test-batch-size", type=int, default=64)
        self.add_argument("--seed", type=int, default=1)
        self.add_argument("--n-devices", type=int, default=None,
                          help="train data-parallel on this many devices "
                               "(one rank each; parallel/launch.py)")
        self.add_argument("--no-scan-epochs", dest="scan_epochs",
                          action="store_false", default=True,
                          help="accepted for compatibility: the port always "
                               "runs the per-step loop (the same semantics)")
        self.add_argument("--resume", action="store_true", default=False)
        self.add_argument("--init-from", type=str, default=None,
                          help="run dir (or 'dir:epoch') to warm-start "
                               "weights from, with a fresh optimizer and lr "
                               "schedule (use a lower --lr)")
        self.add_device_arg()
        self.add_logging_args(ckpt_freq=25, log_freq=1, plot_freq=25)

    def parse(self, argv=None):
        args = self.parse_args(argv)
        check_devices(args.n_devices, args.device)
        args.LU_decompose = not args.no_LU_decompose
        if len(args.enc_blocks) != len(args.flow_blocks):
            self.error("--enc-blocks and --flow-blocks must have equal "
                       "length")
        if args.ntrain % args.batch_size or args.ntest % args.test_batch_size:
            self.error("--ntrain and --ntest must be multiples of "
                       "--batch-size and --test-batch-size")
        head = (f"kle{args.kle}" if args.data == "grf_kle512"
                else args.data)
        hparams = (f"{head}_ntrain{args.ntrain}_"
                   f"ENC_blocks{args.enc_blocks}_FLOW_blocks{args.flow_blocks}_"
                   f"wb{args.weight_bound}_beta{args.beta}_"
                   f"batch{args.batch_size}_lr{args.lr}_epochs{args.epochs}")
        if args.imsize != 32:
            hparams += f"_im{args.imsize}"
        if args.data_init:
            hparams = hparams + "_data_init"
        # the anchor weights name the dir only under sobel_fvcg: the pure
        # fvcg objective is unweighted, so they would have no effect there
        if args.physics != "sobel":
            hparams += f"_{args.physics}"
            if args.physics == "sobel_fvcg":
                if args.fvcg_weight != 100.0:
                    hparams += f"_w{args.fvcg_weight:g}"
                if args.fvcg_flux_weight != 0.0:
                    hparams += f"_fw{args.fvcg_flux_weight:g}"
            elif args.fvcg_weight != 100.0 or args.fvcg_flux_weight != 0.0:
                raise SystemExit(
                    "--fvcg-weight/--fvcg-flux-weight only apply to "
                    "--physics sobel_fvcg; the pure fvcg objective is "
                    "unweighted err_u + err_flux, so these flags would be "
                    "silent no-ops")
            if args.fvcg_iters is not None:
                hparams += f"_cg{args.fvcg_iters}"
        # runs made before the _im{N} suffix: a resume finds them
        if (args.resume or args.ckpt_epoch is not None) and args.imsize != 32:
            hp = ("debug/" + hparams) if args.debug else hparams
            new_dir = os.path.join(args.exp_dir, args.exp_name, hp)
            legacy = hparams.replace(f"_im{args.imsize}", "", 1)
            hp_leg = ("debug/" + legacy) if args.debug else legacy
            legacy_dir = os.path.join(args.exp_dir, args.exp_name, hp_leg)
            if not os.path.exists(os.path.join(new_dir, "args.txt")) \
                    and os.path.exists(os.path.join(legacy_dir, "args.txt")):
                print(f"--resume: using legacy (pre-_im{args.imsize}) run "
                      f"dir {legacy_dir}")
                hparams = legacy
        # the squeeze order must match the weights being loaded (both
        # orders have the same parameters): read it from the source run's
        # args.txt before finalize overwrites it
        recorded = None
        if args.resume or args.ckpt_epoch is not None:
            hp = ("debug/" + hparams) if args.debug else hparams
            prior = os.path.join(args.exp_dir, args.exp_name, hp, "args.txt")
        elif args.init_from:
            prior = os.path.join(args.init_from.partition(":")[0], "args.txt")
        else:
            prior = None
        if prior is not None and os.path.exists(prior):
            with open(prior) as f:
                recorded = json.load(f).get("squeeze_order")
        if recorded is not None:
            if args.squeeze_order is not None \
                    and args.squeeze_order != recorded:
                raise ValueError(
                    f"--squeeze-order {args.squeeze_order!r} conflicts with "
                    f"the source run dir's recorded {recorded!r}")
            args.squeeze_order = recorded
        if args.squeeze_order is None:
            args.squeeze_order = "subpixel"
        args = self.finalize(args, hparams)
        if args.resume and args.ckpt_epoch is None:
            args.ckpt_epoch = latest_epoch(args.ckpt_dir)
        return args


def build_model(run_args, device) -> MultiScaleCondGlow:
    """The run's model (training args or a run dir's args.txt)."""
    return MultiScaleCondGlow(
        img_size=run_args.imsize, x_channels=run_args.x_channels,
        y_channels=run_args.y_channels, enc_blocks=run_args.enc_blocks,
        flow_blocks=run_args.flow_blocks,
        flow_coupling=getattr(run_args, "coupling", "dense"),
        LU_decompose=run_args.LU_decompose, squeeze_factor=2,
        squeeze_order=getattr(run_args, "squeeze_order", "subpixel"),
        seed=getattr(run_args, "seed", 0) or 0).to(device)


def main(argv=None):
    """Train; returns ``(state, logger)`` (rank 0's under --n-devices)."""
    args = Parser().parse(argv)
    if args.n_devices is None:
        return train(args)
    return run_driver(train, args, _read_back)


def _state(args, model, mesh=None):
    return create_glow_state(model, lr_max=args.lr,
                             total_steps=args.epochs
                             * (args.ntrain // args.batch_size),
                             div_factor=args.lr_div, pct_start=args.lr_pct,
                             weight_decay=args.weight_decay, seed=args.seed,
                             mesh=mesh)


def _read_back(args, ckpt_dir: str):
    """``(state, logger)`` of a data-parallel run from the checkpoint rank
    0 saved at its end (epoch 0 of ``ckpt_dir``)."""
    state = _state(args, build_model(args, select_device(args.device)))
    state, meta = restore_checkpoint(ckpt_dir, 0, state, with_meta=True)
    return state, meta["logger"]


def train(args, mesh=None):
    """The training run of parsed ``args``; ``mesh``: this rank's data
    mesh.  Returns ``(state, logger)``."""
    device = mesh.device if mesh is not None else select_device(args.device)
    rank0 = is_main(mesh)
    args.train_dir = os.path.join(args.run_dir, "training")
    args.pred_dir = os.path.join(args.train_dir, "predictions")
    os.makedirs(args.pred_dir, exist_ok=True)

    # inputs for training (labels too under --data-init), labelled val
    with rank0_first(mesh):
        train_file, test_file = resolve_dataset_files(
            args, need_train_output=args.data_init)
    x_train, y_train, _ = load_data(train_file, args.ntrain,
                                    only_input=not args.data_init)
    x_test, y_test, stats = load_data(test_file, args.ntest, only_input=False,
                                      return_stats=True)
    print(f"Test output variation per channel: {stats['y_variation']}")
    y_variation = torch.as_tensor(stats["y_variation"], device=device)
    n_out_pixels = int(np.prod(y_test.shape[1:]))
    print(f"# out pixels per output: {n_out_pixels}")

    model = build_model(args, device)
    train_ds = DeviceDataset(x_train, batch_size=args.batch_size,
                             seed=args.seed, device=device, mesh=mesh)
    test_ds = DeviceDataset(x_test, y_test, batch_size=args.test_batch_size,
                            seed=args.seed + 1, device=device, shuffle=False,
                            mesh=mesh)
    state = _state(args, model, mesh)
    n_params, n_layers = module_size(model)
    print(f"({n_params}, {n_layers})")

    sobel = SobelFilter(args.imsize, correct=True)
    train_step = make_reverse_kl_step(state, sobel, args.beta,
                                      args.weight_bound, n_out_pixels,
                                      physics=args.physics,
                                      fvcg_weight=args.fvcg_weight,
                                      fvcg_flux_weight=args.fvcg_flux_weight,
                                      fvcg_iters=args.fvcg_iters)
    eval_one = make_glow_eval_step(state, sobel, args.beta,
                                   args.weight_bound, n_out_pixels)
    eval_mean = make_glow_eval_step(state, sobel, args.beta,
                                    args.weight_bound, n_out_pixels,
                                    n_samples=20)

    logger = {"loss_train": [], "loss_test": [], "nrmse_test": [],
              "r2_test": [], "entropy_train": [], "entropy_test": []}
    start_epoch = 1
    warm_started = False
    if args.init_from and args.ckpt_epoch is None:
        # weights and BN stats only, a fresh optimizer and schedule: a
        # finished OneCycle run resumed into a longer schedule restarts at
        # a high lr on Adam moments from the cooled-down phase
        src, _, ep = args.init_from.partition(":")
        src_ckpt = os.path.join(src, "checkpoints")
        ep = int(ep) if ep else latest_epoch(src_ckpt)
        if ep is None:
            raise FileNotFoundError(f"no checkpoints in {src_ckpt}")
        restore_weights(src_ckpt, ep, model)
        warm_started = True
        print(f"Warm-started weights from {src_ckpt} epoch {ep}")
    if args.ckpt_epoch is not None:
        state, meta = restore_checkpoint(args.ckpt_dir, args.ckpt_epoch,
                                         state, with_meta=True)
        logger = meta.get("logger", logger)
        start_epoch = args.ckpt_epoch + 1
        print(f"Loaded checkpoint at epoch {args.ckpt_epoch}")

    if args.data_init and start_epoch == 1 and not warm_started:
        xb, yb = (torch.from_numpy(a[:args.batch_size]).to(device)
                  for a in (x_train, y_train))
        # the full first global batch on every rank, never a shard
        data_init_actnorm(state, yb, xb)
        print("Finished data initialization of Actnorm")
    if mesh is not None:
        replicate(model, mesh)

    def plot(epoch, x, y):
        """Mean, std and error, and 15 samples, of 6 random fields of the
        first test batch at the last epoch (2 before), 20 draws each."""
        n_show = 6 if epoch == args.epochs else 2
        model.eval()
        with torch.no_grad():
            for i in np.random.permutation(len(x))[:n_show]:
                samples = model.sample(x[[i]], 20, generator=make_generator(
                    device, 1234, int(i)), temperature=1.0)
                y_i = y[i].cpu().numpy()
                plot_prediction_bayes2(
                    args.pred_dir, y_i, samples.mean(0)[0].cpu().numpy(),
                    samples.var(0, unbiased=False)[0].cpu().numpy(), epoch,
                    int(i))
                save_samples(args.pred_dir, np.concatenate(
                    [y_i[None], samples[:15, 0].cpu().numpy()]), epoch,
                    int(i), "samples", nrow=4)
        model.train()

    def test(epoch):
        step_fn = eval_mean if epoch % 10 == 0 else eval_one
        losses, ents, rel, sse = [], [], [], []
        for i, (x, y) in enumerate(test_ds.batches(epoch)):
            out = step_fn(x, y, make_generator(device, args.seed + 7,
                                               epoch * 1000 + i))
            losses.append(out["loss"])
            ents.append(out["neg_entropy"])
            rel.append(out["rel_l2"])
            sse.append(out["sse"])
        # one host sync for the whole test set; the entropy is the mean
        # over the test batches; every rank's samples
        loss_test = float(all_mean(torch.stack(losses).mean(), mesh))
        ent = float(all_mean(torch.stack(ents).mean(), mesh))
        relative_l2 = all_gather(torch.cat(rel), mesh).mean(0).cpu().numpy()
        r2 = r2_score(all_gather(torch.cat(sse), mesh).sum(0),
                      y_variation).cpu().numpy()
        print(f"Epoch {epoch}: test r2-score: {r2}")
        print(f"Epoch {epoch}: test relative l2: {relative_l2}")
        if rank0 and not args.no_plot and (epoch % args.plot_freq == 0
                                           or epoch == args.epochs):
            plot(epoch, *next(iter(test_ds.batches(epoch))))
        if epoch % args.log_freq == 0:
            logger["loss_test"].append(loss_test)
            logger["r2_test"].append(r2.tolist())
            logger["nrmse_test"].append(relative_l2.tolist())
            logger["entropy_test"].append(-ent)

    jsonl = JsonlLogger(os.path.join(args.train_dir, "metrics.jsonl"))
    print("Start training..." + "." * 54)
    tic = time.time()
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.perf_counter()
        updates0 = state.updates
        metrics = [train_step(x) for (x,) in train_ds.batches(epoch)]
        losses = torch.stack([m["loss"] for m in metrics]).cpu()
        ents = torch.stack([m["neg_entropy"] for m in metrics]).cpu()
        epoch_s = time.perf_counter() - t0
        loss_train = float(losses.mean())
        neg_ent = float(ents[-1])
        skipped = len(metrics) - (state.updates - updates0)
        print(f"Epoch {epoch}: training loss: {loss_train:.6f}, "
              f"neg entropy {neg_ent:.6f}, lr {glow_lr(state):.6f}"
              + (f", {skipped} non-finite steps skipped" if skipped else ""))
        if epoch % args.log_freq == 0:
            logger["loss_train"].append(loss_train)
            logger["entropy_train"].append(-neg_ent)
            if rank0:
                jsonl.log({"epoch": epoch, "loss_train": loss_train,
                           "loss_first_step": losses[0],
                           "lr": glow_lr(state), "skipped_steps": skipped,
                           "samples_per_sec": len(metrics) * args.batch_size
                           / epoch_s, "epoch_seconds": epoch_s})
        # eval before checkpointing, as the codec CLIs do: the meta
        # sidecar then carries this epoch's test metrics, so a run resumed
        # from it logs the history of the uninterrupted run
        try:
            test(epoch)
        finally:
            if epoch % args.ckpt_freq == 0:
                save_checkpoint(args.ckpt_dir, epoch, state,
                                meta={"epoch": epoch, "logger": logger})
                args.ckpt_epoch = epoch
                if rank0:
                    save_args(args.run_dir, args)

    training_time = time.time() - tic
    print(f"Finished training {args.epochs} epochs with {args.ntrain} data "
          f"using {training_time / 60:.2f} mins")
    args.training_time = training_time
    args.n_params, args.n_layers = n_params, n_layers
    if rank0:
        save_stats(args.train_dir, logger, "loss_train", "loss_test",
                   "nrmse_test", "r2_test", "entropy_test", "entropy_train")
        save_args(args.run_dir, args)
    return state, logger


if __name__ == "__main__":
    main()

"""Shared machinery of the DenseED codec CLIs.

Counterpart of pde_surrogate_tpu/cli/_codec_common.py: dataset files
generated on demand (inputs on the host, labels by the device PCG solver),
the DenseED in f32 or bf16, with or without concats (``--dtype``,
``--concat-free``), Adam + OneCycle, an epoch loop of label-free physics
steps or supervised MSE steps (one epoch optionally under the profiler,
``--profile-epoch``), a test pass with rel-L2 / R^2 / flux-pressure
consistency and prediction figures, checkpoints with meta, warm starts
(``--init-from``), label-free checkpoint selection, the stats dump and the
LR-range test (``--find-lr``); the dataset files of the cGlow CLIs
(``resolve_dataset_files``) and of its UQ suite (``uq_dataset_files``).

``--n-devices N`` trains data-parallel on N ranks (``parallel.launch``):
rank 0 generates the dataset files while the others wait, every rank steps
on its shard of each global batch, the test pass gathers every rank's
per-sample errors, and rank 0 alone prints, logs, plots and saves.  The
LR-range test runs in one process, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from ..data.grf import sample_channelized, sample_kle, sample_warped_grf
from ..data.hdf5 import (Writer, dataset_path, dataset_shapes, load_data,
                         read_rows, save_args, save_dataset)
from ..data.pipeline import DeviceDataset
from ..models.codec import DenseED, module_size
from ..ops.filters import SobelFilter
from ..parallel.launch import run_driver
from ..parallel.mesh import (all_gather, all_mean, is_main, rank0_first,
                             replicate)
from ..train.checkpoint import (latest_epoch, restore_checkpoint,
                                restore_weights, save_checkpoint,
                                select_consistency_epoch)
from ..train.codec_trainer import (create_state, current_lr, make_eval_step,
                                   make_mixed_residual_step, make_mle_step)
from ..train.schedules import find_lr_schedule
from ..utils.config import select_device
from ..utils.metrics import r2_score
from ..utils.observability import JsonlLogger, StepTimer, profile_trace
from ..viz.plot import load_pyplot, plot_prediction_det, save_stats
from .make_dataset import solve_labels

__all__ = ["ensure_dataset", "resolve_dataset_files", "uq_dataset_files",
           "build_model", "run_codec", "run_codec_training", "run_find_lr"]

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _generate_inputs(data: str, n: int, imsize: int, kle: int, seed: int):
    if data.startswith("grf"):
        return sample_kle(n, imsize, kle, rng=seed)
    if data == "channelized":
        return sample_channelized(n, imsize, rng=seed)
    if data == "warped_grf":
        return sample_warped_grf(n, imsize, rng=seed)
    raise ValueError(f"unknown data family: {data}")


def ensure_dataset(path: str, data: str, n: int, imsize: int, kle: int,
                   seed: int, with_output: bool, solve_batch: int = 64,
                   device="cuda"):
    """Generate-and-cache a dataset file if absent.

    Labels come from the batched PCG solver on ``device``.  An existing
    file with enough samples but no labels gets them attached in place
    (read, solved and written slice by slice); any other mismatch raises:
    LHS designs are not prefix-stable, so a file is never regenerated at a
    new size.
    """
    if os.path.isfile(path):
        shapes = dataset_shapes(path)
        have_output = "output" in shapes
        have_n = shapes["input"][0]
        if have_n >= n and (have_output or not with_output):
            return
        if have_n >= n and with_output and not have_output:
            print(f"[data] attaching FV labels to existing {path} "
                  f"({have_n} samples, imsize {imsize})...")
            in_shape = shapes["input"]
            with Writer(path, {"input": in_shape,
                               "output": (have_n, 3) + in_shape[2:]}) as w:
                def read(i, j):
                    k = read_rows(path, "input", i, j)
                    w.write("input", i, k)
                    return k[:, 0]
                solve_labels(read, have_n, solve_batch, device,
                             lambda i, j, y: w.write("output", i, y))
            print(f"[data] labels attached to {path}")
            return
        need = "labels" if (with_output and not have_output) else f"{n} samples"
        raise FileExistsError(
            f"{path} exists with {have_n} samples"
            f"{' (no labels)' if not have_output else ''} but this run needs "
            f"{need}. Regenerating would REPLACE its contents with a "
            f"different LHS design. Delete the file to regenerate, or create "
            f"the full-size version explicitly with "
            f"`python -m pde_surrogate_torch.cli.make_dataset`.")
    print(f"[data] generating {path} ({n} samples, imsize {imsize})...")
    k = _generate_inputs(data, n, imsize, kle, seed)
    y = None
    if with_output:
        y = np.empty((n, 3, imsize, imsize), np.float32)
        solve_labels(lambda i, j: k[i:j], n, solve_batch, device,
                     lambda i, j, out: y.__setitem__(slice(i, j), out))
    save_dataset(path, k[:, None, :, :], y)
    print(f"[data] wrote {path}")


def resolve_dataset_files(args, need_train_output: bool = False):
    """Reference dataset paths per family, generated lazily at the size the
    run needs (inputs only for label-free training; val labels solved on
    ``args.device``)."""
    if args.data == "grf_kle512":
        kle = getattr(args, "kle", None) or 512
        train = dataset_path(args.data_dir, args.imsize,
                             f"kle{kle}_lhs10000_train")
        test = dataset_path(args.data_dir, args.imsize,
                            f"kle{kle}_lhs1000_val")
        ntrain_total, ntest_total = 10000, 1000
        family = "grf"
    elif args.data == "channelized":
        train = dataset_path(args.data_dir, args.imsize,
                             "channel_ng64_n4096_train")
        test = dataset_path(args.data_dir, args.imsize,
                            "channel_ng64_n512_test")
        ntrain_total, ntest_total = 4096, 512
        kle, family = 0, "channelized"
    elif args.data == "warped_grf":
        train = dataset_path(args.data_dir, args.imsize,
                             "warped_gp_ng64_n4096_train")
        test = dataset_path(args.data_dir, args.imsize,
                            "warped_gp_ng64_n512_test")
        ntrain_total, ntest_total = 4096, 512
        kle, family = 0, "warped_grf"
    else:
        raise ValueError(f"unknown data option: {args.data}")
    if args.ntrain > ntrain_total or args.ntest > ntest_total:
        raise ValueError(f"{args.data} holds at most {ntrain_total} train and "
                         f"{ntest_total} test samples")
    ensure_dataset(train, family, max(args.ntrain, 1), args.imsize, kle,
                   seed=10_000 + kle, with_output=need_train_output,
                   device=args.device)
    ensure_dataset(test, family, max(args.ntest, 1), args.imsize, kle,
                   seed=20_000 + kle, with_output=True, device=args.device)
    return train, test


def uq_dataset_files(run_args, n_mc: int, ntest: int, device="cuda"):
    """Monte-Carlo and labelled val files of the UQ suite (post_cglow),
    family-aware like ``resolve_dataset_files``; the MC design has its own
    seed stream (40_000 + kle).  ``run_args`` is a trained run's args.txt
    namespace (runs without ``data`` are GRF).  Labels are solved on
    ``device``."""
    data = getattr(run_args, "data", "grf_kle512")
    d, n = run_args.data_dir, run_args.imsize
    if data == "grf_kle512":
        kle = getattr(run_args, "kle", None) or 512
        mc = dataset_path(d, n, f"kle{kle}_lhs10000_monte_carlo")
        test = dataset_path(d, n, f"kle{kle}_lhs1000_val")
        family = "grf"
    elif data == "channelized":
        mc = dataset_path(d, n, "channel_ng64_n10000_mc")
        test = dataset_path(d, n, "channel_ng64_n512_test")
        kle, family = 0, "channelized"
    elif data == "warped_grf":
        mc = dataset_path(d, n, "warped_gp_ng64_n10000_mc")
        test = dataset_path(d, n, "warped_gp_ng64_n512_test")
        kle, family = 0, "warped_grf"
    else:
        raise ValueError(f"unknown data option: {data}")
    ensure_dataset(mc, family, n_mc, n, kle, seed=40_000 + kle,
                   with_output=True, device=device)
    ensure_dataset(test, family, ntest, n, kle, seed=20_000 + kle,
                   with_output=True, device=device)
    return mc, test


def build_model(args, device) -> DenseED:
    """The DenseED of a run (training args or a run dir's args.txt; runs
    recorded without ``dtype`` / ``concat_free`` are f32 with concats)."""
    return DenseED(in_channels=1, out_channels=3, imsize=args.imsize,
                   blocks=args.blocks, growth_rate=args.growth_rate,
                   init_features=args.init_features,
                   drop_rate=args.drop_rate, upsample=args.upsample,
                   dtype=DTYPES[getattr(args, "dtype", "f32")],
                   concat_free=getattr(args, "concat_free", False)
                   ).to(device)


def _physics_kwargs(args) -> dict:
    """The label-free objective of a run (the MLE driver has no --physics:
    its test loss is the Sobel mixed residual)."""
    return dict(physics=getattr(args, "physics", "sobel"),
                fvcg_weight=getattr(args, "fvcg_weight", 100.0),
                fvcg_flux_weight=getattr(args, "fvcg_flux_weight", 0.0),
                fvcg_iters=getattr(args, "fvcg_iters", None))


def _train_data(args, loss_kind: str, device, mesh=None):
    """``(train DeviceDataset, test file)``: the training split holds K only
    for label-free training and (K, labels) for MLE, whose train file gets
    its labels from the PCG solver when it has none (on rank 0 of a mesh,
    the others waiting)."""
    mle = loss_kind == "mle"
    with rank0_first(mesh):
        train_file, test_file = resolve_dataset_files(args,
                                                      need_train_output=mle)
    x_train, y_train, _ = load_data(train_file, args.ntrain, only_input=not mle)
    arrays = (x_train,) if y_train is None else (x_train, y_train)
    return DeviceDataset(*arrays, batch_size=args.batch_size, seed=args.seed,
                         device=device, mesh=mesh), test_file


def _state_kw(args) -> dict:
    """The optimizer and OneCycle settings of a training run."""
    return dict(lr_max=args.lr,
                total_steps=args.epochs * (args.ntrain // args.batch_size),
                div_factor=args.lr_div, pct_start=args.lr_pct,
                weight_decay=args.weight_decay)


def _train_step(state, loss_kind: str, sobel, args, physics_kw: dict):
    if loss_kind == "mle":
        return make_mle_step(state, dropout_seed=args.seed)
    if loss_kind == "mixed_residual":
        return make_mixed_residual_step(state, sobel, args.weight_bound,
                                        **physics_kw, dropout_seed=args.seed)
    raise ValueError(f"unknown loss_kind: {loss_kind!r}")


def _warm_start(model, init_from: str) -> None:
    """--init-from 'dir[:epoch]': the weights and BN running stats of that
    run's checkpoint (default: its latest).  The codec is fully
    convolutional, so a run at another imsize initialises this one."""
    src, _, ep = init_from.partition(":")
    src_ckpt = os.path.join(src, "checkpoints")
    ep = int(ep) if ep else latest_epoch(src_ckpt)
    if ep is None:
        raise FileNotFoundError(f"no checkpoints in {src_ckpt}")
    restore_weights(src_ckpt, ep, model)
    print(f"Warm-started weights from {src_ckpt} epoch {ep}")


def run_codec(args, loss_kind: str):
    """A codec CLI's work after parsing: the LR-range test, training in
    this process, or (``--n-devices``) data-parallel training, which
    returns rank 0's ``(state, logger)``."""
    if args.find_lr:
        return run_find_lr(args, loss_kind)
    if args.n_devices is None:
        return run_codec_training(args, loss_kind)
    return run_driver(functools.partial(run_codec_training,
                                        loss_kind=loss_kind), args,
                      _read_back)


def _read_back(args, ckpt_dir: str):
    """``(state, logger)`` of a data-parallel run from the checkpoint rank
    0 saved at its end (epoch 0 of ``ckpt_dir``)."""
    device = select_device(args.device)
    state = create_state(build_model(args, device), **_state_kw(args))
    state, meta = restore_checkpoint(ckpt_dir, 0, state, with_meta=True)
    return state, meta["logger"]


def run_codec_training(args, loss_kind: str, mesh=None):
    """The epoch loop of both codec CLIs; ``loss_kind`` 'mixed_residual'
    (label-free, ``args.physics``) or 'mle' (MSE against solver labels);
    ``mesh``: this rank's data mesh.  Returns ``(state, logger)``."""
    device = mesh.device if mesh is not None else select_device(args.device)
    rank0 = is_main(mesh)
    args.train_dir = os.path.join(args.run_dir, "training")
    args.pred_dir = os.path.join(args.train_dir, "predictions")
    os.makedirs(args.pred_dir, exist_ok=True)

    model = build_model(args, device)
    train_ds, test_file = _train_data(args, loss_kind, device, mesh)
    x_test, y_test, stats = load_data(test_file, args.ntest, only_input=False,
                                      return_stats=True)
    print(f"Test output variation per channel: {stats['y_variation']}")
    y_variation = torch.as_tensor(stats["y_variation"], device=device)
    test_ds = DeviceDataset(x_test, y_test, batch_size=args.test_batch_size,
                            seed=args.seed + 1, device=device, shuffle=False,
                            mesh=mesh)

    state_kw = _state_kw(args)
    print(f"total steps: {state_kw['total_steps']}")
    state = create_state(model, **state_kw, mesh=mesh)
    n_params, n_layers = module_size(model)
    print(f"# params {n_params}, # conv layers {n_layers}")

    sobel = SobelFilter(args.imsize, correct=True,
                        filter_size=getattr(args, "sobel_size", 3))
    physics_kw = _physics_kwargs(args)
    train_step = _train_step(state, loss_kind, sobel, args, physics_kw)

    start_epoch = 1
    restored_meta: dict = {}
    init_from = getattr(args, "init_from", None)
    if init_from and args.ckpt_epoch is not None:
        print(f"--init-from {init_from} not applied: resuming this run "
              f"from --ckpt-epoch {args.ckpt_epoch}")
    elif init_from:
        # weights and BN stats only; the optimizer and schedule stay fresh
        _warm_start(model, init_from)
    if args.ckpt_epoch is not None:
        state, restored_meta = restore_checkpoint(args.ckpt_dir,
                                                  args.ckpt_epoch, state,
                                                  with_meta=True)
        start_epoch = args.ckpt_epoch + 1
        print(f"Loaded ckpt at epoch {args.ckpt_epoch}; resume "
              f"from {start_epoch} to {args.epochs}")
    if mesh is not None:
        replicate(model, mesh)

    # resume continues the saved history, so the stats curves and the
    # label-free checkpoint selection see pre-resume epochs too
    logger = restored_meta.get("logger") or {
        "loss_train": [], "loss_test": [], "r2_test": [],
        "nrmse_test": [], "consistency_test": []}
    ckpt_consistency: list[tuple[int, float]] = [
        tuple(t) for t in restored_meta.get("ckpt_consistency", [])]

    def test(epoch, st, record=True):
        eval_step = make_eval_step(st, sobel, args.weight_bound, **physics_kw)
        want_plot = (record and rank0 and not args.no_plot
                     and (epoch % args.plot_freq == 0 or epoch == args.epochs))
        losses, rel, sse, cons = [], [], [], []
        for x, y in test_ds.batches(epoch):
            out = eval_step(x, y)
            losses.append(out["loss"])
            rel.append(out["rel_l2"])
            sse.append(out["sse"])
            cons.append(out["consistency"])
            plot_batch = (y, out["output"])
        # one host sync for the whole test set; every rank's samples
        loss_test = float(all_mean(torch.stack(losses).mean(), mesh))
        relative_l2 = all_gather(torch.cat(rel), mesh).mean(0).cpu().numpy()
        r2 = r2_score(all_gather(torch.cat(sse), mesh).sum(0),
                      y_variation).cpu().numpy()
        consistency = float(all_mean(torch.stack(cons).mean(), mesh))
        if record and epoch % args.ckpt_freq == 0:
            ckpt_consistency.append((epoch, consistency))
        print(f"Epoch {epoch}: test r2-score: {r2}")
        print(f"Epoch {epoch}: test relative-l2: {relative_l2}")
        print(f"Epoch {epoch}: flux-pressure consistency: {consistency:.4f}")
        if want_plot:
            # the last test batch; 6 random fields at the last epoch, else 2
            y_np, out_np = (t.cpu().numpy() for t in plot_batch)
            n_samples = 6 if epoch == args.epochs else 2
            for i in np.random.permutation(len(y_np))[:n_samples]:
                plot_prediction_det(args.pred_dir, y_np[i], out_np[i], epoch,
                                    int(i), plot_fn=args.plot_fn)
        if record and epoch % args.log_freq == 0:
            logger["loss_test"].append(loss_test)
            logger["r2_test"].append(r2.tolist())
            logger["nrmse_test"].append(relative_l2.tolist())
            logger["consistency_test"].append(consistency)

    timer = StepTimer(args.batch_size)
    jsonl = JsonlLogger(os.path.join(args.train_dir, "metrics.jsonl"))
    print("Start training..." + "." * 47)
    tic = time.time()
    for epoch in range(start_epoch, args.epochs + 1):
        timer.start()
        with profile_trace(os.path.join(args.train_dir, "profile"),
                           enabled=rank0 and epoch == args.profile_epoch,
                           device=device):
            losses = torch.stack([train_step(*batch)["loss"]
                                  for batch in train_ds.batches(epoch)])
            timer.step(len(train_ds))
        rate = timer.result(fence=losses)
        losses = losses.cpu()  # the epoch's one host sync
        loss_train = float(losses.mean())
        print(f"Epoch {epoch}, lr {current_lr(state):.6f}, "
              f"{rate['samples_per_sec']:.0f} samples/sec")
        print(f"Epoch {epoch}: training loss: {loss_train:.6f}")
        if epoch % args.log_freq == 0:
            logger["loss_train"].append(loss_train)
            if rank0:
                jsonl.log({"epoch": epoch, "loss_train": loss_train,
                           "loss_first_step": losses[0],
                           "lr": current_lr(state),
                           "samples_per_sec": rate["samples_per_sec"],
                           "epoch_seconds": rate["seconds"]})
        # eval before checkpointing, so the meta sidecar carries this
        # epoch's consistency record; save even if eval raises
        try:
            test(epoch, state)
        finally:
            if epoch % args.ckpt_freq == 0:
                save_checkpoint(args.ckpt_dir, epoch, state,
                                meta={"epoch": epoch, "logger": logger,
                                      "ckpt_consistency": ckpt_consistency})

    training_time = time.time() - tic
    print(f"Finished training {args.epochs} epochs with {args.ntrain} data "
          f"using {training_time / 60:.2f} mins")
    selected = select_consistency_epoch(ckpt_consistency)
    if selected is not None:
        # label-free checkpoint selection: long schedules can freeze u in a
        # drifted state that the flux-pressure consistency detects
        sel_epoch, sel_cons = selected
        print(f"Label-free checkpoint selection (min flux-pressure "
              f"consistency): epoch {sel_epoch} ({sel_cons:.4f})")
        if sel_epoch != args.epochs:
            sel_state = create_state(build_model(args, device), **state_kw,
                                     mesh=mesh)
            restore_checkpoint(args.ckpt_dir, sel_epoch, sel_state)
            print(f"Metrics at the selected checkpoint (epoch {sel_epoch}):")
            test(sel_epoch, sel_state, record=False)
    args.training_time = training_time
    args.n_params, args.n_layers = n_params, n_layers
    if rank0:
        save_stats(args.train_dir, logger, "loss_train", "loss_test",
                   "nrmse_test", "r2_test", "consistency_test")
        save_args(args.run_dir, args)
    return state, logger


def run_find_lr(args, loss_kind: str, init_value: float = 1e-8,
                final_value: float = 10.0, beta: float = 0.98):
    """LR-range test (reference utils/practices.py:45-83), the --find-lr
    hook: one epoch with the lr growing exponentially from ``init_value``
    to ``final_value``, the loss smoothed with ``beta``, stopped when the
    smoothed loss passes 4x the best.  Writes ``find_lr.txt`` (log10_lr,
    smoothed_loss) into the run dir and returns ``(log_lrs, losses)``.

    As in the JAX package the label-free test runs the Sobel mixed
    residual whatever ``--physics`` says.  ``find_lr.pdf`` plots the curve.
    """
    device = select_device(args.device)
    model = build_model(args, device)
    train_ds, _ = _train_data(args, loss_kind, device)
    num = max(len(train_ds) - 1, 1)
    state = create_state(model, lr_max=args.lr, total_steps=num,
                         schedule=find_lr_schedule(init_value, final_value,
                                                   num),
                         weight_decay=args.weight_decay)
    sobel = SobelFilter(args.imsize, correct=True,
                        filter_size=getattr(args, "sobel_size", 3))
    step = _train_step(state, loss_kind, sobel, args, {})
    if getattr(args, "physics", "sobel") != "sobel":
        print(f"[find_lr] the range test runs the Sobel mixed residual; "
              f"--physics {args.physics} applies to training only")

    mult = (final_value / init_value) ** (1.0 / num)
    avg_loss, best_loss = 0.0, 0.0
    log_lrs, losses = [], []
    # fetch the losses 8 steps at a time; the divergence stop then acts at
    # that granularity, which only trims the curve's tail
    chunk = 8
    pending: list[tuple[int, float, torch.Tensor]] = []
    stop = False

    def flush():
        nonlocal avg_loss, best_loss, stop
        vals = torch.stack([m for _, _, m in pending]).cpu().numpy()
        for (bnum, lr, _), val in zip(pending, vals):
            avg_loss = beta * avg_loss + (1 - beta) * float(val)
            smoothed = avg_loss / (1 - beta ** bnum)
            if bnum > 1 and smoothed > 4 * best_loss:
                print(f"[find_lr] diverged at lr {lr:.3e} (step {bnum})")
                stop = True
                break
            if smoothed < best_loss or bnum == 1:
                best_loss = smoothed
            log_lrs.append(np.log10(lr))
            losses.append(smoothed)
        pending.clear()

    for batch_num, batch in enumerate(train_ds.batches(1), start=1):
        lr = init_value * mult ** (batch_num - 1)
        pending.append((batch_num, lr, step(*batch)["loss"]))
        if len(pending) >= chunk:
            flush()
            if stop:
                break
    if pending and not stop:
        flush()
    print(f"[find_lr] best smoothed loss {best_loss:.4f}; "
          f"suggested lr ~ 10^{log_lrs[int(np.argmin(losses))]:.2f} / 10")
    np.savetxt(os.path.join(args.run_dir, "find_lr.txt"),
               np.stack([log_lrs, losses], axis=1),
               header="log10_lr smoothed_loss")
    plt = load_pyplot("find_lr.pdf")
    if plt is not None:
        sl = slice(10, -5) if len(log_lrs) > 20 else slice(None)
        plt.figure()
        plt.plot(np.asarray(log_lrs)[sl], np.asarray(losses)[sl])
        plt.xlabel("log10(lr)")
        plt.ylabel("smoothed loss")
        plt.savefig(os.path.join(args.run_dir, "find_lr.pdf"))
        plt.close()
    return log_lrs, losses

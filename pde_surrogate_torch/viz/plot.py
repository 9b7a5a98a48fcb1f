"""The figures of the reference's utils/plot.py.

Counterpart of pde_surrogate_tpu/viz/plot.py, function for function and
with the same file names: one ``panel_grid`` helper renders the panel grid
that the reference repeats (rows of fields, per-column color ranges shared
by the first two rows, free scales for error and std rows, scalar-formatter
colorbars), and each public function is a thin wrapper with the reference's
rows.  Fields may be numpy arrays or CPU tensors, CHW or HWC.

matplotlib (Agg backend, no display) and PIL are imported when a figure is
drawn.  Where one is not installed, the figure is skipped with one printed
note that names the package and the figure; ``save_stats`` still writes its
``.txt`` files.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_pyplot", "plot_prediction_det", "plot_prediction_det_animate",
           "plot_prediction_bayes2", "plot_MC2", "plot_UP", "save_stats",
           "save_samples", "plot_row", "panel_grid", "imagegrid_pairs",
           "plot_prediction_bayes", "plot_MC", "assemble_gif"]

EXT = "png"
DPI = None

COLS = ["Pressure", "Horizontal Flux", "Vertical Flux"]


def load_pyplot(figure: str):
    """matplotlib.pyplot on the Agg backend, or None after one printed note
    naming ``figure`` where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"[note] matplotlib is not installed: {figure} not drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _to_numpy(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _chw(a):
    """Accept (C, H, W) or (H, W, C) fields; return (C, H, W)."""
    a = _to_numpy(a)
    if a.ndim == 3 and a.shape[-1] in (1, 2, 3) and a.shape[0] not in (1, 2, 3):
        a = np.moveaxis(a, -1, 0)
    return a


def _colorbar(plt, cax, ax):
    import matplotlib.ticker as ticker
    cbar = plt.colorbar(cax, ax=ax, fraction=0.046, pad=0.04,
                        format=ticker.ScalarFormatter(useMathText=True))
    cbar.formatter.set_powerlimits((-2, 2))
    cbar.ax.yaxis.set_offset_position("left")
    cbar.update_ticks()


def panel_grid(samples, rows, cols, path, plot_fn="imshow", cmap="jet",
               same_scale=False, shared_rows=2):
    """Render an (nrows, nfields, H, W) stack of panels.

    Columns of the first ``shared_rows`` rows share a color range; later
    rows (errors, stds) are free unless ``same_scale``.
    """
    plt = load_pyplot(os.path.basename(path))
    if plt is None:
        return
    samples = _to_numpy(samples)
    nrows, nfields = samples.shape[:2]
    vmin = [samples[:shared_rows, j].min() for j in range(nfields)]
    vmax = [samples[:shared_rows, j].max() for j in range(nfields)]
    fig, axes = plt.subplots(nrows, nfields,
                             figsize=(3.75 * nfields, 3 * nrows),
                             squeeze=False)
    for i in range(nrows):
        for j in range(nfields):
            ax = axes[i, j]
            ax.set_aspect("equal")
            ax.set_xticks([])
            ax.set_yticks([])
            shared = i < shared_rows
            lim = (dict(vmin=vmin[j], vmax=vmax[j])
                   if shared or same_scale else {})
            if plot_fn == "contourf":
                cax = ax.contourf(samples[i, j], 50, cmap=cmap, **lim)
            else:
                cax = ax.imshow(samples[i, j], cmap=cmap, origin="upper",
                                interpolation=None, **lim)
            _colorbar(plt, cax, ax)
    for ax, col in zip(axes[0], cols):
        ax.set_title(col, size="large")
    for ax, row in zip(axes[:, 0], rows):
        ax.set_ylabel(row, rotation=90, size="large")
    plt.tight_layout(pad=0.05, w_pad=0.05, h_pad=0.05)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plt.savefig(path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_prediction_det(save_dir, target, prediction, epoch, index,
                        plot_fn="imshow", cmap="jet", same_scale=False,
                        row_labels=None, col_labels=None):
    """(target, prediction, target - prediction) panels (utils/plot.py:17-94)."""
    target, prediction = _chw(target), _chw(prediction)
    rows = row_labels or ["Simulation", "Prediction",
                          r"Simulation $-$ Prediction"]
    samples = np.stack([target, prediction, target - prediction], axis=0)
    panel_grid(samples, rows, col_labels or COLS,
               os.path.join(save_dir, f"pred_epoch{epoch}_{index}.{EXT}"),
               plot_fn, cmap, same_scale)


def plot_prediction_det_animate(save_dir, target, prediction, epoch, index,
                                i_plot, plot_fn="imshow", cmap="jet",
                                same_scale=False):
    """Animation-frame variant with |error| row (utils/plot.py:97-178)."""
    target, prediction = _chw(target), _chw(prediction)
    samples = np.stack([target, prediction, np.abs(target - prediction)], 0)
    panel_grid(samples, ["Simulation", "Prediction", "Abs Error"], COLS,
               os.path.join(save_dir, f"pred_{i_plot}.{EXT}"),
               plot_fn, cmap, same_scale)


def plot_prediction_bayes2(save_dir, target, pred_mean, pred_var, epoch,
                           index, plot_fn="imshow", cmap="jet",
                           same_scale=False):
    """(target, mean, std, target - mean) panels (utils/plot.py:181-258)."""
    target, pred_mean = _chw(target), _chw(pred_mean)
    pred_std = np.sqrt(_chw(pred_var))
    samples = np.stack([target, pred_mean, pred_std, target - pred_mean], 0)
    panel_grid(samples, ["Simulation", "Pred Mean", "Pred Std",
                         r"Sim $-$ Pred Mean"], COLS,
               os.path.join(save_dir, f"pred_epoch{epoch}_{index}.{EXT}"),
               plot_fn, cmap, same_scale)


def imagegrid_pairs(top_pairs, bottom_pairs, path, plot_fn="contourf",
                    cmap="jet", figsize=(11, 12)):
    """The reference's ImageGrid layout (utils/plot.py:276-374, 377-474).

    A 2x3 outer grid of vertical (2,1) ImageGrids: the top three cells show
    ``top_pairs[i]`` = (a, b) per channel with ONE shared colorbar per cell;
    the bottom three show ``bottom_pairs[i]`` with a free colorbar per axis.
    """
    plt = load_pyplot(os.path.basename(path))
    if plt is None:
        return
    import matplotlib.ticker as ticker
    from mpl_toolkits.axes_grid1 import ImageGrid

    sfmt = ticker.ScalarFormatter(useMathText=True)
    sfmt.set_powerlimits((-2, 2))
    fig = plt.figure(1, figsize)
    for i, cell in enumerate(range(231, 237)):
        shared = i < 3
        data = top_pairs[i] if shared else bottom_pairs[i - 3]
        grid = ImageGrid(fig, cell, nrows_ncols=(2, 1), axes_pad=0.25,
                         share_all=False, cbar_location="right",
                         cbar_mode="single" if shared else "each",
                         cbar_size="3%" if shared else "6%", cbar_pad=0.1)
        lim = {}
        if shared:
            stacked = np.concatenate([np.asarray(d) for d in data])
            lim = dict(vmin=stacked.min(), vmax=stacked.max())
        for j, ax in enumerate(grid):
            if plot_fn == "contourf":
                im = ax.contourf(data[j], 50, cmap=cmap, **lim)
                im.set_edgecolor("face")
            else:
                im = ax.imshow(data[j], interpolation=None, cmap=cmap, **lim)
            ax.set_axis_off()
            if not shared:
                cbar = grid.cbar_axes[j].colorbar(im, format=sfmt)
                cbar.ax.tick_params(labelsize=6)
                cbar.ax.yaxis.set_offset_position("left")
        if shared:
            cbar = grid.cbar_axes[0].colorbar(im, format=sfmt)
            cbar.ax.tick_params(labelsize=6)
            cbar.ax.yaxis.set_offset_position("left")
    fig.subplots_adjust(wspace=0.075, hspace=0.075)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)


def plot_prediction_bayes(save_dir, target, pred_mean, pred_var, epoch,
                          index, plot_fn="contourf"):
    """ImageGrid Bayes panels (utils/plot.py:276-374): per channel a
    (target, mean) pair sharing one scale plus (error, 2 std) free-scale."""
    target, pm = _chw(target), _chw(pred_mean)
    two_sigma = 2 * np.sqrt(_chw(pred_var))
    err = target - pm
    imagegrid_pairs([(target[c], pm[c]) for c in range(target.shape[0])],
                    [(err[c], two_sigma[c]) for c in range(err.shape[0])],
                    os.path.join(save_dir,
                                 f"pred_at_x_epoch{epoch}_{index}.{EXT}"),
                    plot_fn)


def plot_MC(save_dir, monte_carlo, pred_mean, pred_var, mean, n_train,
            plot_fn="contourf"):
    """ImageGrid MC-vs-surrogate panels (utils/plot.py:377-474): per channel
    (MC, pred mean) sharing one scale, (error, 2 std) free-scale."""
    mc, pm = _chw(monte_carlo), _chw(pred_mean)
    two_sigma = 2 * np.sqrt(_chw(pred_var))
    err = mc - pm
    imagegrid_pairs([(mc[c], pm[c]) for c in range(mc.shape[0])],
                    [(err[c], two_sigma[c]) for c in range(err.shape[0])],
                    os.path.join(
                        save_dir,
                        f"pred_{'mean' if mean else 'var'}_vs_MC.pdf"),
                    plot_fn, figsize=(10, 10))
    print(f"Done plotting Pred_{'mean' if mean else 'var'}_vs_MC, "
          f"num of training: {n_train}")


def plot_MC2(save_dir, monte_carlo, pred_mean, pred_var, mean, ntrain,
             plot_fn="imshow", cmap="jet", manual_scale=False,
             same_scale=False):
    """Monte-Carlo vs surrogate statistics panels (utils/plot.py:475-561)."""
    target, pm = _chw(monte_carlo), _chw(pred_mean)
    ps = np.sqrt(_chw(pred_var))
    which = "Mean" if mean else "Variance"
    rows = ["Monte Carlo", f"Mean of Est. {which}", f"2 Std of Est. {which}",
            "Row1 - Row2"]
    samples = np.stack([target, pm, ps * 2, target - pm], 0)
    # manual_scale = the reference's fixed-color-range mode; realized here
    # as per-column shared scales (same_scale), its closest analog
    panel_grid(samples, rows, COLS,
               os.path.join(save_dir,
                            f"pred_{'mean' if mean else 'var'}_vs_MC.pdf"),
               plot_fn, cmap, same_scale or manual_scale)
    print(f"Done plotting Pred_{'mean' if mean else 'var'}_vs_MC, "
          f"num of training: {ntrain}")


def plot_UP(save_dir, monte_carlo, surr_mean, is_mean, plot_fn="imshow",
            cmap="jet", same_scale=False):
    """Uncertainty-propagation panels (utils/plot.py:567-641)."""
    target, pred = _chw(monte_carlo), _chw(surr_mean)
    samples = np.stack([target, pred, target - pred], 0)
    panel_grid(samples, ["Simulator", "Surrogate", r"Row1 $-$ Row2"], COLS,
               os.path.join(save_dir,
                            f"pred_{'mean' if is_mean else 'var'}_vs_MC.pdf"),
               plot_fn, cmap, same_scale)


def save_stats(save_dir, logger, *metrics):
    """Dump metric curves as {metric}.txt + {metric}.pdf (utils/plot.py:261-273);
    without matplotlib the .txt files only."""
    os.makedirs(save_dir, exist_ok=True)
    for metric in metrics:
        np.savetxt(os.path.join(save_dir, f"{metric}.txt"),
                   np.asarray(logger[metric]))
    plt = load_pyplot(f"the {', '.join(metrics)} curves (.pdf)")
    if plt is None:
        return
    for metric in metrics:
        arr = np.asarray(logger[metric])
        if arr.ndim == 1:
            arr = arr[:, None]
        if len(arr) == 0:
            continue
        lines = plt.plot(range(1, len(arr) + 1), arr)
        labels = [f"{arr[-5:, i].mean():.4f}" for i in range(arr.shape[-1])]
        plt.legend(lines, labels)
        plt.savefig(os.path.join(save_dir, f"{metric}.pdf"))
        plt.close()


def save_samples(save_dir, images, epoch, index, name, nrow=4, heatmap=True,
                 cmap="jet", title=False):
    """Per-channel sample grids (utils/plot.py:644-689).

    ``images``: (B, C, H, W) or (B, H, W, C).  The reference's non-heatmap
    branch calls torchvision without importing it (utils/plot.py:686, broken);
    here the fallback renders a plain grid.
    """
    plt = load_pyplot(f"epoch{epoch}_{name}_c*_index{index}.png")
    if plt is None:
        return
    images = np.stack([_chw(im) for im in _to_numpy(images)])
    ncol = max(images.shape[0] // nrow, 1)
    # clamp: fewer images than grid cells (e.g. post_cglow --n-samples 2)
    n_show = min(nrow * ncol, images.shape[0])
    for c in range(images.shape[1]):
        fig, axes = plt.subplots(nrow, ncol, figsize=(12, 12), squeeze=False)
        vmin, vmax = images[:n_show, c].min(), images[:n_show, c].max()
        im = None
        for j in range(n_show):
            ax = axes[j // ncol, j % ncol]
            im = ax.imshow(images[j, c], cmap=cmap if heatmap else "gray",
                           vmin=vmin, vmax=vmax)
            ax.set_axis_off()
            ax.set_aspect("equal")
        for j in range(n_show, nrow * ncol):
            axes[j // ncol, j % ncol].set_axis_off()
        fig.colorbar(im, ax=axes, fraction=0.02)
        if title:
            plt.suptitle(f"Epoch {epoch}")
        os.makedirs(save_dir, exist_ok=True)
        plt.savefig(os.path.join(
            save_dir, f"epoch{epoch}_{name}_c{c}_index{index}.png"),
            bbox_inches="tight")
        plt.close(fig)


def assemble_gif(frame_dir, out_path=None, pattern="pred_*.png",
                 duration_ms=250, loop=0):
    """Assemble animate frames into a gif (the reference ships
    assets/cglow_pred_at_x.gif but has no assembler; frames come from
    plot_prediction_det_animate / utils/plot.py:97-178).

    Frames matching ``pattern`` under ``frame_dir`` are ordered by the
    integer suffix in their filename (pred_3.png < pred_12.png).  Returns
    the gif path, or None if fewer than 2 frames exist (or PIL is not
    installed).
    """
    import glob
    import re

    try:
        from PIL import Image
    except ImportError:
        print(f"[note] PIL is not installed: "
              f"{out_path or 'animation.gif'} not written")
        return None

    def frame_key(path):
        nums = re.findall(r"\d+", os.path.basename(path))
        return [int(n) for n in nums] if nums else [0]

    # escape the dir: run dirs contain glob metacharacters ("blocks[2, 2]")
    frames = sorted(glob.glob(os.path.join(glob.escape(frame_dir), pattern)),
                    key=frame_key)
    if len(frames) < 2:
        return None
    out_path = out_path or os.path.join(frame_dir, "animation.gif")
    images = [Image.open(f).convert("P", palette=Image.ADAPTIVE)
              for f in frames]
    images[0].save(out_path, save_all=True, append_images=images[1:],
                   duration=duration_ms, loop=loop)
    return out_path


def plot_row(arrs, save_dir, filename, same_range=False, plot_fn="imshow",
             cmap="viridis"):
    """Row of fields with colorbars (utils/plot.py:692-731)."""
    plt = load_pyplot(f"{filename}.{EXT}")
    if plt is None:
        return
    arrs = [_to_numpy(a) for a in arrs]
    vmax = max(a.max() for a in arrs) if same_range else None
    vmin = min(a.min() for a in arrs) if same_range else None
    fig, _ = plt.subplots(1, len(arrs), figsize=(4.4 * len(arrs), 4))
    for i, ax in enumerate(fig.axes):
        if plot_fn == "contourf":
            cax = ax.contourf(arrs[i], 50, cmap=cmap, vmin=vmin, vmax=vmax)
        else:
            cax = ax.imshow(arrs[i], cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_axis_off()
        _colorbar(plt, cax, ax)
    plt.tight_layout(pad=0.05, w_pad=0.05, h_pad=0.05)
    os.makedirs(save_dir, exist_ok=True)
    plt.savefig(os.path.join(save_dir, f"{filename}.{EXT}"), dpi=DPI,
                bbox_inches="tight")
    plt.close(fig)

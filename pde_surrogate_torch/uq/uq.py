"""Uncertainty quantification for the conditional-Glow surrogate.

Counterpart of pde_surrogate_tpu/uq/uq.py: ``GlowSurrogate`` (sample,
predict, propagate) over a trained model, and ``UQCondGlow`` with the five
tasks of the reference's UQ suite — prediction at an input, uncertainty
propagation, distribution estimates at LHS-chosen pixels, the reliability
diagram and the NaN-robust test metric.  Arrays are NCHW.

Each task draws the reference's figures (``viz/plot.py``; where
matplotlib is missing, a note says so) and writes the numbers they show
(``.npy``, ``.npz``, ``.txt``, ``out_stats.mat``).  Noise comes from
generators seeded by (seed, task tag, index), the JAX package's
``fold_in`` counters.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.stats import norm as scipy_norm

from ..ops.lhs import lhs
from ..utils.config import make_generator
from ..utils.observability import count, span
from ..viz.plot import (load_pyplot, plot_MC2, plot_prediction_bayes2,
                        plot_row, save_samples)

__all__ = ["GlowSurrogate", "UQCondGlow"]


class GlowSurrogate:
    """Sample / predict / propagate over a trained model in eval mode."""

    def __init__(self, model, n_samples: int = 20, temperature: float = 1.0):
        self.model = model
        self.n_samples = n_samples
        self.temperature = temperature

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def sample(self, x, generator: torch.Generator | None = None,
               eps_list=None) -> torch.Tensor:
        """(n_samples, B, C, H, W) samples for inputs (B, C, H, W)."""
        self.model.eval()
        if not (torch.is_tensor(x) and x.device == self.device):
            count("sync.sample_input")      # a host copy waits on a card
        x = torch.as_tensor(x, device=self.device)
        return self.model.sample(x, self.n_samples, generator=generator,
                                 eps_list=eps_list,
                                 temperature=self.temperature)

    def predict(self, x, generator: torch.Generator | None = None,
                eps_list=None):
        """(mean, var) over ``n_samples`` samples (population variance)."""
        s = self.sample(x, generator, eps_list)
        return s.mean(dim=0), s.var(dim=0, unbiased=False)

    def propagate(self, mc_x, seed: int, var_samples: int = 10,
                  batch_size: int = 64):
        """Uncertainty propagation (JAX uq.py:83-113).

        E[Y] = E_X E[Y|X] and Var[Y] = E[Y^2] - E[Y]^2 over the Monte-Carlo
        inputs, repeated ``var_samples`` times to estimate the estimator's
        own spread.  Returns (EE, VE, EV, VV) fields (C, H, W).  ``mc_x``
        (N, C, H, W) is cut into chunks of the largest divisor of N up to
        ``batch_size`` (all N used; only when N has no divisor near
        ``batch_size`` the remainder is dropped, with a line saying so).
        """
        with span("uq.propagate"):
            x = torch.as_tensor(mc_x)
            n = len(x)
            b = max(d for d in range(1, min(batch_size, n) + 1)
                    if n % d == 0)
            if b < max(batch_size // 2, 1):
                b = min(batch_size, n)
                n_use = (n // b) * b
                print(f"[propagate] N={n} has no divisor near {batch_size}; "
                      f"using first {n_use} MC samples")
                x, n = x[:n_use], n_use
            n_chunks = n // b
            eys, vys = [], []
            for v in range(var_samples):
                ey = eyy = 0.0
                for t in range(n_chunks):
                    with span("uq.chunk"):
                        s = self.sample(x[t * b:(t + 1) * b],
                                        make_generator(self.device, seed, v,
                                                       t))
                        ey = ey + s.mean(dim=(0, 1))
                        eyy = eyy + (s * s).mean(dim=(0, 1))
                ey, eyy = ey / n_chunks, eyy / n_chunks
                eys.append(ey)
                vys.append(eyy - ey ** 2)
            with span("uq.moments"):
                ey, vy = torch.stack(eys), torch.stack(vys)
                return (ey.mean(0), ey.var(0, unbiased=False), vy.mean(0),
                        vy.var(0, unbiased=False))


class UQCondGlow:
    """The five UQ tasks over the Monte-Carlo and test sets.

    Args:
      surrogate: a ``GlowSurrogate`` (or anything with ``predict`` /
        ``sample`` / ``propagate``).
      mc_data / test_data: (x, y) NCHW numpy arrays.
      y_test_variation: the test set's per-channel sum of squared
        deviations (the R^2 denominator).
      post_dir: output directory.
      ntrain: the training set's size, printed by the propagation figures.
      seed: base of every task's noise.
    """

    def __init__(self, surrogate, mc_data, test_data, y_test_variation,
                 post_dir: str, imsize: int, batch_size: int = 64,
                 ntrain: int = 0, epochs: int = 0, seed: int = 0):
        self.s = surrogate
        self.mc_x, self.mc_y = mc_data
        self.test_x, self.test_y = test_data
        self.y_test_variation = np.asarray(y_test_variation)
        self.post_dir = post_dir
        self.imsize = imsize
        self.batch_size = batch_size
        self.ntrain = ntrain
        self.epochs = epochs
        self.seed = seed
        os.makedirs(post_dir, exist_ok=True)

    def _gen(self, *counters):
        return make_generator(self.s.device, self.seed, *counters)

    def _batches(self, x, y):
        for i in range(0, len(x), self.batch_size):
            yield x[i:i + self.batch_size], y[i:i + self.batch_size]

    def plot_prediction_at_x(self, n_pred: int, plot_samples: bool = False):
        """Target, predictive mean, std and error panels (and 15 samples
        with ``plot_samples``) at ``n_pred`` random test inputs (JAX
        uq.py:147-164), their numbers saved as
        ``predict_at_x/pred_at_x_epoch{E}_idx{i}.npz``."""
        save_dir = os.path.join(self.post_dir, "predict_at_x")
        os.makedirs(save_dir, exist_ok=True)
        idx = np.random.default_rng(1).permutation(len(self.test_x))[:n_pred]
        for i in idx:
            x = self.test_x[[i]]
            mean, var = self.s.predict(x, self._gen(int(i)))
            out = {"target": self.test_y[i], "mean": mean[0].cpu().numpy(),
                   "var": var[0].cpu().numpy()}
            plot_prediction_bayes2(save_dir, out["target"], out["mean"],
                                   out["var"], self.epochs, int(i))
            if plot_samples:
                out["samples"] = self.s.sample(
                    x, self._gen(int(i)))[:15, 0].cpu().numpy()
                save_samples(save_dir, np.concatenate(
                    [self.test_y[[i]], out["samples"]]), self.epochs, int(i),
                    "samples", nrow=4)
            np.savez(os.path.join(
                save_dir, f"pred_at_x_epoch{self.epochs}_idx{int(i)}.npz"),
                **out)

    def propagate_uncertainty(self, manual_scale: bool = False,
                              var_samples: int = 10):
        """Monte-Carlo input and output statistics against the surrogate's
        propagation (JAX uq.py:166-194): ``input_MC.png``, the mean and
        variance panels, and ``out_stats/out_stats.mat`` (channel-first
        fields)."""
        import scipy.io
        out_dir = os.path.join(self.post_dir, "out_stats")
        os.makedirs(out_dir, exist_ok=True)
        mean_y = self.mc_y.mean(0)
        var_y = self.mc_y.var(0)
        plot_row([self.mc_x.mean(0)[0], self.mc_x.var(0)[0]], out_dir,
                 "input_MC", plot_fn="contourf", cmap="jet")
        ee, ve, ev, vv = (a.cpu().numpy() for a in self.s.propagate(
            self.mc_x, self.seed, var_samples=var_samples,
            batch_size=self.batch_size))
        plot_MC2(out_dir, mean_y, ee, ve, True, self.ntrain,
                 manual_scale=manual_scale)
        plot_MC2(out_dir, var_y, ev, vv, False, self.ntrain)
        scipy.io.savemat(os.path.join(out_dir, "out_stats.mat"), {
            "sample_mean": mean_y, "sample_var": var_y, "y_pred_EE": ee,
            "y_pred_VE": ve, "y_pred_EV": ev, "y_pred_VV": vv})
        return ee, ve, ev, vv

    def plot_dist(self, num_loc: int):
        """p(y) at ``num_loc`` LHS-chosen pixels, surrogate against Monte
        Carlo (JAX uq.py:196-234): a KDE figure per pixel, and the
        predictive means and the targets at those pixels, (M, num_loc, C)
        each, saved with the locations in ``dist_estimate/``."""
        if num_loc <= 0:
            raise ValueError("num_loc must be positive")
        locations = lhs(2, num_loc, criterion="c", rng=3)
        idx = (locations * self.imsize).astype(int)
        preds, targets = [], []
        for b, (x, y) in enumerate(self._batches(self.mc_x, self.mc_y)):
            s = self.s.sample(x, self._gen(555 + b))     # (S, B, C, H, W)
            at_loc = s[:, :, :, idx[:, 0], idx[:, 1]].mean(dim=0)
            preds.append(at_loc.transpose(1, 2).cpu().numpy())
            targets.append(np.swapaxes(y[:, :, idx[:, 0], idx[:, 1]], 1, 2))
        pred = np.concatenate(preds, 0)
        target = np.concatenate(targets, 0)
        dist_dir = os.path.join(self.post_dir, "dist_estimate")
        os.makedirs(dist_dir, exist_ok=True)
        np.save(os.path.join(dist_dir, "locations.npy"), locations)
        np.save(os.path.join(dist_dir, "pred.npy"), pred)
        np.save(os.path.join(dist_dir, "target.npy"), target)
        plt = load_pyplot("the dist_estimate/loc_(...).pdf KDE figures")
        if plt is not None:
            from scipy.stats import gaussian_kde
            for loc in range(len(locations)):
                fig, axes = plt.subplots(1, 3, figsize=(12, 4))
                for c, ax in enumerate(axes):
                    for data, color, ls, label in (
                            (target[:, loc, c], "b", "--", "Monte Carlo"),
                            (pred[:, loc, c], "r", "-", "Surrogate")):
                        if np.std(data) < 1e-12:
                            continue
                        kde = gaussian_kde(data)
                        grid = np.linspace(data.min(), data.max(), 200)
                        ax.plot(grid, kde(grid), color=color, ls=ls,
                                label=label)
                    ax.legend()
                fig.savefig(os.path.join(
                    dist_dir, f"loc_({locations[loc][0]:.5f}, "
                              f"{locations[loc][1]:.5f}).pdf"), dpi=300)
                plt.close(fig)
        return pred, target

    def plot_reliability_diagram(self, label: str = "Conditional Glow",
                                 save_time: bool = True):
        """Empirical coverage of the Gaussian predictive intervals at ten
        probabilities (JAX uq.py:236-279): a figure per channel
        (``reliability_diagram_{c}.pdf``) and
        ``uncertainty_quality/reliability_diagram.txt`` (p, freq per
        channel)."""
        p_list = np.linspace(0.01, 0.99, 10)
        n_channels = self.mc_y.shape[1]
        stats = []
        for b, (x, y) in enumerate(self._batches(self.mc_x, self.mc_y)):
            if save_time and b > 4:
                continue
            mean, var = self.s.predict(x, self._gen(777 + b))
            stats.append((mean.cpu().numpy(), np.sqrt(var.cpu().numpy()), y))
        freq = []
        for p in p_list:
            count = np.zeros(n_channels)
            numels = 0
            for mean, std, y in stats:
                lo, hi = scipy_norm.interval(p, loc=mean, scale=std)
                count += ((y >= lo) & (y <= hi)).sum(axis=(0, 2, 3))
                numels += y.size / n_channels
            freq.append(count / numels)
        rel_dir = os.path.join(self.post_dir, "uncertainty_quality")
        os.makedirs(rel_dir, exist_ok=True)
        freq = np.stack(freq, 0)
        plt = load_pyplot("uncertainty_quality/reliability_diagram_*.pdf")
        for i in range(freq.shape[-1] if plt is not None else 0):
            plt.figure()
            plt.plot(p_list, freq[:, i], "r", label=label)
            plt.plot(np.linspace(0, 1, 100), np.linspace(0, 1, 100), "k--",
                     label="Ideal")
            plt.xlabel("Probability")
            plt.ylabel("Frequency")
            plt.legend(loc="upper left")
            plt.savefig(os.path.join(rel_dir, f"reliability_diagram_{i}.pdf"),
                        dpi=300)
            plt.close()
        out = np.zeros((len(p_list), 1 + n_channels))
        out[:, 0] = p_list
        out[:, 1:] = freq
        np.savetxt(os.path.join(rel_dir, "reliability_diagram.txt"), out)
        return freq

    def test_metric(self, handle_nan: bool = True):
        """NaN-robust rel-L2 and R^2 of the predictive mean (JAX
        uq.py:281-317): ``nrmse_test.txt``, ``r2_test.txt`` and, with
        ``handle_nan``, ``log_stats.txt`` (non-finite count, test size,
        abnormal rate)."""
        rel, sse = [], []
        num_nan_inf = 0
        for b, (x, y) in enumerate(self._batches(self.test_x, self.test_y)):
            mean, _ = self.s.predict(x, self._gen(999 + b))
            mean = np.asarray(mean.cpu())
            if handle_nan:
                bad = ~np.isfinite(mean).all(axis=(1, 2, 3))
                num_nan_inf += int(bad.sum())
                mean, y = mean[~bad], y[~bad]
            if len(mean) == 0:
                continue
            err2 = ((mean - y) ** 2).sum(axis=(2, 3))
            rel.append(np.sqrt(err2 / (y ** 2).sum(axis=(2, 3))))
            sse.append(err2)
        if rel:
            relative_l2 = np.concatenate(rel, 0).mean(0)
            r2 = 1 - np.concatenate(sse, 0).sum(0) / self.y_test_variation
        else:
            # every batch filtered away: still report the abnormal rate
            nc = self.test_y.shape[1]
            relative_l2 = np.full(nc, np.nan)
            r2 = np.full(nc, np.nan)
        print(relative_l2)
        print(r2)
        np.savetxt(os.path.join(self.post_dir, "nrmse_test.txt"), relative_l2)
        np.savetxt(os.path.join(self.post_dir, "r2_test.txt"), r2)
        if handle_nan:
            abnormal_rate = num_nan_inf / len(self.test_x)
            print(f"num_nan_inf: {num_nan_inf}")
            print(f"abnormal rate: {abnormal_rate:.6f}")
            np.savetxt(os.path.join(self.post_dir, "log_stats.txt"),
                       [num_nan_inf, len(self.test_x), abnormal_rate])
        return relative_l2, r2

"""Conditional-Glow cells: the program's reverse-KL training step with its
NaN guard (``train/glow_trainer``) over its device pipeline, and its
uncertainty propagation (``uq/uq.GlowSurrogate.propagate``), built as the
cGlow CLI and ``post_cglow`` build them from the benchmark's weights and
fields; ``reference`` is the plain reference that checks both."""

from __future__ import annotations

import torch

from pde_surrogate_torch.data.pipeline import DeviceDataset
from pde_surrogate_torch.models.glow import MultiScaleCondGlow
from pde_surrogate_torch.ops.filters import SobelFilter
from pde_surrogate_torch.train.glow_trainer import (create_glow_state,
                                                    make_reverse_kl_step)

from ..lib import weights
from ..reference import cglow as reference


def build_model(cfg: dict, seed: int, device) -> MultiScaleCondGlow:
    """The program's model with the benchmark's weights."""
    with torch.device("meta"):
        model = MultiScaleCondGlow(
            img_size=cfg["imsize"], x_channels=cfg["x_channels"],
            y_channels=cfg["y_channels"], enc_blocks=cfg["enc_blocks"],
            flow_blocks=cfg["flow_blocks"], flow_coupling=cfg["coupling"],
            squeeze_factor=2, LU_decompose=cfg["LU_decompose"],
            train_sampling=True, squeeze_order=cfg["squeeze_order"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights.make(reference.spec(cfg), seed, device))
    return model


class Train:
    """The program's reverse-KL state, guarded step and batch stream."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, fields, device):
        model = build_model(cfg, seed, device)
        r = cfg["recipe"]
        self.state = create_glow_state(
            model, lr_max=r["lr"],
            total_steps=r["epochs"] * (traffic["fields"] // traffic["batch"]),
            div_factor=r["lr_div"], pct_start=r["lr_pct"],
            weight_decay=r["weight_decay"], seed=seed)
        n = cfg["imsize"]
        self.step = make_reverse_kl_step(
            self.state, SobelFilter(n, correct=True), cfg["beta"],
            cfg["weight_bound"], cfg["y_channels"] * n * n, physics="sobel")
        self.data = DeviceDataset(fields[:, None], batch_size=traffic["batch"],
                                  seed=seed, device=device)
        self.model, self.optimizer = model, self.state.optimizer

    def applied(self) -> int:
        """Updates the NaN guard let through so far."""
        return self.state.updates


class Propagate:
    """The program's surrogate in evaluation mode; ``call(x, seed)`` is
    the UQ suite's ``propagate`` of the MC fields ``x`` (N, 1, n, n)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        # imported here: the UQ module loads scipy.stats, which training
        # cells need not pay for in their set-up
        from pde_surrogate_torch.uq.uq import GlowSurrogate
        self.model = build_model(cfg, seed, device)
        self.surrogate = GlowSurrogate(self.model, n_samples=traffic["draws"],
                                       temperature=1.0)
        self.traffic = traffic

    def call(self, x, seed: int):
        return self.surrogate.propagate(
            x, seed, var_samples=self.traffic["var_samples"],
            batch_size=self.traffic["chunk"])

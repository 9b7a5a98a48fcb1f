"""DenseED cells: the program's codec training step (``train/codec_trainer``
with the Sobel mixed residual, ``ops/filters``, ``ops/darcy``) over its
device pipeline (``data/pipeline``), built as the codec CLI builds it
(``cli/_codec_common.run_codec_training``) from the benchmark's weights and
fields; ``reference`` is the plain reference that checks it."""

from __future__ import annotations

import torch

from pde_surrogate_torch.data.pipeline import DeviceDataset
from pde_surrogate_torch.models.codec import DenseED
from pde_surrogate_torch.ops.filters import SobelFilter
from pde_surrogate_torch.train.codec_trainer import (create_state,
                                                     make_mixed_residual_step)

from ..lib import weights
from ..reference import denseed as reference


class Train:
    """The program's training state, step and batch stream of a cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, fields, device):
        with torch.device("meta"):
            model = DenseED(cfg["in_channels"], cfg["out_channels"],
                            cfg["imsize"], cfg["blocks"], cfg["growth_rate"],
                            cfg["init_features"], cfg["drop_rate"],
                            cfg["upsample"])
        model = model.to_empty(device=device)
        model.load_state_dict(weights.make(reference.spec(cfg), seed, device))
        r = cfg["recipe"]
        self.state = create_state(
            model, lr_max=r["lr"],
            total_steps=r["epochs"] * (traffic["fields"] // traffic["batch"]),
            div_factor=r["lr_div"], pct_start=r["lr_pct"],
            weight_decay=r["weight_decay"])
        self.step = make_mixed_residual_step(
            self.state, SobelFilter(cfg["imsize"], correct=True,
                                    filter_size=cfg["sobel_size"]),
            cfg["weight_bound"], physics="sobel", dropout_seed=seed)
        self.data = DeviceDataset(fields[:, None], batch_size=traffic["batch"],
                                  seed=seed, device=device)
        self.model, self.optimizer = model, self.state.optimizer

    def applied(self) -> int:
        """Updates applied so far."""
        return self.state.step

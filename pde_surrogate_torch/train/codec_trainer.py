"""Training and eval steps for the label-free DenseED codec.

Counterpart of pde_surrogate_tpu/train/codec_trainer.py for
``physics="sobel"``: the reference's mixed-residual training
(train_codec_mixed_residual.py:224-239) with Adam + OneCycle, and the test
step with rel-L2, SSE and the flux-pressure consistency.  The JAX package
scans an epoch as one device program; here an epoch is a Python loop over
these steps, which return device tensors and never synchronise.
"""

from __future__ import annotations

import torch

from ..ops.darcy import flux_pressure_consistency, mixed_residual_loss
from ..ops.filters import SobelFilter
from ..utils.metrics import relative_l2, squared_error_sum
from .schedules import one_cycle_schedule

__all__ = ["CodecState", "create_state", "make_mixed_residual_step",
           "make_eval_step", "current_lr"]


class CodecState:
    """The model, its optimizer, the step -> lr schedule and the number of
    updates taken so far."""

    def __init__(self, model, optimizer, schedule, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step


def _adam_l2(params, lr: float, weight_decay: float = 0.0):
    """Adam with coupled L2: torch's ``weight_decay`` adds wd * p to the
    gradient before the moments, as the JAX package's optax chain does."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_state(model, lr_max: float, total_steps: int,
                 div_factor: float = 2.0, pct_start: float = 0.3,
                 weight_decay: float = 0.0) -> CodecState:
    """Adam + OneCycle around ``model`` (reference optimizer:
    train_codec_mixed_residual.py:151-154)."""
    schedule = one_cycle_schedule(lr_max, total_steps, div_factor, pct_start)
    optimizer = _adam_l2(model.parameters(), schedule(0), weight_decay)
    return CodecState(model, optimizer, schedule)


def current_lr(state: CodecState) -> float:
    """The lr of the latest update (for logging)."""
    return state.schedule(max(state.step - 1, 0))


def make_mixed_residual_step(state: CodecState, sobel: SobelFilter,
                             weight_bound: float = 10.0):
    """Label-free physics step on a batch of K images (B, 1, H, W):
    train-mode forward (BN running stats update), mixed residual, backward,
    Adam at the scheduled lr of this update."""
    model, opt = state.model, state.optimizer

    def step(x: torch.Tensor) -> dict:
        model.train()
        output = model(x)
        loss, (pde, diri, neum) = mixed_residual_loss(x, output, sobel,
                                                      weight_bound)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return {"loss": loss.detach(), "loss_pde": pde.detach(),
                "loss_dirichlet": diri.detach(),
                "loss_neumann": neum.detach()}

    return step


def make_eval_step(state: CodecState, sobel: SobelFilter,
                   weight_bound: float = 10.0):
    """Test step (reference train_codec_mixed_residual.py:166-206): BN in
    eval mode, physics loss, per-sample (rel_l2, sse) against the labels,
    and the label-free flux-pressure consistency."""
    model = state.model

    @torch.no_grad()
    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.eval()
        output = model(x)
        loss, _ = mixed_residual_loss(x, output, sobel, weight_bound)
        return {"loss": loss,
                "rel_l2": relative_l2(output, y),
                "sse": squared_error_sum(output, y),
                "consistency": flux_pressure_consistency(x, output),
                "output": output}

    return step

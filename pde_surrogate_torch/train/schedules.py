"""Learning-rate schedules.

Counterpart of pde_surrogate_tpu/train/schedules.py.  ``one_cycle``
reproduces the reference's ``OneCycleScheduler`` (utils/practices.py:16-35):
linear warmup from lr_max/div_factor to lr_max over the first ``pct_start``
of training, then cosine annealing down to lr_low/1e4.  The arithmetic runs
in float32 in the same order as the JAX package, so the per-step lr agrees
to f32 rounding.
"""

from __future__ import annotations

import math

import torch

__all__ = ["annealing_linear", "annealing_cos", "one_cycle",
           "one_cycle_schedule", "find_lr_schedule"]


def annealing_linear(start, end, pct):
    """Linear anneal (utils/practices.py:6-7)."""
    return start + pct * (end - start)


def annealing_cos(start, end, pct):
    """Cosine anneal from start to end as pct goes 0 -> 1."""
    cos_out = torch.cos(math.pi * pct) + 1.0
    return end + (start - end) / 2.0 * cos_out


def one_cycle(lr_max: float, div_factor: float = 25.0,
              pct_start: float = 0.3):
    """pct in [0,1] -> lr (float32 tensor), the reference's scheduler."""
    lr_low = lr_max / div_factor

    def schedule(pct):
        # clamp: the cosine is periodic, so steps past total_steps would
        # ride back up toward lr_max
        pct = torch.clamp(torch.as_tensor(pct, dtype=torch.float32), 0.0, 1.0)
        warm = annealing_linear(lr_low, lr_max, pct / pct_start)
        cool = annealing_cos(lr_max, lr_low / 1e4,
                             (pct - pct_start) / (1.0 - pct_start))
        return torch.where(pct <= pct_start, warm, cool)

    return schedule


def one_cycle_schedule(lr_max: float, total_steps: int,
                       div_factor: float = 25.0, pct_start: float = 0.3):
    """step -> lr (Python float); step 0 is the first update.

    The reference computes pct = step/total_steps with step starting at 1
    (train_codec_mixed_residual.py:235-237); preserved here.
    """
    pct_fn = one_cycle(lr_max, div_factor, pct_start)
    total = torch.tensor(float(total_steps), dtype=torch.float32)

    def schedule(count: int) -> float:
        pct = torch.tensor(float(count + 1), dtype=torch.float32) / total
        return float(pct_fn(pct))

    return schedule


def find_lr_schedule(init_value: float = 1e-8, final_value: float = 10.0,
                     num_steps: int = 100):
    """step -> lr of the exponential LR-range test (reference
    utils/practices.py:45-83): init_value at step 0, final_value at
    ``num_steps``."""
    mult = (final_value / init_value) ** (1.0 / num_steps)

    def schedule(count: int) -> float:
        return init_value * mult ** count

    return schedule

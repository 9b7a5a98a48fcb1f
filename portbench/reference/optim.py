"""Adam and the OneCycle learning rate, written out in plain tensor
arithmetic (Kingma & Ba 2015; the reference's OneCycleScheduler,
utils/practices.py:16-35 of the source repository)."""

from __future__ import annotations

import math

import torch


def one_cycle_lr(count: int, lr_max: float, total_steps: int,
                 div_factor: float, pct_start: float) -> float:
    """The lr of update ``count`` (0 is the first): linear warm-up from
    lr_max / div_factor over ``pct_start`` of training, then cosine down
    to lr_max / div_factor / 1e4; pct = (count + 1) / total_steps."""
    pct = min(max((count + 1) / total_steps, 0.0), 1.0)
    low = lr_max / div_factor
    if pct <= pct_start:
        return low + pct / pct_start * (lr_max - low)
    end = low / 1e4
    t = (pct - pct_start) / (1.0 - pct_start)
    return end + (lr_max - end) / 2.0 * (math.cos(math.pi * t) + 1.0)


class Adam:
    """Adam without weight decay (beta1 0.9, beta2 0.999, eps 1e-8) over a
    dict of leaf tensors that require grad."""

    def __init__(self, params: dict, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.sub_(lr / c1 * self.m[k] / denom)

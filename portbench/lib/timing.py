"""Timing on the card: ``StepEvents`` records a CUDA event on the stream at
each unit boundary without a sync (the CUDA-event timing of
``chip_smoke.py``'s ``cuda_ms``) and reads the gaps once the window is
over."""

from __future__ import annotations

import statistics

import torch


class StepEvents:
    """CUDA events recorded at unit boundaries (a no-op off the card)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: list = []

    def mark(self) -> None:
        if self.enabled:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def gaps_ms(self) -> list:
        """ms between consecutive marks; call after a synchronise."""
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]


def p95(values: list) -> float | None:
    """The 95th percentile (``statistics.quantiles``, exclusive method),
    or None for fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20)[-1]

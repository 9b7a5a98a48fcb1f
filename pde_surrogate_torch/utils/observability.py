"""Step timing, profiling, anomaly detection and structured logging.

Counterpart of pde_surrogate_tpu/utils/observability.py:

* ``StepTimer`` — steps/s and samples/s, fenced on the card with
  ``torch.cuda.synchronize`` so that asynchronous launches do not fake the
  numbers;
* ``profile_trace`` — a ``torch.profiler`` window (CPU, and CUDA on a
  card) written as a Chrome trace, ``trace.json``;
* ``debug_nans`` — scoped ``torch.autograd.set_detect_anomaly``;
* ``JsonlLogger`` — one JSON object per line.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["StepTimer", "profile_trace", "debug_nans", "JsonlLogger"]


def _fence(fence) -> None:
    """Wait for the card that holds the tensor ``fence`` (no-op for a CPU
    tensor or None)."""
    if fence is not None and fence.is_cuda:
        torch.cuda.synchronize(fence.device)


class StepTimer:
    """Throughput meter.  ``fence`` (a tensor) makes ``start`` and
    ``result`` wait for the card that holds it."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0

    def start(self, fence=None):
        _fence(fence)
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1):
        self._steps += n

    def result(self, fence=None) -> dict:
        _fence(fence)
        dt = time.perf_counter() - self._t0
        steps_per_sec = self._steps / dt if dt > 0 else float("inf")
        return {"seconds": dt, "steps": self._steps,
                "steps_per_sec": steps_per_sec,
                "samples_per_sec": steps_per_sec * self.batch_size}


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device=None):
    """``torch.profiler`` around a code region, written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto).  On a CUDA
    ``device`` it records the card's kernels too, and raises if it saw
    none."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    if on_card and not any(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError("the profiler recorded no CUDA activity")


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Scoped autograd anomaly detection (a backward that produces NaN
    raises, naming the forward op); restores the previous setting."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enabled)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)


class JsonlLogger:
    """Append-only structured metrics log (one JSON object per line)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, record: dict):
        record = {k: (float(v) if hasattr(v, "item") else v)
                  for k, v in record.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

"""What the jobs share: the cell's family module, its input fields, the
host clock's window over units of work, and the card's bookkeeping."""

from __future__ import annotations

import gc
import importlib
import time

import numpy as np
import torch

from ..lib import trace
from ..lib.timing import StepEvents
from ..reference import grf

INPUTS_STREAM = 1       # the seed's counter for input fields


def mark(cell: dict, phase: str) -> None:
    """Note the end of a set-up phase (printed on standard error)."""
    cell.setdefault("phases", []).append(
        (phase, time.perf_counter() - cell["t_start"]))


def open_device(cell: dict) -> None:
    """Make the process's CUDA context (in the process that runs the
    cell's work, so that a cell's coordinating process holds none)."""
    if on_card(cell["device"]):
        torch.empty(1, device=cell["device"])
    mark(cell, "cuda context")


def family(cell: dict):
    return importlib.import_module(
        f"portbench.families.{cell['config']['family']}")


def fields(cell: dict, n: int) -> np.ndarray:
    """``n`` KLE input fields (n, imsize, imsize) float32 of the cell's
    seed."""
    cfg, traffic = cell["config"], cell["traffic"]
    return grf.sample_kle(n, cfg["imsize"], traffic["kle"],
                          np.random.SeedSequence([cell["seed"],
                                                  INPUTS_STREAM]))


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def window(unit, seconds: float, spans: bool, device,
           start_at: float | None = None) -> dict:
    """Run ``unit()`` until ``seconds`` of host clock have passed since
    the window opened (at ``start_at``, a ``time.perf_counter`` value, or
    now), then synchronise.  ``unit`` returns (output, host seconds of its
    batch fetch or None).  With ``spans``, the host time of each unit and
    a CUDA event at each unit boundary are kept.  Returns the outputs,
    units, window seconds and spans."""
    events = StepEvents(spans and on_card(device))
    outs, host_s, batch_s = [], [], []
    sync(device)
    if start_at is not None:
        while time.perf_counter() < start_at:
            time.sleep(min(0.001, max(start_at - time.perf_counter(), 0)))
    t0 = time.perf_counter()
    end = t0 + seconds
    events.mark()
    while time.perf_counter() < end:
        a = time.perf_counter()
        out, fetch_s = unit()
        if spans:
            host_s.append(time.perf_counter() - a - (fetch_s or 0.0))
            if fetch_s is not None:
                batch_s.append(fetch_s)
            events.mark()
        outs.append(out)
    sync(device)
    t1 = time.perf_counter()
    return {"outs": outs, "units": len(outs), "window_s": t1 - t0,
            "t0": t0, "t1": t1, "host_unit_s": host_s, "batch_s": batch_s,
            "gaps_ms": events.gaps_ms()}


def profile(run_unit, units: int, device) -> dict:
    """The reduced trace of ``units`` more units (``lib.trace``).  Off the
    card (the tests) the units run untraced, and nothing ran on a device."""
    if on_card(device):
        return trace.profile(run_unit, units)
    tic = time.perf_counter()
    for _ in range(units):
        run_unit()
    return {"window_s": time.perf_counter() - tic, "busy_s": 0.0,
            "kernels": 0, "syncs": 0, "units": units, "ops": [],
            "w0_us": 0.0, "w1_us": 0.0, "start_us": 0.0, "device_ops": [],
            "gaps": []}


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def free(device) -> None:
    """Return the program's freed memory to the card before the
    reference runs."""
    gc.collect()
    if on_card(device):
        torch.cuda.empty_cache()

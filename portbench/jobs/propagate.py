"""Uncertainty-propagation cells: repeated calls of the program's
``propagate`` on slices of a pool of Monte-Carlo input fields, a new seed
per call, closed loop, for the window; a sample of the window's calls,
drawn from the seed, is checked against the reference once it closes."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..lib import counts, weights
from ..reference import check
from ..reference.seeding import seed_of
from . import common

CALL_STREAM, CHECK_STREAM, WARM_STREAM, TRACE_STREAM = 3, 4, 5, 6
FOLD = 5                # reference draws per pass of the reverse flow


def run(cell: dict) -> dict:
    fam = common.family(cell)
    common.mark(cell, "program")
    cfg, traffic, device = cell["config"], cell["traffic"], cell["device"]
    seed, size = cell["seed"], traffic["slice"]
    common.open_device(cell)
    pool = common.fields(cell, traffic["pool"])[:, None]
    common.mark(cell, "fields")
    prog = fam.Propagate(cfg, traffic, seed, device)
    common.mark(cell, "build")
    prog.call(pool[:traffic["warm_fields"]], seed_of(seed, WARM_STREAM))
    common.sync(device)
    common.mark(cell, "warm call")
    setup_s = time.perf_counter() - cell["t_start"]
    slices = len(pool) // size
    calls = []

    def unit():
        k = len(calls)
        calls.append((k % slices, seed_of(seed, CALL_STREAM, k)))
        a = calls[-1][0] * size
        return prog.call(pool[a:a + size], calls[-1][1]), None

    w = common.window(unit, cell["seconds"], cell["trace"], device)
    moments = w.pop("outs")
    finite = [bool(all(torch.isfinite(m).all() for m in ms))
              for ms in moments]
    record = {"job": "propagate", "setup_s": setup_s, **w,
              "fields": w["units"] * size, "attempted": w["units"],
              "failed": finite.count(False),
              "memory_peak_bytes": common.memory_peak(device)}
    if cell["trace"]:
        record["trace"] = common.profile(
            lambda: prog.call(pool[:size], seed_of(seed, TRACE_STREAM)),
            traffic["profile_units"], device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, CHECK_STREAM]))
    picked = sorted(rng.choice(len(calls), min(traffic["check_calls"],
                                               len(calls)), replace=False))
    got = {int(k): [m.cpu() for m in moments[k]] for k in picked}
    del prog, moments, unit
    common.free(device)
    tic = time.perf_counter()
    w64 = weights.make(fam.reference.spec(cfg), seed, device,
                       check.REFERENCE)
    gaps = []
    for k, ms in got.items():
        s, call_seed = calls[k]
        x = torch.from_numpy(pool[s * size:(s + 1) * size]).to(
            device, check.REFERENCE)
        ref = fam.reference.propagate(cfg, traffic, w64, x, call_seed, FOLD)
        gaps.append(check.moment_gap(ms, ref))
    record["checks"] = {"moment_gap": check.worst(gaps) if gaps
                        else math.nan}
    record["reference_s"] = time.perf_counter() - tic
    if cell["trace"]:
        record["flops_per_unit"], record["bytes_per_unit"] = counts.count(
            fam.reference.count_propagate(cfg, traffic))
    return record

"""Training cells: the program's training step over its batch stream,
closed loop, for the window; the first three steps, taken in set-up
through the same step and stream, are checked against the reference.

With ``processes`` > 1 in the traffic, that many processes run the cell's
loop on the one card at once, with seeds seed, seed + 1, ...: their
set-ups end before the common window opens, and the cell's numbers are
their sums over it (``shared``).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

from ..lib import counts, trace, weights
from ..lib.guard import forbidden_loaded
from ..reference import check
from ..reference.seeding import epoch_rows
from . import common

WARM_STEPS = 2          # unchecked steps after the checked ones
PROTOCOL = "portbench:"


def program_readings(prog, stream, spec: list) -> dict:
    """The program's first ``check.CHECKED_STEPS`` steps through its own
    step and batch stream: each loss, each leaf's first gradient norm (from
    Adam's first moment after one step) and its change after the last,
    and the running moments' changes after the first and the last step."""
    names, moments = weights.leaves(spec), weights.running(spec)
    state = {**dict(prog.model.named_parameters()),
             **dict(prog.model.named_buffers())}
    params = {n: state[n] for n in names}
    start = {n: state[n].detach().clone() for n in names + moments}
    beta1 = prog.optimizer.param_groups[0]["betas"][0]
    losses, grad, buffers = [], {}, {}
    for k in range(check.CHECKED_STEPS):
        losses.append(prog.step(*next(stream))["loss"])
        if k == 0:
            opt = prog.optimizer.state
            grad = {n: (float(opt[params[n]]["exp_avg"].norm()) / (1 - beta1)
                        if "exp_avg" in opt.get(params[n], {})
                        else float("nan")) for n in names}
            buffers = check.changes(state, start, moments)
    return {"loss": [float(x) for x in losses], "grad": grad,
            "change": check.changes(state, start, names), "buffers": buffers,
            "buffers_last": check.changes(state, start, moments)}


def run(cell: dict) -> dict:
    if cell["traffic"].get("processes", 1) > 1:
        return shared(cell)
    return one(cell)


def one(cell: dict, wait_for_go=None, wait_for_trace=None) -> dict:
    """One process's run of a training cell; ``wait_for_go()`` (shared
    cells) returns the perf_counter time at which the window opens, and
    ``wait_for_trace()`` that of the traced sub-window."""
    fam = common.family(cell)
    common.mark(cell, "program")
    cfg, traffic, device = cell["config"], cell["traffic"], cell["device"]
    seed = cell["seed"]
    common.open_device(cell)
    x = common.fields(cell, traffic["fields"])
    common.mark(cell, "fields")
    prog = fam.Train(cfg, traffic, seed, x, device)
    stream = itertools.chain.from_iterable(prog.data.batches(e)
                                           for e in itertools.count(1))
    common.mark(cell, "build")
    readings = program_readings(prog, stream, fam.reference.spec(cfg))
    common.mark(cell, "checked steps")
    for _ in range(WARM_STEPS):
        prog.step(*next(stream))
    common.sync(device)
    common.mark(cell, "warm steps")
    setup_s = time.perf_counter() - cell["t_start"]
    start_at = wait_for_go(setup_s) if wait_for_go else None
    applied = []

    def unit():
        a = time.perf_counter()
        batch = next(stream)
        fetched = time.perf_counter() - a
        before = prog.applied()
        out = prog.step(*batch)
        applied.append(prog.applied() - before)
        return out["loss"], fetched

    w = common.window(unit, cell["seconds"], cell["trace"], device, start_at)
    losses = torch.stack(w.pop("outs")).double().cpu().tolist()
    record = {"job": "train", "setup_s": setup_s, **w,
              "samples": w["units"] * traffic["batch"],
              "attempted": w["units"],
              "failed": sum(1 for v, a in zip(losses, applied)
                            if not (math.isfinite(v) and a)),
              "memory_peak_bytes": common.memory_peak(device)}
    if cell["trace"]:
        if wait_for_trace:
            at = wait_for_trace()
            while time.perf_counter() < at:
                time.sleep(0.001)
        record["trace"] = common.profile(lambda: prog.step(*next(stream)),
                                         traffic["profile_units"], device)
    del prog, stream, unit
    common.free(device)
    tic = time.perf_counter()
    record["checks"] = check.train_gaps(readings, reference_readings(cell, x))
    record["reference_s"] = time.perf_counter() - tic
    if cell["trace"]:
        record["flops_per_unit"], record["bytes_per_unit"] = counts.count(
            fam.reference.count_train(cfg, traffic))
    return record


def reference_readings(cell: dict, x, dtype=check.REFERENCE) -> dict:
    """The reference's readings of the cell's three checked steps: from
    the weights of the seed, on the first rows of the seed's first epoch
    of the fields ``x``, in ``dtype``."""
    cfg, traffic, seed = cell["config"], cell["traffic"], cell["seed"]
    ref = common.family(cell).reference
    rows = epoch_rows(seed, 1, traffic["fields"],
                      traffic["batch"])[:check.CHECKED_STEPS]
    total = cfg["recipe"]["epochs"] * (traffic["fields"] // traffic["batch"])
    return check.train_readings(
        ref.train_loss(cfg, seed, cell["device"]), ref.spec(cfg), seed,
        [torch.from_numpy(x[r.numpy()][:, None]) for r in rows],
        check.one_cycle(cfg["recipe"], total), cell["device"], dtype)


def _say(obj) -> None:
    print(PROTOCOL + json.dumps(obj), flush=True)


def _hear(proc) -> dict:
    for line in proc.stdout:
        if line.startswith(PROTOCOL):
            return json.loads(line[len(PROTOCOL):])
    raise RuntimeError(f"a process of the cell ended (rc {proc.wait()})")


def child(cell: dict) -> None:
    """A shared cell's process: says when its set-up is done, opens its
    window (and its traced sub-window) when told, and sends back its
    record with the JAX check's findings."""
    def wait(kind):
        def wait_for(*info):
            _say({kind: info[0] if info else None})
            return float(sys.stdin.readline())
        return wait_for

    record = one(cell, wait("ready"), wait("traced"))
    record["forbidden"] = forbidden_loaded()
    _say({"record": record})


def shared(cell: dict) -> dict:
    """Start ``processes`` children of this cell (``run.py --rank i``),
    open their windows together, and sum their records over the common
    window: from the opening to the last child's close."""
    traffic = cell["traffic"]
    env = dict(os.environ, OMP_NUM_THREADS=str(traffic.get("threads", 2)))
    cmd = [sys.executable, cell["entry"], "--workload", cell["name"],
           "--seconds", str(cell["seconds"]), "--trace", str(cell["trace"]),
           "--root", cell["root"], "--device", cell["device"]]
    procs = [subprocess.Popen(cmd + ["--seed", str(cell["seed"] + i),
                                     "--rank", str(i)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True, env=env)
             for i in range(traffic["processes"])]
    try:
        for p in procs:
            _hear(p)
        setup_s = time.perf_counter() - cell["t_start"]

        def go():
            at = time.perf_counter() + 0.5
            for p in procs:
                p.stdin.write(f"{at!r}\n")
                p.stdin.flush()
            return at

        t0 = go()
        if cell["trace"]:
            [_hear(p) for p in procs]
            go()
        records = [_hear(p)["record"] for p in procs]
    finally:
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
            if p.wait(timeout=120) != 0:
                raise RuntimeError(f"a process of the cell exited with "
                                   f"{p.returncode}")
    out = {"job": "train", "setup_s": setup_s,
           "window_s": max(r["t1"] for r in records) - t0,
           "processes": len(records)}
    for k in ("units", "samples", "attempted", "failed", "memory_peak_bytes"):
        out[k] = sum(r[k] for r in records)
    out["forbidden"] = sorted({m for r in records for m in r["forbidden"]})
    out["checks"] = {k: check.worst(r["checks"][k] for r in records)
                     for k in records[0]["checks"]}
    if cell["trace"]:
        out["trace"] = trace.merge([r["trace"] for r in records])
        out["flops_per_unit"] = records[0]["flops_per_unit"]
        out["bytes_per_unit"] = records[0]["bytes_per_unit"]
    return out

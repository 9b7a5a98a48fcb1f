"""The readings that a cell's limits are set from: for each seed, the
numbers that decide ``correct`` as the program reads them, as the control
reads them (the reference in float32 with TF32 on, in the program's place)
and as the program reads them with a fault planted in its timed path.

Training cells take no window: the readings are of the three checked
steps.  Faults: ``half_batch`` (the step sees the first half of each batch,
its mean over that half), ``unchanged`` (the optimizer's step does
nothing, so the state is returned unchanged), and two of the running
moments: ``frozen_moments`` (BatchNorm leaves them alone) and
``unbiased_moments`` (torch's own BatchNorm, which folds the unbiased
batch variance).  Propagation cells read the
first call of a run; faults: ``half_draws`` (the mean over half of the
draws) and ``temperature`` (the drawn fields altered where they are made:
the latents scaled by 0.95).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3
        [--control] [--faults] [--program]

prints one JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
import types

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import torch  # noqa: E402

from portbench.harness import ROOT, load_cell  # noqa: E402
from portbench.jobs import common  # noqa: E402
from portbench.jobs.propagate import CALL_STREAM, FOLD  # noqa: E402
from portbench.jobs.train import (program_readings,  # noqa: E402
                                  reference_readings)
from portbench.lib import weights  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.reference.seeding import seed_of  # noqa: E402


def _half_batch(prog):
    step = prog.step
    prog.step = lambda x, *a: step(x[:len(x) // 2], *a)


def _unchanged(prog):
    prog.optimizer.step = lambda *a, **k: None


def _batch_norms(prog):
    from pde_surrogate_torch.models.codec import BatchNorm2d
    return [m for m in prog.model.modules() if isinstance(m, BatchNorm2d)]


def _frozen_moments(prog):
    for m in _batch_norms(prog):
        m.fold_stats = False


def _unbiased_moments(prog):
    for m in _batch_norms(prog):
        m.forward = types.MethodType(torch.nn.BatchNorm2d.forward, m)


TRAIN_FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged,
                "frozen_moments": _frozen_moments,
                "unbiased_moments": _unbiased_moments}


def train_readings(cell: dict, seed: int, kinds: list) -> dict:
    fam = common.family(cell)
    cfg, traffic, device = cell["config"], cell["traffic"], cell["device"]
    x = common.fields(cell, traffic["fields"])
    ref = reference_readings(cell, x)
    out = {}
    for kind in kinds:
        if kind == "control":
            with check.control():
                got = reference_readings(cell, x, torch.float32)
        else:
            prog = fam.Train(cfg, traffic, seed, x, device)
            if kind != "program":
                TRAIN_FAULTS[kind](prog)
            stream = itertools.chain.from_iterable(
                prog.data.batches(e) for e in itertools.count(1))
            got = program_readings(prog, stream, fam.reference.spec(cfg))
            del prog, stream
            common.free(device)
        out[kind] = {**check.train_gaps(got, ref),
                     **check.train_detail(got, ref)}
    return out


def propagate_readings(cell: dict, seed: int, kinds: list) -> dict:
    fam = common.family(cell)
    cfg, traffic, device = cell["config"], cell["traffic"], cell["device"]
    size = traffic["slice"]
    x = common.fields(cell, traffic["pool"])[:size, None]
    call_seed = seed_of(seed, CALL_STREAM, 0)

    def reference(dtype):
        w = weights.make(fam.reference.spec(cfg), seed, device, dtype)
        return fam.reference.propagate(
            cfg, traffic, w, torch.from_numpy(x).to(device, dtype),
            call_seed, FOLD)

    ref = reference(check.REFERENCE)
    out = {}
    for kind in kinds:
        if kind == "control":
            with check.control():
                got = reference(torch.float32)
        else:
            prog = fam.Propagate(cfg, traffic, seed, device)
            if kind == "half_draws":
                prog.surrogate.n_samples = traffic["draws"] // 2
            elif kind == "temperature":
                prog.surrogate.temperature = 0.95
            got = [m.cpu() for m in prog.call(x, call_seed)]
            del prog
        out[kind] = {"moment_gap": check.moment_gap(got, ref)}
        common.free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from pde_surrogate_torch.utils.config import select_device
    select_device(args.device)
    cell = load_cell(ROOT, args.workload)
    job = cell["traffic"]["job"]
    kinds = (["program"] * args.program + ["control"] * args.control
             + (list(TRAIN_FAULTS) if job == "train"
                else ["half_draws", "temperature"]) * args.faults)
    read = train_readings if job == "train" else propagate_readings
    for seed in args.seeds:
        tic = time.perf_counter()
        cell.update(seed=seed, device=args.device)
        out = read(cell, seed, kinds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - tic, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

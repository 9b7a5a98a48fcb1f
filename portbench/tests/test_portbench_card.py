"""On the card, at each cell's own size: the control (the reference in
float32 with TF32 on, in the program's place) comes out not correct under
the committed limits, and the program on the same seed comes out correct.
Run on the card: python -m pytest portbench/tests -m gpu"""

from __future__ import annotations

import json
import os

import pytest

from portbench.harness import ROOT, load_cell

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]
    if json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                   f"{w['traffic']}.json"))).get(
        "processes", 1) == 1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pde_surrogate_torch.utils.config import select_device
    return select_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    from portbench import calibrate
    c = load_cell(ROOT, cell)
    seed = 2 ** 31 + 17
    c.update(seed=seed, device="cuda")
    read = (calibrate.train_readings if c["traffic"]["job"] == "train"
            else calibrate.propagate_readings)
    got = read(c, seed, ["program", "control"])
    passes = {kind: all(got[kind][k] <= v for k, v in c["limits"].items())
              for kind in got}
    assert passes == {"program": True, "control": False}, got

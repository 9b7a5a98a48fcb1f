"""Every cell of BENCHMARK.json runs end to end on the CPU at tiny sizes,
untraced and traced, against its reference, and prints the contract's
result line last."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench.harness import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _expected(cell: str, group: str) -> set:
    return {m["name"] for m in BENCH[group]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_run, no_forbidden, cell, trace):
    rc, out = tiny_run(cell, trace)
    assert rc == 0 and out is not None
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert 0 <= c["value"] <= c["limit"], name
    device = out["device"]
    assert device["platform"] == "cpu" and device["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(device)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU runs no device trace: the readers of device numbers stay
        # silent, the rest report
        expected = _expected(cell, "per_layer")
        assert set(out["metrics"]) <= expected
        assert {m for m in expected if m.startswith("mfu")} <= set(
            out["metrics"])
    else:
        assert set(out["metrics"]) == _expected(cell, "end_to_end")
    for m in out["metrics"].values():
        assert m["value"] > 0 or m["unit"] != "samples/s"


def test_same_seed_same_work(tiny_run, no_forbidden):
    """The inputs, weights and checked steps come from the seed alone."""
    a = tiny_run("codec-sobel-train", seed=123456789012)[1]["checks"]
    b = tiny_run("codec-sobel-train", seed=123456789012)[1]["checks"]
    c = tiny_run("codec-sobel-train", seed=7)[1]["checks"]
    assert a == b and a != c


def test_checks_printed_last_on_stderr(tiny_root, no_forbidden, capsys):
    from portbench.tests.conftest import run_tiny
    run_tiny(tiny_root, "cglow-uq-propagate", capsys=None)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check moment_gap ") and " limit " in err[-1]


@pytest.mark.parametrize("family", ["denseed", "cglow"])
def test_reference_names_the_program_state(tiny_root, family):
    """The reference's spec names every tensor of the program's state
    (loaded strictly) and its trained leaves are the program's
    parameters."""
    import importlib

    from portbench.lib import weights
    from portbench.tests.conftest import TINY_CONFIGS
    cfg = next(json.load(open(os.path.join(ROOT, c["file"])))
               for c in BENCH["configs"]
               if json.load(open(os.path.join(ROOT, c["file"])))["family"]
               == family)
    cfg.update(TINY_CONFIGS[family])
    fam = importlib.import_module(f"portbench.families.{family}")
    fields = np.ones((8, cfg["imsize"], cfg["imsize"]), np.float32)
    prog = fam.Train(cfg, {"fields": 8, "batch": 4}, 3, fields, "cpu")
    assert set(weights.leaves(fam.reference.spec(cfg))) == {
        n for n, _ in prog.model.named_parameters()}

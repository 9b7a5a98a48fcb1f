"""``spans.py``: the program's spans in a cell on the CPU at tiny sizes, and
its gap labelling on a synthetic trace, which leaves ``lib.trace``'s
numbers as they were."""

from __future__ import annotations

import copy
import json
from types import SimpleNamespace

import pytest
import torch

from portbench import spans as tool
from portbench.lib import trace


@pytest.mark.parametrize("cell,root,kids", [
    ("codec-sobel-train", "train.step", 4),
    ("cglow-revkl-train", "train.step", 6),
    ("cglow-uq-propagate", "uq.propagate", 2)])
def test_split_on_the_cpu(tiny_root, no_forbidden, capsys, cell, root, kids):
    assert tool.main(["--workload", cell, "--seed", "2147483653",
                      "--steps", "2", "--pairs", "2", "--root", tiny_root,
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["root"] == root and len(out["blocks"]) == 4
    assert [b["on"] for b in out["blocks"]] == [False, True, True, False]
    assert all(b["cpu_ms"] > 0 for b in out["blocks"])
    assert out["spans_per_unit"][root]["count"] == 1
    assert 0.5 < out["root_over_host"] <= 1.0
    assert 0.5 < out["children_cover"] <= 1.0
    got = {k for k in out["spans_per_unit"] if k != root}
    assert len(got - {"data.gather", "data.epoch"}) == kids
    assert out["counters_per_unit"] == (
        {"sync.guard": 1.0} if cell == "cglow-revkl-train" else {})
    assert "trace" not in out


def _event(name, a, b, card=False):
    return SimpleNamespace(
        name=name, is_user_annotation=False,
        device_type=(torch.autograd.DeviceType.CUDA if card
                     else torch.autograd.DeviceType.CPU),
        time_range=SimpleNamespace(start=a, end=b,
                                   elapsed_us=lambda: b - a))


def test_labels_on_a_synthetic_trace():
    """Host calls and kernels (us); the step's span at 1-65 us and its
    guard at 28-62 us on the trace's clock, recorded on a host clock 910
    us behind it (the window's final sync ends at 85 us, the host read
    995 us; the profiler's own sync follows at 88-90 us)."""
    events = [_event("cudaLaunchKernel", 0, 2), _event("k1", 3, 25, True),
              _event("cudaLaunchKernel", 20, 22), _event("k2", 26, 40, True),
              _event("cudaStreamSynchronize", 30, 60),
              _event("cudaLaunchKernel", 61, 62), _event("k3", 63, 80, True),
              _event("cudaDeviceSynchronize", 70, 85),
              _event("cudaDeviceSynchronize", 88, 90)]
    reduced = trace.reduce(events, 1)
    before = copy.deepcopy(reduced)
    rec = SimpleNamespace(spans=[("train.step", -1, 911_000, 975_000),
                                 ("train.guard", 0, 938_000, 972_000)],
                          counters={"sync.guard": 1})
    got = tool.label(events, reduced, rec, 995_000)
    assert reduced == before and trace.reduce(events, 1) == before
    # the window's own final sync counted: the profiler's closes the window
    assert before["busy_s"] == pytest.approx(53e-6) and before["syncs"] == 2
    assert got["idle_s"] == pytest.approx(37e-6)
    assert got["idle_s_by_span"] == pytest.approx(
        {"train.step/train.guard": 22e-6, "train.step": 4e-6, "-": 11e-6})
    assert got["idle_in_span_pct"] == pytest.approx(100 * 26 / 37)
    assert [g[0] for g in got["idle_gaps"]] == [
        "in cudaStreamSynchronize @ train.step/train.guard",
        "in cudaDeviceSynchronize @ -",
        "in cudaLaunchKernel @ -",
        "host after cudaLaunchKernel @ train.step"]
    assert [g[0].split(" @ ")[0] for g in got["idle_gaps"]] == [
        g[0] for g in before["gaps"]]
    assert got["sync_calls"] == [
        {"call": "cudaStreamSynchronize", "at_us": 30, "ms": 0.03,
         "span": "train.step/train.guard", "outside_us": 0.0,
         "margins_us": [2.0, 2.0]},
        {"call": "cudaDeviceSynchronize", "at_us": 70, "ms": 0.015,
         "span": "-", "outside_us": None, "margins_us": None}]
    assert got["idle_s_by_label"] == pytest.approx({
        "in cudaStreamSynchronize @ train.step/train.guard": 23e-6,
        "in cudaDeviceSynchronize @ -": 10e-6,
        "in cudaLaunchKernel @ -": 3e-6,
        "host after cudaLaunchKernel @ train.step": 1e-6})
    assert got["unspanned"] == [["in cudaDeviceSynchronize", 80, 10e-6],
                                ["in cudaLaunchKernel", 0, 3e-6]]
    assert got["spans_per_unit"]["train.guard"]["incl_ms"] == 0.034

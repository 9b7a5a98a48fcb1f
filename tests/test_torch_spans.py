"""The port's program spans and counters (utils/observability.py): off, a
span is the shared null object; on, the training steps, the batch stream
and the UQ propagation record nested spans that change no number, the
host-device syncs are counted, and ``profile_trace`` writes the spans into
its Chrome trace on the trace's clock.  Tiny models on the CPU."""

import json

import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.pipeline import DeviceDataset
from pde_surrogate_torch.models.codec import DenseED
from pde_surrogate_torch.models.glow import MultiScaleCondGlow
from pde_surrogate_torch.ops.filters import SobelFilter
from pde_surrogate_torch.train import codec_trainer, glow_trainer
from pde_surrogate_torch.uq.uq import GlowSurrogate
from pde_surrogate_torch.utils import observability as obs

torch.set_num_threads(1)

N, B = 16, 4
STEP_CHILDREN = {
    "codec": ["train.forward", "train.loss", "train.backward",
              "train.optimizer"],
    "glow": ["train.noise", "train.forward", "train.loss", "train.backward",
             "train.guard", "train.optimizer"],
}


def _x(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.exp(rng.normal(0, 1, (B, 1, N, N)))
                            .astype(np.float32))


def _glow_model():
    torch.manual_seed(0)
    return MultiScaleCondGlow(N, 1, 3, [1, 1], [1, 1])


def _step(kind):
    """A fresh (state, step) of the codec's Sobel step or the cGlow's
    reverse-KL step, the same weights on every call."""
    if kind == "codec":
        torch.manual_seed(0)
        state = codec_trainer.create_state(
            DenseED(1, 3, N, [1, 2, 1], growth_rate=4, init_features=8),
            lr_max=1e-3, total_steps=10)
        return state, codec_trainer.make_mixed_residual_step(
            state, SobelFilter(N), 10.0)
    state = glow_trainer.create_glow_state(_glow_model(), lr_max=1e-3,
                                           total_steps=10, seed=3)
    return state, glow_trainer.make_reverse_kl_step(
        state, SobelFilter(N), 150.0, 50.0, 3 * N * N)


def _record_steps(kind, n=1):
    state, step = _step(kind)
    with obs.recording() as rec:
        losses = [step(_x(k))["loss"] for k in range(n)]
    return state, losses, rec


def test_off_span_is_the_shared_null_object():
    a, b = obs.span("train.step"), obs.span("data.gather")
    assert a is b is obs.NULL_SPAN
    with a:
        obs.count("sync.guard")
    with obs.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert obs.span("train.step") is obs.NULL_SPAN      # off again after


@pytest.mark.parametrize("kind", ["codec", "glow"])
def test_recording_changes_no_number(kind):
    """Two steps from the same weights and batches, one pair recorded:
    bit-identical losses, parameters and buffers."""
    off_state, off_step = _step(kind)
    off = [off_step(_x(k))["loss"] for k in range(2)]
    on_state, on, _ = _record_steps(kind, 2)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    for (name, a), (_, b) in zip(off_state.model.state_dict().items(),
                                 on_state.model.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["codec", "glow"])
def test_step_spans_nest_inside_their_parent(kind):
    _, _, rec = _record_steps(kind)
    root, *children = rec.spans
    assert root[:2] == ("train.step", -1)
    assert [c[0] for c in children] == STEP_CHILDREN[kind]
    assert all(c[1] == 0 for c in children)
    ends = [root[2]]
    for _, _, a, b in children:
        assert ends[-1] <= a <= b <= root[3]    # in order, none overlapping
        ends.append(b)


def test_self_time_is_inclusive_less_the_children():
    spans = [("a", -1, 0, 100), ("b", 0, 10, 30), ("c", 1, 12, 20),
             ("b", 0, 40, 50), ("a", -1, 200, 260)]
    assert obs.summarize(spans) == {
        "a": {"count": 2, "incl_ns": 160, "self_ns": 130},
        "b": {"count": 2, "incl_ns": 30, "self_ns": 22},
        "c": {"count": 1, "incl_ns": 8, "self_ns": 8}}
    _, _, rec = _record_steps("glow")
    got = obs.summarize(rec.spans)
    kids = sum(got[n]["incl_ns"] for n in STEP_CHILDREN["glow"])
    step = got["train.step"]
    assert step["self_ns"] == step["incl_ns"] - kids


def test_an_epoch_gathers_every_step_once():
    ds = DeviceDataset(np.zeros((22, 1, 2, 2), np.float32), batch_size=4,
                       device="cpu", seed=1)
    with obs.recording() as rec:
        batches = list(ds.batches(1))
    got = obs.summarize(rec.spans)
    assert len(batches) == ds.steps_per_epoch == 5
    assert got["data.gather"]["count"] == 5
    assert got["data.epoch"]["count"] == 1
    assert all(p == -1 for _, p, _, _ in rec.spans)
    assert rec.counters == {}       # the indices stay on the host's device


def test_propagate_spans_a_chunk_per_draw_of_the_estimator():
    surrogate = GlowSurrogate(_glow_model().eval(), n_samples=2)
    mc_x = _x().numpy()
    with obs.recording() as rec:
        surrogate.propagate(mc_x, seed=5, var_samples=3, batch_size=2)
    got = obs.summarize(rec.spans)
    n_chunks = B // 2
    assert got["uq.chunk"]["count"] == n_chunks * 3
    assert got["uq.propagate"]["count"] == got["uq.moments"]["count"] == 1
    assert [n for n, p, _, _ in rec.spans if p == -1] == ["uq.propagate"]
    assert rec.counters == {}       # the inputs are on the model's device


@pytest.mark.parametrize("kind,syncs", [("codec", {}),
                                        ("glow", {"sync.guard": 3})])
def test_syncs_counted_per_step(kind, syncs):
    _, _, rec = _record_steps(kind, 3)
    assert rec.counters == syncs
    assert obs.summarize(rec.spans)["train.step"]["count"] == 3


def test_nested_recording_records_apart():
    with obs.recording() as outer:
        with obs.span("a"):
            with obs.recording() as inner:
                with obs.span("b"):
                    obs.count("n", 2)
            with obs.span("c"):
                obs.count("n")
    assert [s[:2] for s in inner.spans] == [("b", -1)]
    assert [s[:2] for s in outer.spans] == [("a", -1), ("c", 0)]
    assert inner.counters == {"n": 2} and outer.counters == {"n": 1}


def test_trace_clock_and_span_paths_on_a_synthetic_trace():
    """The host read 5 000 us after the window's final device sync
    returned, which ends at 100 us on the trace's clock (the profiler's
    own sync follows at 110-111 us): a span at host 4 910-4 980 us lies at
    10-80 us there; each instant is named by the innermost span open at
    it."""
    events = [("cudaLaunchKernel", 10.0, 12.0),
              ("cudaDeviceSynchronize", 20.0, 30.0),
              ("cudaStreamSynchronize", 52.0, 66.0),
              ("cudaDeviceSynchronize", 90.0, 100.0),
              ("cudaDeviceSynchronize", 110.0, 111.0)]
    clock = obs.trace_clock(events, 5_000_000)
    assert obs.trace_clock(events[:4], 5_000_000, after=0)(0) == clock(0)
    spans = obs.on_trace_clock(
        [("train.step", -1, 4_910_000, 4_980_000),
         ("train.backward", 0, 4_920_000, 4_950_000),
         ("train.guard", 0, 4_950_000, 4_970_000)], clock)
    assert [s[2:] for s in spans] == [(10.0, 80.0), (20.0, 50.0),
                                      (50.0, 70.0)]
    labels = {t: obs.span_path_at(spans, t)
              for t in (5, 10, 49.9, 52, 75, 80)}
    assert labels == {5: None, 10: "train.step",
                      49.9: "train.step/train.backward",
                      52: "train.step/train.guard", 75: "train.step",
                      80: None}
    with pytest.raises(ValueError, match="cudaDeviceSynchronize"):
        obs.trace_clock(events[:2], 0)


def test_profile_trace_writes_the_spans_on_its_clock(tmp_path):
    state, step = _step("codec")
    with obs.profile_trace(str(tmp_path), device="cpu"):
        for k in range(2):
            step(_x(k))
    trace = json.loads((tmp_path / "trace.json").read_text())
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    steps = [e for e in spans if e["name"] == "train.step"]
    assert len(steps) == 2
    assert len(spans) == 2 * (1 + len(STEP_CHILDREN["codec"]))
    assert trace["programCounters"] == {}
    # every span lies in the profiled window, and the step's first
    # convolution inside its forward span
    t0 = min(e["ts"] for e in ops)
    t1 = max(e["ts"] + e["dur"] for e in ops)
    assert all(t0 <= e["ts"] <= e["ts"] + e["dur"] <= t1 for e in spans)
    fwd = next(e for e in spans if e["name"] == "train.forward")
    conv = next(e for e in ops if e["name"] == "aten::conv2d")
    assert fwd["ts"] <= conv["ts"] <= fwd["ts"] + fwd["dur"]

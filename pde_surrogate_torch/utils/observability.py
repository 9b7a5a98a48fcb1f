"""Step timing, profiling, program spans, anomaly detection and structured
logging.

Counterpart of pde_surrogate_tpu/utils/observability.py:

* ``StepTimer`` — steps/s and samples/s, fenced on the card with
  ``torch.cuda.synchronize`` so that asynchronous launches do not fake the
  numbers;
* ``profile_trace`` — a ``torch.profiler`` window (CPU, and CUDA on a
  card) written as a Chrome trace, ``trace.json``, with the program's spans
  on the trace's clock;
* ``span`` / ``count`` / ``recording`` — host-side spans and counters
  inside the program's steps, recorded only inside a ``recording()``
  block (off, a span is one shared null object and reads no clock);
  ``trace_clock`` / ``on_trace_clock`` / ``span_path_at`` put them on a
  profiler trace's clock and name what the program was doing at a time;
* ``debug_nans`` — scoped ``torch.autograd.set_detect_anomaly``;
* ``JsonlLogger`` — one JSON object per line.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["StepTimer", "profile_trace", "span", "count", "recording",
           "Recording", "summarize", "trace_clock", "on_trace_clock",
           "span_path_at", "debug_nans", "JsonlLogger"]


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


class _NullSpan:
    """What ``span`` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NULL_SPAN = _NullSpan()


class Recording:
    """What one ``recording()`` block saw.  ``spans``: a tuple (name,
    parent, start_ns, end_ns) per span in the order they opened, ``parent``
    the index of the enclosing span (-1 for a root), times on
    ``time.perf_counter_ns``'s clock; ``counters``: name -> count."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.open = -1          # index of the innermost open span


class _Span:
    __slots__ = ("rec", "name", "index", "parent", "start")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        self.parent = rec.open
        self.index = rec.open = len(rec.spans)
        rec.spans.append(None)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec.spans[self.index] = (self.name, self.parent, self.start, end)
        rec.open = self.parent
        return None


_active: Recording | None = None


def span(name: str):
    """A context manager that records a span ``name`` inside the active
    ``recording()`` block, nested in the span open around it; outside one,
    the shared ``NULL_SPAN`` (no allocation, no clock read)."""
    rec = _active
    if rec is None:
        return NULL_SPAN
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the active ``recording()``
    block (nothing outside one).  ``sync.<site>`` counts the places where
    the host waits on the device."""
    rec = _active
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block into the ``Recording``
    it yields (in memory; nothing is written).  A nested block records
    apart from the outer one, which resumes after it."""
    global _active
    outer, rec = _active, Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = outer


def summarize(spans: list) -> dict:
    """name -> {"count", "incl_ns", "self_ns"}: how often a span opened,
    its time, and its time less what its child spans cover."""
    covered = [0] * len(spans)
    for _, parent, a, b in spans:
        if parent >= 0:
            covered[parent] += b - a
    out: dict = {}
    for (name, _, a, b), kids in zip(spans, covered):
        s = out.setdefault(name, {"count": 0, "incl_ns": 0, "self_ns": 0})
        s["count"] += 1
        s["incl_ns"] += b - a
        s["self_ns"] += b - a - kids
    return out


def trace_clock(intervals, host_ns: int,
                anchor: str = "cudaDeviceSynchronize", after: int = 1):
    """A map from ``time.perf_counter_ns`` to a profiler trace's clock
    (microseconds).  ``intervals``: the trace's (name, start_us, end_us);
    ``host_ns``: the host's clock read just after the window's final
    ``anchor`` call returned, which is matched to that call's end in the
    trace: the last ``anchor`` but the ``after`` made once the clock was
    read.  On a card the profiler makes one: stopping, torch's profiler
    synchronises the device it traced once more
    (``torch.autograd.profiler.profile.__exit__``)."""
    ends = sorted(b for name, _, b in intervals if name == anchor)
    if len(ends) <= after:
        raise ValueError(f"no {anchor} before the profiler's own {after} "
                         f"in the trace")
    offset = ends[-1 - after] - host_ns / 1e3
    return lambda ns: ns / 1e3 + offset


def on_trace_clock(spans: list, clock) -> list:
    """``spans`` (name, parent, start_ns, end_ns) as (name, parent,
    start_us, end_us) on the clock ``trace_clock`` gave."""
    return [(name, parent, clock(a), clock(b))
            for name, parent, a, b in spans]


def span_path_at(spans: list, t: float) -> str | None:
    """The path from its root (``train.step/train.guard``) of the
    innermost span open at ``t`` (on the spans' clock), or None."""
    hit = None
    for i, (_, _, a, b) in enumerate(spans):
        if a <= t < b:
            hit = i         # spans open in order: the last is innermost
    names = []
    while hit is not None and hit >= 0:
        names.append(spans[hit][0])
        hit = spans[hit][1]
    return "/".join(reversed(names)) or None


CLOCK_ANNOTATION = "profile_trace.clock"
SPAN_TID = 0                    # the trace's row of the program's spans


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device=None):
    """``torch.profiler`` around a code region, written to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto).  On a CUDA
    ``device`` it records the card's kernels too, and raises if it saw
    none.  The program's spans of the region are recorded and written
    into the trace on its clock (the row "program spans"; the counters
    under ``programCounters``): on a card the host's clock after the
    region's final ``cudaDeviceSynchronize`` is matched to that call's end
    in the trace, on the CPU after an annotation that closes the
    region."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording() as rec:
        yield
        if on_card:
            torch.cuda.synchronize(device)
            anchor, after = "cudaDeviceSynchronize", 1
        else:
            with record_function(CLOCK_ANNOTATION):
                pass
            anchor, after = CLOCK_ANNOTATION, 0
        host_ns = time.perf_counter_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if on_card and not any(e.device_type == torch.autograd.DeviceType.CUDA
                           for e in prof.events()):
        raise RuntimeError("the profiler recorded no CUDA activity")
    _write_spans(path, rec, host_ns, anchor, after)


def _write_spans(path: str, rec: Recording, host_ns: int, anchor: str,
                 after: int):
    """Add ``rec``'s spans and counters to the Chrome trace at ``path``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    clock = trace_clock([(e.get("name"), e["ts"], e["ts"] + e.get("dur", 0))
                         for e in events if e.get("ph") == "X"],
                        host_ns, anchor, after)
    pid = os.getpid()
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TID, "args": {"name": "program spans"}})
    events += [{"ph": "X", "cat": "program_span", "name": name, "pid": pid,
                "tid": SPAN_TID, "ts": a, "dur": b - a}
               for name, _, a, b in on_trace_clock(rec.spans, clock)]
    trace["programCounters"] = rec.counters
    with open(path, "w") as f:
        json.dump(trace, f)


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

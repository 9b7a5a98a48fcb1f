"""The profiler's trace of a short steady sub-window, reduced to what the
per-layer metrics and the ``breakdown`` read: the device's busy time (the
union of its operations' intervals), kernels and blocking syncs per unit
of work, the device operations that took most time, and the longest idle
gaps named by what the host was doing.

The busy, idle and kernel-count arithmetic follows ``chip_smoke.py``'s
``profile_call``: device events of the profiler, its annotation ranges
left out.  Every interval is in microseconds of the profiler's clock; the
wall-clock start of the trace is kept, so that the traces of processes that
share one card can be merged.
"""

from __future__ import annotations

import torch

# CUDA runtime calls that block the host until the device catches up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")
TOP = 10


def _is_device_op(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.name)


def union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


WARM_UNITS = 1          # units traced and dropped before the recorded ones


def profile(run_unit, units: int) -> dict:
    """Profile ``units`` calls of ``run_unit()`` and a final synchronise,
    after ``WARM_UNITS`` calls that the profiler warms up on and drops (its
    first launches are slow).  Only the device's activity and the host's
    CUDA runtime calls are traced: recording every host-side operator as
    well slows a host-paced step by a third or more.  Returns
    ``reduce``'s summary."""
    from torch.profiler import ProfilerActivity, schedule
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=WARM_UNITS, active=units,
                              repeat=1)) as prof:
        for i in range(WARM_UNITS + units):
            run_unit()
            if i in (WARM_UNITS - 1, WARM_UNITS + units - 1):
                torch.cuda.synchronize()
            prof.step()
    out = reduce(prof.events(), units)
    out["start_us"] = prof.profiler.kineto_results.trace_start_ns() / 1e3
    return out


def reduce(events, units: int) -> dict:
    """The traced sub-window, from the host's first CUDA call to the end
    of the final synchronise: window_s, busy_s, kernels, blocking syncs
    (the final one left out), units, the device operations that took most
    time, the longest idle gaps, and the device intervals (``ops``, for
    merging the traces of processes that share the card)."""
    calls = sorted((e for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    final = [e for e in calls if e.name == "cudaDeviceSynchronize"][-1]
    w0, w1 = calls[0].time_range.start, final.time_range.end
    ops = [e for e in events if _is_device_op(e)
           and e.time_range.end > w0 and e.time_range.start < w1]
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in ops]
    per_name: dict = {}
    for e in ops:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {"window_s": (w1 - w0) / 1e6, "w0_us": w0, "w1_us": w1,
            "busy_s": sum(b - a for a, b in union(spans)) / 1e6,
            "kernels": sum(1 for e in ops
                           if not e.name.startswith(("Memcpy", "Memset"))),
            "syncs": sum(1 for e in calls if e.name in BLOCKING
                         and e.time_range.start < final.time_range.start),
            "units": units, "ops": spans,
            "device_ops": sorted(([n, t / 1e6] for n, t in per_name.items()),
                                 key=lambda x: -x[1])[:TOP],
            "gaps": idle_gaps(union(spans), w0, w1, calls)}


def idle_gaps(busy: list, w0: float, w1: float, calls: list) -> list:
    """The ``TOP`` longest stretches of the window with no device
    operation, each named by what the host was doing as it began: the
    CUDA runtime call then open, or the host's own work after the last
    call that had ended."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:TOP]
    out = []
    for length, at in gaps:
        open_ = [e for e in calls if e.time_range.start <= at < e.time_range.end]
        done = [e for e in calls if e.time_range.end <= at]
        name = (f"in {open_[-1].name}" if open_ else
                f"host after {done[-1].name}" if done else "host")
        out.append([name, length / 1e6])
    return out
def merge(traces: list) -> dict:
    """One reduced trace from those of processes that shared the card:
    their device intervals on the common wall clock, over the span from
    the earliest window's start to the latest window's end."""
    spans, starts, ends = [], [], []
    for t in traces:
        off = t["start_us"]
        spans += [(a + off, b + off) for a, b in t["ops"]]
        starts.append(t["w0_us"] + off)
        ends.append(t["w1_us"] + off)
    w0, w1 = min(starts), max(ends)
    names: dict = {}
    for t in traces:
        for n, s in t["device_ops"]:
            names[n] = names.get(n, 0.0) + s
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in union(spans)) / 1e6,
            "kernels": sum(t["kernels"] for t in traces),
            "syncs": sum(t["syncs"] for t in traces),
            "units": sum(t["units"] for t in traces),
            "device_ops": sorted(([n, s] for n, s in names.items()),
                                 key=lambda x: -x[1])[:TOP],
            "gaps": idle_gaps(union(spans), w0, w1, [])}

"""The program's spans in one cell, on the card: the host's time per unit of
work split by span, what recording costs, and the device's idle time of a
traced sub-window named by the program span open in it.

    python3 portbench/spans.py --workload <cell> --seed <n>
        [--steps 200] [--pairs 3] [--units <profile units>] [--out <file>]

The cell's program is built as its job builds it (family, fields and
weights from the seed) and warmed up; nothing is checked against the
reference.  Then:

1. ``pairs`` pairs of blocks of ``steps`` units, one with recording off
   and one on, the order alternating from pair to pair: the host's ms per
   unit inside the program's call, timed as ``host_ms_per_step.train``
   times it (a unit's batch fetch left out), and the process's CPU ms per
   unit (all its threads), which a busy host moves less;
2. from the recorded blocks: each span name's count, inclusive and self
   ms per unit, the counters per unit, and how much of the mean unit the
   root span (``train.step``) and its children cover;
3. on a card, ``units`` more units profiled as ``lib.trace.profile``
   profiles them, with recording on: ``lib.trace.reduce``'s numbers, the
   spans put on the trace's clock at the final synchronise
   (``observability.trace_clock``), the idle seconds under each span path,
   the share of idle time inside a span, the ten longest gaps with
   ``lib.trace``'s label and the span path at their start, the idle
   seconds under each such label (every gap), the longest gaps that begin
   outside every span, and each blocking sync call with its span path and
   how far it lies outside that span.

Besides, the host's ns per span with recording off and on, from a loop of
empty spans.  Prints one JSON line and, with ``--out``, writes it there.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WARM_UNITS = 5


def _unit(cell: dict):
    """The cell's program as a ``unit()`` -> host seconds inside the
    program's call (training: a step, its batch fetch left out;
    propagation: a call on the next slice of the pool)."""
    from portbench.jobs import common
    from portbench.jobs.propagate import CALL_STREAM
    from portbench.reference.seeding import seed_of
    fam = common.family(cell)
    cfg, traffic, device = cell["config"], cell["traffic"], cell["device"]
    if traffic["job"] == "train":
        x = common.fields(cell, traffic["fields"])
        prog = fam.Train(cfg, traffic, cell["seed"], x, device)
        stream = itertools.chain.from_iterable(prog.data.batches(e)
                                               for e in itertools.count(1))

        def unit():
            batch = next(stream)
            a = time.perf_counter()
            prog.step(*batch)
            return time.perf_counter() - a
        return unit
    pool = common.fields(cell, traffic["pool"])[:, None]
    prog = fam.Propagate(cfg, traffic, cell["seed"], device)
    size, calls = traffic["slice"], itertools.count()

    def unit():
        k = next(calls)
        a = (k % (len(pool) // size)) * size
        tic = time.perf_counter()
        prog.call(pool[a:a + size], seed_of(cell["seed"], CALL_STREAM, k))
        return time.perf_counter() - tic
    return unit


def cost_and_split(unit, steps: int, pairs: int, sync) -> dict:
    """Alternating blocks off and on; the on blocks' spans summed."""
    from pde_surrogate_torch.utils import observability as obs
    blocks, summary, counters, host_on = [], {}, {}, []
    for p in range(pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            sync()
            cpu = time.process_time()
            if on:
                with obs.recording() as rec:
                    host = [unit() for _ in range(steps)]
                host_on += host
                for name, s in obs.summarize(rec.spans).items():
                    t = summary.setdefault(name, dict.fromkeys(s, 0))
                    for k, v in s.items():
                        t[k] += v
                for k, v in rec.counters.items():
                    counters[k] = counters.get(k, 0) + v
            else:
                host = [unit() for _ in range(steps)]
            cpu = 1e3 * (time.process_time() - cpu) / steps
            blocks.append({"on": on, "host_ms": 1e3 * statistics.fmean(host),
                           "cpu_ms": cpu})
    ratios, cpu_ratios = [], []
    for p in range(pairs):
        off, on = sorted(blocks[2 * p:2 * p + 2], key=lambda b: b["on"])
        ratios.append(on["host_ms"] / off["host_ms"] - 1.0)
        cpu_ratios.append(on["cpu_ms"] / off["cpu_ms"] - 1.0)
    n = len(host_on)
    per_unit = {name: {"count": s["count"] / n,
                       "incl_ms": s["incl_ns"] / 1e6 / n,
                       "self_ms": s["self_ns"] / 1e6 / n}
                for name, s in sorted(summary.items())}
    root = next((k for k in ("train.step", "uq.propagate") if k in summary),
                None)
    host_ms = 1e3 * statistics.fmean(host_on)
    out = {"blocks": blocks, "cost_pct": [100 * r for r in ratios],
           "cost_pct_median": 100 * statistics.median(ratios),
           "cpu_cost_pct": [100 * r for r in cpu_ratios],
           "cpu_cost_pct_median": 100 * statistics.median(cpu_ratios),
           "host_ms_per_unit": host_ms, "spans_per_unit": per_unit,
           "counters_per_unit": {k: v / n for k, v in counters.items()}}
    if root:
        incl = summary[root]["incl_ns"]
        out["root"] = root
        out["root_over_host"] = incl / 1e6 / n / host_ms
        out["children_cover"] = 1.0 - summary[root]["self_ns"] / incl
    return out


def ns_per_span(n: int = 200_000) -> dict:
    """The host's ns per empty ``with span(...)`` block, off and on (the
    median of five loops of ``n``)."""
    from pde_surrogate_torch.utils import observability as obs

    def loop():
        tic = time.perf_counter_ns()
        for _ in range(n):
            with obs.span("train.step"):
                pass
        return (time.perf_counter_ns() - tic) / n

    off = statistics.median(loop() for _ in range(5))
    on = []
    for _ in range(5):
        with obs.recording():
            on.append(loop())
    return {"off": off, "on": statistics.median(on)}


def gaps_of(busy: list, w0: float, w1: float) -> list:
    """Every stretch (start, end) of [w0, w1] outside the merged device
    intervals ``busy``, in order."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(gaps: list, spans: list) -> dict:
    """Idle microseconds under each innermost span path ("-": none)."""
    from pde_surrogate_torch.utils.observability import span_path_at
    cuts = sorted({t for _, _, a, b in spans for t in (a, b)})
    paths = [span_path_at(spans, (a + b) / 2) for a, b in zip(cuts, cuts[1:])]
    out: dict = {}
    for g0, g1 in gaps:
        i, t = bisect.bisect_right(cuts, g0) - 1, g0
        while t < g1:
            end = min(g1, cuts[i + 1]) if i + 1 < len(cuts) else g1
            path = (paths[i] if 0 <= i < len(paths) else None) or "-"
            out[path] = out.get(path, 0.0) + end - t
            t, i = end, i + 1
    return out


def gap_names(gaps: list, calls: list) -> list:
    """``lib.trace.idle_gaps``'s name of each gap (what the host was doing
    as it began), for every gap: ``calls`` sorted by start."""
    starts = [e.time_range.start for e in calls]
    reach, far = [], float("-inf")      # the latest end of calls[:i + 1]
    for e in calls:
        far = max(far, e.time_range.end)
        reach.append(far)
    out = []
    for at, _ in gaps:
        i = bisect.bisect_right(starts, at) - 1
        name, j = None, i
        while j >= 0 and reach[j] > at:     # a call still open at ``at``
            if calls[j].time_range.end > at:
                name = f"in {calls[j].name}"
                break
            j -= 1
        if name is None:
            done = [e for e in calls[max(i - 64, 0):i + 1]
                    if e.time_range.end <= at]
            name = (f"host after {done[-1].name}" if done else "host")
        out.append(name)
    return out


def label(events, reduced: dict, rec, host_ns: int) -> dict:
    """The traced sub-window's idle time and blocking syncs by span."""
    import torch
    from portbench.lib import trace
    from pde_surrogate_torch.utils import observability as obs
    calls = sorted((e for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    clock = obs.trace_clock([(e.name, e.time_range.start, e.time_range.end)
                             for e in calls], host_ns)
    spans = obs.on_trace_clock(rec.spans, clock)
    w0, w1 = reduced["w0_us"], reduced["w1_us"]
    busy = trace.union(reduced["ops"])
    gaps = gaps_of(busy, w0, w1)
    idle = sum(b - a for a, b in gaps)
    by_span = idle_by_span(gaps, spans)
    longest = sorted(((b - a, a) for a, b in gaps), reverse=True)[:trace.TOP]
    named = trace.idle_gaps(busy, w0, w1, calls)
    top = [[f"{name} @ {obs.span_path_at(spans, at) or '-'}", length / 1e6]
           for (name, length), (_, at) in zip(named, longest)]
    by_label: dict = {}
    unspanned = []
    for (a, b), name in zip(gaps, gap_names(gaps, calls)):
        path = obs.span_path_at(spans, a)
        key = f"{name} @ {path or '-'}"
        by_label[key] = by_label.get(key, 0.0) + (b - a) / 1e6
        if path is None:
            unspanned.append([name, a - w0, (b - a) / 1e6])
    final = [e for e in calls if e.name == "cudaDeviceSynchronize"][-1]
    syncs = []
    for e in calls:
        if (e.name in trace.BLOCKING
                and e.time_range.start < final.time_range.start):
            a, b = e.time_range.start, e.time_range.end
            path = obs.span_path_at(spans, a)
            inner = max((s for s in spans if s[2] <= a < s[3]),
                        key=lambda s: s[2], default=None)
            outside = (max(0.0, inner[2] - a, b - inner[3]) if inner
                       else None)
            syncs.append({"call": e.name, "at_us": a - w0,
                          "ms": (b - a) / 1e3, "span": path or "-",
                          "outside_us": outside,
                          "margins_us": [a - inner[2], inner[3] - b]
                          if inner else None})
    return {"idle_s": idle / 1e6,
            "idle_in_span_pct": 100.0 * (1.0 - by_span.get("-", 0.0) / idle)
            if idle else None,
            "idle_s_by_span": {k: v / 1e6 for k, v in
                               sorted(by_span.items(), key=lambda x: -x[1])},
            "idle_gaps": top, "sync_calls": syncs,
            "idle_s_by_label": dict(sorted(by_label.items(),
                                           key=lambda x: -x[1])[:20]),
            "unspanned": sorted(unspanned, key=lambda g: -g[2])[:10],
            "counters": rec.counters,
            "spans_per_unit": {k: {"count": v["count"] / reduced["units"],
                                   "incl_ms": v["incl_ns"] / 1e6
                                   / reduced["units"],
                                   "self_ms": v["self_ns"] / 1e6
                                   / reduced["units"]}
                               for k, v in obs.summarize(rec.spans).items()}}


def traced(unit, units: int) -> dict:
    """``units`` units profiled as ``lib.trace.profile`` profiles them
    (one warm unit traced and dropped, then the units and a final
    synchronise), the units' spans recorded."""
    import torch
    from torch.profiler import ProfilerActivity, schedule
    from portbench.lib import trace
    from pde_surrogate_torch.utils import observability as obs
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=trace.WARM_UNITS,
                              active=units, repeat=1)) as prof:
        for _ in range(trace.WARM_UNITS):
            unit()
            torch.cuda.synchronize()
            prof.step()
        with obs.recording() as rec:
            for i in range(units):
                unit()
                if i == units - 1:
                    torch.cuda.synchronize()
                    host_ns = time.perf_counter_ns()
                prof.step()
    events = prof.events()
    reduced = trace.reduce(events, units)
    out = {k: reduced[k] for k in ("window_s", "busy_s", "kernels", "syncs",
                                   "units", "gaps")}
    out["idle_pct"] = 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])
    out.update(label(events, reduced, rec, host_ns))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--units", type=int, default=None,
                   help="profiled units (default: the traffic's)")
    p.add_argument("--root", default=ROOT)
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench.harness import load_cell
    cell = load_cell(args.root, args.workload)
    import torch
    device = args.device or "cuda"
    from pde_surrogate_torch.utils.config import select_device
    select_device(device)
    cell.update(seed=args.seed, device=device)
    unit = _unit(cell)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for _ in range(WARM_UNITS):
        unit()
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name() if on_card else "cpu",
           **cost_and_split(unit, args.steps, args.pairs, sync),
           "ns_per_span": ns_per_span()}
    if on_card:
        out["trace"] = traced(unit, args.units or
                              cell["traffic"]["profile_units"])
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())

"""The benchmark's driver: finds the cell named on the command line in
``BENCHMARK.json``, its configuration, traffic and limits files by name,
runs the traffic's job on the program, reads each metric with its own
reader (``metrics/<name>.py``) and prints the result as the last line of
standard output, with every number compared beside its limit.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

from .lib.guard import forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = os.path.join(ROOT, "portbench", "run.py")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one process of a cell that several processes run, started by the
    # cell's first process with its checkout and device
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    bench = _load_json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"name": name, "chips": entry["chips"], "bench": bench,
            "config": _load_json(root, conf["file"]),
            "traffic": _load_json(root, "portbench", "traffic",
                                  f"{entry['traffic']}.json"),
            "limits": _load_json(root, "portbench", "limits",
                                 f"{name}.json")}


def metric_names(cell: dict, trace: int) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1): each that lists the cell, or lists no cells."""
    group = cell["bench"]["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(root: str, name: str, record: dict):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def device_info(record: dict, device: str, trace: int) -> dict:
    import torch
    on_card = device.startswith("cuda")
    out = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    if trace:
        out["busy_s"] = record["trace"]["busy_s"]
        out["window_s"] = record["trace"]["window_s"]
    return out


def result(cell: dict, record: dict, root: str, device: str,
           trace: int) -> dict:
    metrics = {}
    for m in metric_names(cell, trace):
        value = read_metric(root, m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell["limits"][k]}
              for k, v in record["checks"].items()}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device_info(record, device, trace)}
    if trace:
        out["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                            "idle_gaps": record["trace"]["gaps"]}
    out["checks"] = checks
    return out


def run_cell(argv=None, root: str = ROOT, device: str | None = None,
             t_start: float = 0.0) -> int:
    """Run a cell and print its result; ``device`` None means the card,
    whose presence (and the cell's count of cards) is checked first."""
    args = parse(argv)
    if args.rank is not None:
        root, device = args.root, args.device
    cell = load_cell(root, args.workload)
    import torch
    cell["phases"] = [("torch", time.perf_counter() - t_start)]
    if device is None:
        if not torch.cuda.is_available() or (torch.cuda.device_count()
                                             < cell["chips"]):
            print(f"portbench: the cell needs {cell['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        cell["phases"].append(("cuda driver", time.perf_counter() - t_start))
    from pde_surrogate_torch.utils.config import select_device
    select_device(device)
    cell["phases"].append(("select_device", time.perf_counter() - t_start))
    cell.update(seed=args.seed, seconds=args.seconds, trace=args.trace,
                device=device, t_start=t_start, entry=ENTRY, root=root)
    job = importlib.import_module(
        f"portbench.jobs.{cell['traffic']['job']}")
    if args.rank is not None:
        job.child(cell)
        return 0
    record = job.run(cell)
    found = sorted(set(forbidden_loaded()) | set(record.get("forbidden", [])))
    if found:
        print(f"portbench: modules of the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    out = result(cell, record, root, device, args.trace)
    print("portbench: set-up phases end at " + ", ".join(
        f"{n} {t:.3f} s" for n, t in cell.get("phases", [])), file=sys.stderr)
    print(f"portbench: set-up {record['setup_s']:.3f} s, window "
          f"{record['window_s']:.3f} s, {record['units']} units, reference "
          f"{record.get('reference_s', 0.0):.3f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

"""A copy of the benchmark's files at tiny sizes, for the CPU tests: the
same cells, metrics and code, with small networks, few fields and limits
for a float32 program on the CPU against the float64 reference."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

from portbench.harness import ROOT, run_cell

if os.environ.get("PYTEST_XDIST_WORKER"):
    import torch
    torch.set_num_threads(1)    # several workers share the machine's cores

TINY_CONFIGS = {
    "denseed": dict(imsize=16, blocks=[2, 2, 2], growth_rate=4,
                    init_features=8),
    "cglow": dict(imsize=16, enc_blocks=[2, 2, 2], flow_blocks=[2, 2, 2]),
}
TINY_TRAFFIC = {
    "train": dict(fields=32, batch=8, kle=16, profile_units=2),
    "propagate": dict(pool=40, slice=20, chunk=10, draws=4, kle=16,
                      warm_fields=20, profile_units=1),
}
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 5e-3, "change_gap": 0.25,
               "buffer_gap": 1e-4, "moment_gap": 1e-4}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def make_tiny_root(dest: str) -> str:
    """``dest`` holding BENCHMARK.json and portbench's data files and
    metric readers, cut to tiny sizes; returns ``dest``."""
    bench = _load(ROOT, "BENCHMARK.json")
    pb = os.path.join(dest, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, sub), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    os.path.join(pb, "metrics"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        cfg = _load(ROOT, c["file"])
        cfg.update(TINY_CONFIGS[cfg["family"]])
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        tr = _load(ROOT, "portbench", "traffic", f"{w['traffic']}.json")
        tr.update(TINY_TRAFFIC[tr["job"]])
        if tr.get("processes", 1) > 1:
            tr.update(processes=2, threads=1)
        with open(os.path.join(pb, "traffic", f"{w['traffic']}.json"),
                  "w") as f:
            json.dump(tr, f)
        limits = _load(ROOT, "portbench", "limits", f"{w['name']}.json")
        with open(os.path.join(pb, "limits", f"{w['name']}.json"), "w") as f:
            json.dump({k: TINY_LIMITS[k] for k in limits}, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


def run_tiny(root: str, workload: str, trace: int = 0, seed: int = 2 ** 31 + 5,
             seconds: float = 0.5, capsys=None) -> tuple[int, dict | None]:
    """Run a cell on the CPU; (exit code, its result line or None)."""
    rc = run_cell(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu", t_start=time.perf_counter())
    if capsys is None:
        return rc, None
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{")
                else None)


@pytest.fixture
def tiny_run(tiny_root, capsys):
    def run(workload, trace=0, root=None, **kw):
        return run_tiny(root or tiny_root, workload, trace, capsys=capsys,
                        **kw)
    return run


@pytest.fixture
def no_forbidden(monkeypatch):
    """Run with the test process's own imports of the JAX package (other
    test files import it) hidden from the run-time check."""
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "pde_surrogate_tpu"):
            monkeypatch.delitem(sys.modules, name)

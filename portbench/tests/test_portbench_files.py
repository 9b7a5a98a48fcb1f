"""The benchmark is driven by data: every configuration, traffic mix,
limit and metric is a file found by name, and a cell or a metric is added
by adding files and BENCHMARK.json entries alone."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.harness import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[g]]
    assert all(NAME.match(n) for n in names)
    for g in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[g]}) == len(BENCH[g])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_has_its_file():
    pb = os.path.join(ROOT, "portbench")
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(pb, "families",
                                           f"{cfg['family']}.py"))
    for w in BENCH["workloads"]:
        tr = json.load(open(os.path.join(pb, "traffic",
                                         f"{w['traffic']}.json")))
        assert os.path.isfile(os.path.join(pb, "jobs", f"{tr['job']}.py"))
        assert os.path.isfile(os.path.join(pb, "limits",
                                           f"{w['name']}.json"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(pb, "metrics",
                                           f"{m['name']}.py"))


def test_new_cell_and_metric_from_new_files_alone(tiny_root, tiny_run,
                                                  no_forbidden, tmp_path):
    """A cell at another batch and a metric of its own, added as files and
    BENCHMARK.json entries: the harness runs it, with no file of the
    benchmark edited."""
    import shutil
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    pb = os.path.join(root, "portbench")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, files in os.walk(pb) for p in files}
    with open(os.path.join(pb, "traffic", "sobel-16-b4.json"), "w") as f:
        json.dump({"job": "train", "fields": 16, "batch": 4, "kle": 16,
                   "processes": 1, "profile_units": 2}, f)
    with open(os.path.join(pb, "limits", "codec-sobel-train-b4.json"),
              "w") as f:
        json.dump({"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2,
                   "buffer_gap": 1e-4}, f)
    with open(os.path.join(pb, "metrics", "steps_in_window.py"), "w") as f:
        f.write("def read(record):\n    return float(record['units'])\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "codec-sobel-train-b4",
                               "config": "denseed-686-k16-64",
                               "traffic": "sobel-16-b4", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "steps_in_window", "unit": "steps",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["codec-sobel-train-b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, out = tiny_run("codec-sobel-train-b4", root=root)
    assert rc == 0 and out["correct"]
    assert set(out["metrics"]) == {"steps_in_window", "setup_s"}
    assert out["metrics"]["steps_in_window"]["value"] == out["attempted"]
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, files in os.walk(pb) for p in files
             if p in before}
    assert after == before


@pytest.mark.parametrize("argv", [[], ["--workload", "codec-sobel-train"]])
def test_arguments_required(argv):
    from portbench.harness import parse
    with pytest.raises(SystemExit):
        parse(argv)

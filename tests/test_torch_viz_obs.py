"""Port parity: the figures (viz/plot.py), observability and the model
summary.

Every public function of the JAX package's viz/plot.py gets the same numpy
inputs in both packages, each writing into its own directory: the same
file names must appear, each .png must decode to the same pixels and each
.txt must be byte-equal (a .pdf or .gif only has to exist).  Without
matplotlib (hidden from the import system) the port prints a note naming
it and still writes the .txt files.  The observability helpers are held to
the JAX module's tests (tests/test_viz_obs.py); ``summarize`` to the JAX
DenseED's parameter count and block output shapes.
"""

import json
import os
import sys

import jax
import matplotlib.image
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.utils.observability import (JsonlLogger, StepTimer,
                                                     debug_nans,
                                                     profile_trace)
from pde_surrogate_torch.utils.summary import summarize
from pde_surrogate_torch.viz import plot as tplot
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.models.codec import module_size as j_module_size
from pde_surrogate_tpu.viz import plot as jplot

torch.set_num_threads(1)


def _fields(seed=0, shape=(3, 8, 8)):
    rng = np.random.default_rng(seed)
    t = rng.random(shape).astype(np.float32)
    return t, t + 0.05 * rng.random(shape).astype(np.float32)


def _calls(name, d):
    """The calls of one public function (the output directory ``d``)."""
    t, p = _fields()
    var = np.abs(p) * 0.01
    logger = {"loss": [3.0, 2.0, 1.0],
              "nrmse": [[0.5, 0.4, 0.3], [0.4, 0.3, 0.2]]}
    frames = [_fields(i)[1] for i in range(2)]
    return {
        "plot_prediction_det": [((d, np.moveaxis(t, 0, -1), p, 3, 1), {})],
        "plot_prediction_det_animate": [((d, t, p, 2, 0, 7), {})],
        "plot_prediction_bayes2": [((d, t, p, var, 2, 0), {})],
        "plot_MC2": [((d, t, p, var, False, 128), {"manual_scale": True})],
        "plot_UP": [((d, t, p, True), {})],
        "save_stats": [((d, logger, "loss", "nrmse"), {})],
        "save_samples": [((d, np.random.default_rng(1).random(
            (4, 2, 8, 8)).astype(np.float32), 5, 0, "samples"),
            {"nrow": 2})],
        "plot_row": [(([t[0], p[0]], d, "row"), {"plot_fn": "contourf",
                                                 "same_range": True})],
        "panel_grid": [((np.stack([t, p]), ["a", "b"], ["x", "y", "z"],
                         os.path.join(d, "grid.png")), {})],
        "imagegrid_pairs": [(([(t[c], p[c]) for c in range(3)],
                              [(t[c] - p[c], var[c]) for c in range(3)],
                              os.path.join(d, "pairs.png")), {})],
        "plot_prediction_bayes": [((d, t, p, var, 4, 2), {})],
        "plot_MC": [((d, t, p, var, True, 128), {"plot_fn": "imshow"})],
        "assemble_gif": [
            *[((d, t, f, i, 0, i), {}) for i, f in enumerate(frames)],
            ((d,), {})],
    }[name]


@pytest.mark.parametrize("name", jplot.__all__)
def test_figures_match_jax(tmp_path, name):
    for pkg, sub in ((jplot, "j"), (tplot, "t")):
        d = str(tmp_path / sub)
        os.makedirs(d)
        for args, kw in _calls(name, d):
            # the gif's frames come from the animate figure
            fn = (pkg.plot_prediction_det_animate
                  if name == "assemble_gif" and len(args) > 1
                  else getattr(pkg, name))
            fn(*args, **kw)
    j_files = sorted(os.listdir(tmp_path / "j"))
    assert j_files and sorted(os.listdir(tmp_path / "t")) == j_files
    for f in j_files:
        a, b = tmp_path / "j" / f, tmp_path / "t" / f
        if f.endswith(".png"):
            np.testing.assert_array_equal(matplotlib.image.imread(b),
                                          matplotlib.image.imread(a),
                                          err_msg=f)
        elif f.endswith(".txt"):
            assert b.read_bytes() == a.read_bytes(), f
        else:
            assert f.endswith((".pdf", ".gif")) and b.stat().st_size > 0, f


def test_figures_take_cpu_tensors(tmp_path):
    """CHW tensors (with a gradient) draw what their numpy arrays draw."""
    t, p = _fields()
    tplot.plot_prediction_det(str(tmp_path / "n"), t, p, 1, 0)
    tplot.plot_prediction_det(str(tmp_path / "t"), torch.from_numpy(t),
                              torch.from_numpy(p).requires_grad_(True), 1, 0)
    np.testing.assert_array_equal(
        matplotlib.image.imread(tmp_path / "t" / "pred_epoch1_0.png"),
        matplotlib.image.imread(tmp_path / "n" / "pred_epoch1_0.png"))


def test_without_matplotlib_notes_and_writes_numbers(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    t, p = _fields()
    tplot.save_stats(str(tmp_path), {"loss": [3.0, 2.0]}, "loss")
    tplot.plot_prediction_det(str(tmp_path), t, p, 1, 0)
    assert tplot.assemble_gif(str(tmp_path)) is None
    assert sorted(os.listdir(tmp_path)) == ["loss.txt"]
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "loss.txt"), [3, 2])
    out = capsys.readouterr().out
    assert "matplotlib is not installed: the loss curves (.pdf)" in out
    assert "matplotlib is not installed: pred_epoch1_0.png" in out


def test_step_timer():
    t = StepTimer(batch_size=4)
    t.start()
    for _ in range(5):
        t.step()
    r = t.result(fence=torch.ones(()))
    assert set(r) == {"seconds", "steps", "steps_per_sec", "samples_per_sec"}
    assert r["steps"] == 5 and r["samples_per_sec"] > 0
    np.testing.assert_allclose(r["samples_per_sec"], 4 * r["steps_per_sec"])


def test_jsonl_logger(tmp_path):
    log = JsonlLogger(str(tmp_path / "sub" / "m.jsonl"))
    log.log({"epoch": 1, "loss": torch.tensor(0.5)})
    log.log({"epoch": 2, "loss": 0.25, "name": "x"})
    lines = [json.loads(s) for s in open(tmp_path / "sub" / "m.jsonl")]
    assert lines == [{"epoch": 1, "loss": 0.5},
                     {"epoch": 2, "loss": 0.25, "name": "x"}]


def test_debug_nans_scoped():
    before = torch.is_anomaly_enabled()
    with debug_nans(True):
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).backward()
    assert torch.is_anomaly_enabled() == before


def test_profile_trace(tmp_path):
    with profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "on" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_summary_matches_jax(capsys):
    """The total parameter count equals the JAX module_size's, and every
    top-level block's output shape the JAX block's, in NCHW."""
    kw = dict(in_channels=1, out_channels=3, imsize=16, blocks=[2, 3, 2],
              growth_rate=4, init_features=8)
    jm = JDenseED(**kw)
    x = np.zeros((2, 16, 16, 1), np.float32)
    # shapes only: eval_shape traces without computing
    v = jax.eval_shape(lambda k: jm.init(k, x, train=False),
                       jax.random.key(0))
    _, inter = jax.eval_shape(lambda v: jm.apply(
        v, x, train=False, capture_intermediates=True,
        mutable=["intermediates"]), v)
    want = {k: (lambda s: (s[0], s[3], s[1], s[2]))(o["__call__"][0].shape)
            for k, o in inter["intermediates"].items() if k != "__call__"}
    table = summarize(TDenseED(**kw), torch.zeros(2, 1, 16, 16))
    assert table in capsys.readouterr().out
    lines = table.splitlines()
    assert lines[-1] == f"Total params: {j_module_size(v['params'])[0]}"
    got = {}
    for line in lines[1:-1]:
        name, rest = line.split(maxsplit=1)
        got[name] = tuple(int(s) for s in rest[:rest.index(")")].strip(
            "(").split(","))
    assert got["DenseED"] == got["features"] == (2, 3, 16, 16)
    blocks = {n.split(".", 1)[1].lower(): s for n, s in got.items()
              if n.startswith("features.")}
    assert blocks == want

"""The port's entry points end to end on the CPU, and its import hygiene.

make_dataset -> train_codec_mixed_residual -> predict_codec at a tiny size
(imsize 16, blocks 1,2,1, growth 4), the label attach path of
ensure_dataset, the options that are not ported yet, and a check that no
module of the port (nor chip_smoke.py) imports JAX or the JAX package.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import make_dataset as t_make
from pde_surrogate_torch.cli import predict_codec as t_predict
from pde_surrogate_torch.cli import train_codec_mixed_residual as t_train
from pde_surrogate_torch.cli._codec_common import ensure_dataset
from pde_surrogate_torch.data import hdf5 as th5
from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--imsize", "16", "--blocks", "1,2,1", "--growth-rate", "4",
        "--init-features", "8", "--no-plot", "--device", "cpu"]


def test_make_train_predict_chain(tmp_path):
    data1, data2 = tmp_path / "d1", tmp_path / "d2"
    t_make.main(["--device", "cpu", "--data-dir", str(data1), "--imsize",
                 "16", "--ntrain", "32", "--nval", "16", "--ntest", "16",
                 "--n-monte-carlo", "16"])
    names = sorted(p.name for p in (data1 / "16x16").iterdir())
    assert names == ["kle512_lhs16_monte_carlo.hdf5", "kle512_lhs16_test.hdf5",
                     "kle512_lhs16_val.hdf5", "kle512_lhs32_train.hdf5"]
    val = str(data1 / "16x16" / "kle512_lhs16_val.hdf5")
    assert th5.dataset_shapes(val) == {"input": (16, 1, 16, 16),
                                       "output": (16, 3, 16, 16)}

    state, logger = t_train.main(TINY + [
        "--data-dir", str(data2), "--exp-dir", str(tmp_path / "exp"),
        "--ntrain", "32", "--ntest", "16", "--batch-size", "16",
        "--test-batch-size", "16", "--epochs", "1", "--ckpt-freq", "1"])
    assert state.step == 2
    assert np.isfinite(logger["loss_train"]).all()
    assert np.isfinite(logger["r2_test"]).all()
    run = next((tmp_path / "exp" / "codec" / "mixed_residual").iterdir())
    assert run.name == ("grf_kle512_ntrain32_run1_bs16_lr0.001_epochs1_im16")
    assert json.loads((run / "args.txt").read_text())["n_params"] > 0
    assert (run / "checkpoints" / "model_epoch1.pt").is_file()
    assert (run / "training" / "r2_test.txt").is_file()
    epochs = [json.loads(s) for s in
              (run / "training" / "metrics.jsonl").read_text().splitlines()]
    assert epochs[0]["epoch"] == 1 and np.isfinite(epochs[0]["loss_train"])

    out = tmp_path / "pred.hdf5"
    pred, rel_l2, r2 = t_predict.main([
        "--device", "cpu", "--run-dir", str(run), "--input", val,
        "--output", str(out), "--batch-size", "6", "--select-consistency"])
    assert pred.shape == (16, 3, 16, 16) and np.isfinite(pred).all()
    assert rel_l2.shape == r2.shape == (3,)
    assert np.isfinite(rel_l2).all() and np.isfinite(r2).all()
    assert th5.dataset_shapes(str(out)) == {"input": (16, 1, 16, 16),
                                            "output": (16, 3, 16, 16)}


def test_factories_write_identical_inputs(tmp_path):
    """Both packages' make_dataset write the same input bytes under the same
    names; their labels agree to the solver bound (twin at 24 n iterations
    against the JAX CPU tolerance solver: u 5e-5)."""
    from pde_surrogate_tpu.cli import make_dataset as j_make
    from pde_surrogate_tpu.data import hdf5 as jh5
    args = ["--imsize", "16", "--ntrain", "8", "--nval", "8", "--ntest", "8",
            "--n-monte-carlo", "8", "--family", "channelized"]
    t_make.main(args + ["--device", "cpu", "--data-dir", str(tmp_path / "t")])
    j_make.main(args + ["--data-dir", str(tmp_path / "j")])
    for name in ("channel_ng16_n8_train", "channel_ng16_n8_test"):
        xt, yt, _ = th5.load_data(str(tmp_path / "t" / "16x16" /
                                      f"{name}.hdf5"), 8, only_input=False
                                  if name.endswith("test") else True)
        xj, yj, _ = jh5.load_data(str(tmp_path / "j" / "16x16" /
                                      f"{name}.hdf5"), 8, only_input=False
                                  if name.endswith("test") else True)
        assert np.moveaxis(xt, 1, -1).tobytes() == xj.tobytes()
        if yt is not None:
            np.testing.assert_allclose(yt[:, 0], yj[..., 0], atol=5e-5)


def test_ensure_dataset_attaches_labels_and_guards(tmp_path):
    """An inputs-only file (here one written by h5py with gzip, as the JAX
    package writes them) gets labels attached in place; a file smaller than
    the run needs is never regenerated."""
    import h5py
    path = str(tmp_path / "16x16" / "f.hdf5")
    k = np.exp(np.random.default_rng(0).normal(0, 1, (5, 1, 16, 16))).astype(
        np.float32)
    os.makedirs(os.path.dirname(path))
    with h5py.File(path, "w") as f:
        f.create_dataset("input", data=k, compression="gzip")
    ensure_dataset(path, "grf", 5, 16, 64, seed=0, with_output=True,
                   solve_batch=2, device="cpu")
    x, y, _ = th5.load_data(path, 5, only_input=False)
    np.testing.assert_array_equal(x, k)
    np.testing.assert_array_equal(
        y, solve_darcy_batch_fast(torch.from_numpy(k[:, 0])).numpy())
    with h5py.File(path, "r") as f:       # still a file h5py reads
        np.testing.assert_array_equal(f["output"][()], y)
    with pytest.raises(FileExistsError, match="LHS design"):
        ensure_dataset(path, "grf", 6, 16, 64, seed=0, with_output=False,
                       device="cpu")


@pytest.mark.parametrize("flag", [
    ["--physics", "fvcg"], ["--dtype", "bf16"], ["--concat-free"],
    ["--n-devices", "2"], ["--find-lr"], ["--init-from", "x"],
    ["--profile-epoch", "1"]])
def test_unported_options_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_train.main(TINY + ["--exp-dir", str(tmp_path)] + flag)
    assert not (tmp_path / "codec").exists()


def test_chip_smoke_refuses_without_cuda():
    """Without a CUDA device the chip smoke exits non-zero and prints no
    result line (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def _port_files():
    return sorted((ROOT / "pde_surrogate_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_static():
    banned = ("jax", "flax", "optax", "pde_surrogate_tpu")
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path}: import {m}"


def test_port_imports_no_jax_at_run_time():
    """Importing every port module adds no JAX module to sys.modules (the
    interpreter may have JAX loaded already) and never the JAX package."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_files() if p.name != "chip_smoke.py"]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys, importlib\n"
        "before = {m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax')}\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "new = {m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax')} - before\n"
        "tpu = [m for m in sys.modules if m.startswith('pde_surrogate_tpu')]\n"
        "assert not new and not tpu, (sorted(new)[:5], tpu[:5])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

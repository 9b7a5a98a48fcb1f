"""The port's entry points end to end on the CPU, and its import hygiene.

make_dataset -> train_codec_mixed_residual -> predict_codec at a tiny size
(imsize 16, blocks 1,2,1, growth 4), the fvcg objective, the supervised
(MLE) driver with its train labels attached in place, --init-from,
--find-lr, the label attach path of ensure_dataset, the options that are
not ported yet, the run-dir names against the JAX parsers, and a check
that no module of the port (nor chip_smoke.py) imports JAX or the JAX
package.
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

from pde_surrogate_torch.cli import _codec_common
from pde_surrogate_torch.cli import make_dataset as t_make
from pde_surrogate_torch.cli import predict_codec as t_predict
from pde_surrogate_torch.cli import train_codec_max_likelihood as t_mle
from pde_surrogate_torch.cli import train_codec_mixed_residual as t_train
from pde_surrogate_torch.cli._codec_common import ensure_dataset
from pde_surrogate_torch.data import hdf5 as th5
from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--imsize", "16", "--blocks", "1,2,1", "--growth-rate", "4",
        "--init-features", "8", "--no-plot", "--device", "cpu"]
SPLIT = ["--ntrain", "32", "--ntest", "16", "--batch-size", "16",
         "--test-batch-size", "16"]


def _tiny_run(main, exp, data, *extra, imsize="16"):
    """A tiny run of a codec CLI, alone in the exp dir ``exp``; returns its
    result and its run dir."""
    argv = TINY + SPLIT + ["--data-dir", str(data), "--exp-dir", str(exp),
                           "--ckpt-freq", "1", *extra]
    argv[argv.index("--imsize") + 1] = imsize
    out = main(argv)
    (run,) = [p.parent for p in exp.rglob("args.txt")]
    return out, run


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


@pytest.mark.parametrize("main,flag", [
    (t_train.main, ["--dtype", "bf16"]), (t_train.main, ["--concat-free"]),
    (t_train.main, ["--n-devices", "2"]),
    (t_train.main, ["--profile-epoch", "1"]),
    (t_mle.main, ["--dtype", "bf16"]), (t_mle.main, ["--n-devices", "2"])],
    ids=["bf16", "concat-free", "n-devices", "profile-epoch", "mle-bf16",
         "mle-n-devices"])
def test_unported_options_raise(tmp_path, main, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(TINY + ["--exp-dir", str(tmp_path)] + flag)
    assert not (tmp_path / "codec").exists()


def _val_file(data):
    return str(data / "16x16" / "kle512_lhs1000_val.hdf5")


def _predict(run, val):
    pred, rel_l2, r2 = t_predict.main(["--device", "cpu", "--run-dir",
                                       str(run), "--input", val])
    assert pred.shape == (16, 3, 16, 16) and np.isfinite(pred).all()
    assert np.isfinite(rel_l2).all() and np.isfinite(r2).all()


def test_fvcg_train_predict_chain(tmp_path):
    data = tmp_path / "d"
    (state, logger), run = _tiny_run(t_train.main, tmp_path / "exp", data,
                                     "--physics", "fvcg", "--epochs", "2")
    assert run.name == ("grf_kle512_ntrain32_run1_bs16_lr0.001_epochs2_"
                        "im16_fvcg")
    assert state.step == 4
    assert np.isfinite(logger["loss_train"]).all()
    assert np.isfinite(logger["r2_test"]).all()
    _predict(run, _val_file(data))


def test_mle_attaches_train_labels_in_place(tmp_path):
    """The supervised driver on an inputs-only train file (as label-free
    training leaves it): the solver attaches the labels in place, the
    inputs stay, and the run predicts."""
    data = tmp_path / "d"
    train = th5.dataset_path(str(data), 16, "kle512_lhs10000_train")
    ensure_dataset(train, "grf", 32, 16, 512, seed=10_512, with_output=False,
                   device="cpu")
    x0, _, _ = th5.load_data(train, 32)
    (state, logger), run = _tiny_run(t_mle.main, tmp_path / "exp", data,
                                     "--epochs", "2")
    assert run.parent.name == "max_likelihood"
    assert run.name == "grf_kle512_ntrain32_run1_bs16_lr0.001_epochs2_im16"
    x, y, _ = th5.load_data(train, 32, only_input=False)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(
        y, solve_darcy_batch_fast(torch.from_numpy(x[:, 0])).numpy())
    assert state.step == 4
    assert np.isfinite(logger["loss_train"]).all()
    assert logger["loss_train"][-1] < logger["loss_train"][0]
    _predict(run, _val_file(data))


def _first_step_spy(monkeypatch):
    """Record the weights, the step and the optimizer state of the state a
    training run takes its first step from."""
    seen = {}
    make = _codec_common.make_mixed_residual_step

    def spy(state, *a, **k):
        step = make(state, *a, **k)

        def first(*batch):
            if not seen:
                seen.update(step=state.step,
                            opt_state=len(state.optimizer.state),
                            weights={k: v.clone() for k, v in
                                     state.model.state_dict().items()})
            return step(*batch)
        return first

    monkeypatch.setattr(_codec_common, "make_mixed_residual_step", spy)
    return seen


def _weights(run, epoch):
    return torch.load(run / "checkpoints" / f"model_epoch{epoch}.pt",
                      weights_only=True)["model"]


@pytest.mark.parametrize("imsize", ["16", "32"])
def test_init_from_warm_starts(tmp_path, monkeypatch, imsize):
    """--init-from: the first step starts from the source checkpoint's
    weights and BN stats, with a fresh optimizer at step 0, at the source's
    imsize or another (16^2 -> 32^2)."""
    _, src = _tiny_run(t_train.main, tmp_path / "src", tmp_path / "d",
                       "--epochs", "1")
    seen = _first_step_spy(monkeypatch)
    (state, _), _ = _tiny_run(t_train.main, tmp_path / "exp", tmp_path / "d",
                              "--epochs", "1", "--init-from", f"{src}:1",
                              imsize=imsize)
    assert seen["step"] == 0 and seen["opt_state"] == 0
    want = _weights(src, 1)
    assert seen["weights"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen["weights"][k], v), k
    assert state.step == 2


def test_init_from_with_ckpt_epoch_resumes(tmp_path, monkeypatch, capsys):
    """With --ckpt-epoch the resume wins: the run continues from its own
    checkpoint, and --init-from is not applied (one line says so)."""
    _, src = _tiny_run(t_train.main, tmp_path / "src", tmp_path / "d",
                       "--epochs", "1")
    _, run = _tiny_run(t_train.main, tmp_path / "exp", tmp_path / "d",
                       "--epochs", "2")
    seen = _first_step_spy(monkeypatch)
    (state, logger), _ = _tiny_run(t_train.main, tmp_path / "exp",
                                   tmp_path / "d", "--epochs", "2",
                                   "--ckpt-epoch", "1", "--init-from",
                                   str(src))
    assert "not applied" in capsys.readouterr().out
    assert seen["step"] == 2 and seen["opt_state"] > 0
    for k, v in _weights(run, 1).items():
        assert torch.equal(seen["weights"][k], v), k
    assert state.step == 4 and len(logger["loss_train"]) == 2


@pytest.mark.parametrize("main", [t_train.main, t_mle.main],
                         ids=["mixed_residual", "mle"])
def test_find_lr_writes_finite_table(tmp_path, main):
    """--find-lr: one epoch of 8 steps with the lr growing from 1e-8;
    find_lr.txt holds (log10 lr, smoothed loss) rows, all finite."""
    _, run = _tiny_run(main, tmp_path / "exp", tmp_path / "d", "--find-lr",
                       "--ntrain", "64", "--batch-size", "8")
    table = np.loadtxt(run / "find_lr.txt", ndmin=2)
    assert table.shape[1] == 2 and 1 <= len(table) <= 8
    assert np.isfinite(table).all()
    np.testing.assert_allclose(table[0, 0], -8.0)
    assert (np.diff(table[:, 0]) > 0).all()


@pytest.mark.parametrize("kind,argv", [
    ("mixed_residual", ["--physics", "sobel_fvcg", "--fvcg-weight", "50",
                        "--fvcg-flux-weight", "1", "--fvcg-iters", "32",
                        "--imsize", "32"]),
    ("max_likelihood", ["--imsize", "32", "--kle", "100", "--upsample",
                        "bilinear", "--epochs", "50", "--no-shared-stats"])])
def test_run_dir_names_match_jax(tmp_path, kind, argv):
    import importlib
    j_main = importlib.import_module(
        f"pde_surrogate_tpu.cli.train_codec_{kind}")
    t_main = importlib.import_module(
        f"pde_surrogate_torch.cli.train_codec_{kind}")
    j_args = j_main.Parser().parse(argv + ["--exp-dir", str(tmp_path / "j")])
    t_args = t_main.Parser().parse(argv + ["--exp-dir", str(tmp_path / "t"),
                                           "--no-plot"])
    assert (os.path.relpath(t_args.run_dir, tmp_path / "t")
            == os.path.relpath(j_args.run_dir, tmp_path / "j"))


def test_mle_driver_defaults_to_cuda(tmp_path):
    """The supervised driver runs on CUDA unless told otherwise and never
    falls back to the CPU."""
    assert t_mle.Parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mle.main(argv + SPLIT + ["--exp-dir", str(tmp_path), "--data-dir",
                                   str(tmp_path / "d")])


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

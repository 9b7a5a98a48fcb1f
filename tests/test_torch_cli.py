"""The port's entry points end to end on the CPU, and its import hygiene.

make_dataset -> train_codec_mixed_residual -> predict_codec at a tiny size
(imsize 16, blocks 1,2,1, growth 4), the fvcg objective, the supervised
(MLE) driver with its train labels attached in place, --init-from,
--find-lr, the label attach path of ensure_dataset, --dtype bf16,
--concat-free and --profile-epoch in both codec drivers, --n-devices
(data-parallel ranks spawned on the CPU, equal to one process; more ranks
than GPUs refused on cuda), the figures (by file name against the JAX codec
driver's; the solvers'), the run-dir names against the JAX parsers, the
single-instance solvers (FC and conv decoder, linear and nonlinear, their
test sets, their divergence guard), the cGlow chain (train with
--data-init -> predict_cglow -> post_cglow, a resume, the run-dir names
and the squeeze order against the JAX parser), and a check that no module
of the port (nor chip_smoke.py) imports JAX or the JAX package.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.io
import torch

from pde_surrogate_torch.cli import _codec_common
from pde_surrogate_torch.cli import make_dataset as t_make
from pde_surrogate_torch.cli import post_cglow as t_post
from pde_surrogate_torch.cli import predict_cglow as t_pglow
from pde_surrogate_torch.cli import predict_codec as t_predict
from pde_surrogate_torch.cli import solve_conv_mixed_residual as t_conv
from pde_surrogate_torch.cli import solve_fc_mixed_residual as t_fc
from pde_surrogate_torch.cli import train_cglow_reverse_kl as t_glow
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
    (t_train.main, ["--n-devices"]), (t_mle.main, ["--n-devices"])],
    ids=["n-devices", "mle-n-devices"])
def test_unported_options_raise(tmp_path, main, flag):
    """More data-parallel ranks than GPUs on cuda: refused before the run
    dir exists (ranks never share a GPU, nothing falls back to the CPU)."""
    n = str(torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="never share a GPU"):
        main(TINY + ["--exp-dir", str(tmp_path), "--device", "cuda"]
             + flag + [n])
    assert not (tmp_path / "codec").exists()


DP = ["--ntrain", "16", "--ntest", "8", "--batch-size", "8",
      "--test-batch-size", "8", "--epochs", "2"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("main", [t_train.main, t_mle.main],
                         ids=["mixed_residual", "mle"])
def test_codec_data_parallel_cli(tmp_path, main):
    """--n-devices 2 --device cpu (two gloo ranks spawned by the CLI, as
    the JAX package's tests/test_cli_smoke.py sizes its DP run): the
    losses and test metrics within 1e-4 relative of the one-process run,
    its weights and BN buffers within 2e-5, the history in the run dir
    written once; predict_codec serves the DP run's checkpoint in one
    process."""
    data = tmp_path / "d"
    common = TINY + DP + ["--data-dir", str(data), "--ckpt-freq", "1"]
    s1, l1 = main(common + ["--exp-dir", str(tmp_path / "one")])
    s2, l2 = main(common + ["--exp-dir", str(tmp_path / "dp"),
                            "--n-devices", "2"])
    assert s2.step == s1.step == 4
    for k in l1:
        assert _rel(l2[k], l1[k]) < 1e-4, k
    sd1 = s1.model.state_dict()
    for k, v in s2.model.state_dict().items():
        torch.testing.assert_close(v, sd1[k], rtol=0, atol=2e-5, msg=k)
    (run,) = [p.parent for p in (tmp_path / "dp").rglob("args.txt")]
    epochs = (run / "training" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(e)["epoch"] for e in epochs] == [1, 2]
    assert not list(run.glob(".dist_*"))
    val = str(data / "16x16" / "kle512_lhs1000_val.hdf5")
    pred, rel_l2, r2 = t_predict.main(["--device", "cpu", "--run-dir",
                                       str(run), "--input", val])
    assert pred.shape == (8, 3, 16, 16)
    np.testing.assert_allclose(rel_l2, l2["nrmse_test"][-1], rtol=1e-4)


@pytest.mark.parametrize("kind,flag,suffix", [
    ("mixed_residual", ["--dtype", "bf16"], "_bf16"),
    ("mixed_residual", ["--concat-free"], "_cf"),
    ("mixed_residual", ["--profile-epoch", "1"], ""),
    ("max_likelihood", ["--dtype", "bf16"], "_bf16"),
    ("max_likelihood", ["--concat-free", "--dtype", "bf16"], "_bf16_cf"),
    ("max_likelihood", ["--profile-epoch", "1"], "")],
    ids=["bf16", "concat-free", "profile-epoch", "mle-bf16",
         "mle-concat-free", "mle-profile-epoch"])
def test_codec_options_run(tmp_path, kind, flag, suffix):
    """--dtype bf16, --concat-free and --profile-epoch in both codec
    drivers: one epoch with finite losses and metrics, in the run dir the
    JAX parser names (the JAX MLE driver has no --concat-free: its suffix
    is the mixed-residual driver's), served by predict_codec with the
    recorded dtype and layout; the profiled epoch writes a trace with its
    steps' program spans."""
    import importlib
    main = t_train.main if kind == "mixed_residual" else t_mle.main
    (state, logger), run = _tiny_run(main, tmp_path / "exp", tmp_path / "d",
                                     "--epochs", "1", *flag)
    assert run.name == ("grf_kle512_ntrain32_run1_bs16_lr0.001_epochs1_im16"
                        + suffix)
    if "--concat-free" not in flag or kind == "mixed_residual":
        j_args = importlib.import_module(
            f"pde_surrogate_tpu.cli.train_codec_{kind}").Parser().parse(
            [a for a in TINY + SPLIT + flag if a not in ("--device", "cpu")]
            + ["--epochs", "1", "--exp-dir", str(tmp_path / "j")])
        assert run.name == os.path.basename(j_args.run_dir)
    assert state.step == 2 and np.isfinite(logger["loss_train"]).all()
    assert np.isfinite(logger["r2_test"]).all()
    trace = run / "training" / "profile" / "trace.json"
    assert trace.is_file() == ("--profile-epoch" in flag)
    if trace.is_file():
        # the profiled epoch's two steps, each with its program spans
        spans = [e["name"] for e in json.loads(trace.read_text())[
            "traceEvents"] if e.get("cat") == "program_span"]
        assert spans.count("train.step") == spans.count("data.gather") == 2
        assert spans.count("train.backward") == 2
    model = _codec_common.build_model(th5.load_args(str(run)), "cpu")
    assert model.dtype == (torch.bfloat16 if "bf16" in flag else None)
    assert model.features.EncBlock1.concat_free == ("--concat-free" in flag)
    _predict(run, _val_file(tmp_path / "d"))


def test_codec_figures_match_jax_cli(tmp_path):
    """Without --no-plot the port's codec driver writes the figures and
    stats files of the JAX driver, by name (6 prediction figures of the
    last test batch at the last epoch, a .txt and a .pdf per curve)."""
    from pde_surrogate_tpu.cli import train_codec_mixed_residual as j_train
    argv = [a for a in TINY if a != "--no-plot"] + SPLIT + ["--epochs", "1"]
    t_train.main(argv + ["--data-dir", str(tmp_path / "dt"), "--exp-dir",
                         str(tmp_path / "t")])
    j_train.main([a for a in argv if a not in ("--device", "cpu")] + [
        "--data-dir", str(tmp_path / "dj"), "--exp-dir", str(tmp_path / "j")])
    names = {}
    for d in ("j", "t"):
        (train_dir,) = (tmp_path / d).rglob("training")
        names[d] = sorted(str(p.relative_to(train_dir))
                          for p in train_dir.rglob("*") if p.is_file())
    assert names["t"] == names["j"]
    assert sum(n.startswith("predictions/pred_epoch1_")
               for n in names["t"]) == 6
    assert "loss_train.pdf" in names["t"]


@pytest.mark.parametrize("cli,extra,figures", [
    (t_conv, ["--blocks", "1,1", "--animate", "--test-freq", "1"],
     ["animation.gif", "loss.pdf", "pred_1.png", "pred_2.png"]),
    (t_fc, ["--dim-hidden", "16", "--layers-hidden", "2", "--n-colloc",
            "64", "--test-freq", "2"],
     ["input_logK.png", "loss.pdf", "pred_epoch2_1.png", "solution_HR.png"])],
    ids=["conv-animate", "fc"])
def test_solver_figures(tmp_path, cli, extra, figures):
    """Without --no-plot the solvers draw the JAX CLIs' figures: a test
    epoch's panels (with --animate numbered frames and animation.gif), the
    loss curve, and for the FC net the 640^2 render of u beside log K."""
    argv = [a for a in _solver_argv(tmp_path, "--epochs", "2",
                                    "--adam-warmup", "5", *extra)
            if a != "--no-plot"]
    cli.main(argv)
    (run,) = [p.parent for p in (tmp_path / "e").rglob("loss.txt")]
    got = sorted(p.name for p in run.iterdir()
                 if p.suffix in (".png", ".pdf", ".gif"))
    assert got == figures


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


SOLVER = ["--imsize", "16", "--kle", "128", "--idx", "1", "--no-plot",
          "--device", "cpu"]


def _solver_argv(tmp_path, *extra):
    return SOLVER + ["--data-dir", str(tmp_path / "d"), "--exp-dir",
                     str(tmp_path / "e"), *extra]


@pytest.mark.parametrize("data,kle", [("grf", 128), ("grf", 512),
                                      ("warped_grf", 512),
                                      ("channelized", 512)])
def test_solver_test_sets_match_jax(monkeypatch, tmp_path, data, kle):
    """ensure_test_dataset asks for the JAX package's file, size and seed
    (kle{k}_lhs{1000|1024}_test with seed 32 000 + kle; warped 30 000; the
    channelized file and seed of the codec drivers) with labels."""
    import argparse

    from pde_surrogate_tpu.cli import _codec_common as j_common
    from pde_surrogate_tpu.cli import solve_conv_mixed_residual as j_conv
    seen = {}

    def spy(name):
        def record(path, *a, **k):
            seen[name] = (os.path.relpath(path, tmp_path), a,
                          k.get("seed"), k.get("with_output"))
        return record

    monkeypatch.setattr(t_conv, "ensure_dataset", spy("t"))
    monkeypatch.setattr(j_common, "ensure_dataset", spy("j"))
    args = argparse.Namespace(data=data, kle=kle, imsize=16, idx=3,
                              data_dir=str(tmp_path), device="cpu")
    assert (os.path.relpath(t_conv.ensure_test_dataset(args), tmp_path)
            == os.path.relpath(j_conv.ensure_test_dataset(args), tmp_path))
    assert seen["t"] == seen["j"] and seen["t"][3] is True
    args.idx = 5000
    with pytest.raises(ValueError, match="out of range"):
        t_conv.ensure_test_dataset(args)


def test_solve_fc_cli(tmp_path):
    """The FC (PINN) solver: a 20-step Adam warmup, then 3 epochs of zoom
    L-BFGS; the run dir and the epoch{N}.npy prediction (in the dataset's
    channel order) of the JAX package; the loss falls; the test set is
    labelled in the data dir."""
    params, logger, target = t_fc.main(_solver_argv(
        tmp_path, "--dim-hidden", "32", "--layers-hidden", "2",
        "--n-colloc", "256", "--epochs", "3", "--test-freq", "3",
        "--adam-warmup", "20"))
    assert len(logger["loss"]) == 3
    assert np.isfinite(logger["loss"]).all()
    assert logger["loss"][-1] <= logger["loss"][0]
    assert min(logger["evals"]) >= 21
    assert target.shape == (3, 16, 16)
    run = (tmp_path / "e" / "fc_mixed_residual" /
           "grf_kle128_idx1_dhid32_lhid2_alpha1_1.0_alpha2_1.0_lr0.5_wb10.0_"
           "epochs3_ongrid_True_ncolloc256")
    pred = np.load(run / "epoch3.npy")
    assert pred.shape == (3, 16, 16) and np.isfinite(pred).all()
    assert (run / "loss.txt").is_file()
    assert th5.dataset_shapes(str(tmp_path / "d" / "16x16" /
                                  "kle128_lhs1024_test.hdf5")) == {
        "input": (1024, 1, 16, 16), "output": (1024, 3, 16, 16)}


@pytest.mark.parametrize("linesearch", ["fixed", "zoom"])
def test_solve_conv_cli(tmp_path, linesearch):
    """The conv-decoder solver with the 5x5 stencil: a 10-step Adam
    warmup, then 2 L-BFGS epochs with fixed steps or the zoom linesearch;
    the JAX package's run dir, predictions and weights."""
    params, logger, target = t_conv.main(_solver_argv(
        tmp_path, "--blocks", "2,2", "--epochs", "2", "--test-freq", "2",
        "--ckpt-freq", "2", "--linesearch", linesearch, "--adam-warmup",
        "10", "--sobel-size", "5"))
    assert len(logger["loss"]) == 2 and np.isfinite(logger["loss"]).all()
    assert logger["loss"][-1] < logger["loss"][0] * 10
    if linesearch == "fixed":
        assert logger["evals"] == [21, 21]
    run = (tmp_path / "e" / "conv_mixed_residual" /
           "grf_kle128_idx1_dz1_blocks[2, 2]_lr0.5_wb10.0_epochs2")
    pred = np.load(run / "epoch2.npy")
    assert pred.shape == (3, 16, 16) and np.isfinite(pred).all()
    assert logger["rel_l2"][-1][0] == 2
    weights = torch.load(run / "model_epoch2.pt", weights_only=True)["model"]
    assert "features.Conv0.weight" in weights
    np.testing.assert_array_equal(
        target, th5.load_data(str(tmp_path / "d" / "16x16" /
                                  "kle128_lhs1024_test.hdf5"), 2,
                              only_input=False)[1][1])


def _f1_jax_init():
    """``tools/f1_jax_init.py`` as a module (``tools/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "f1_jax_init", ROOT / "tools" / "f1_jax_init.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_solve_conv_cli_starts_from_jax_init(tmp_path):
    """--init-weights: the Decoder's weights and latent from a .npz of the
    JAX package's initialisation (``tools/f1_jax_init.py``, blocks 2,2 at
    16^2); after one L-BFGS epoch of fixed steps of lr 0 the prediction is
    the JAX Decoder's at its init, in train mode (1e-5 of its largest
    value)."""
    import jax

    from pde_surrogate_tpu.models.codec import Decoder as JDecoder
    arrays = _f1_jax_init().jax_decoder_init(1, blocks=(2, 2), imsize=16)
    np.savez(tmp_path / "init.npz", **arrays)
    latent = np.moveaxis(arrays["latent"], 1, -1)
    jm = JDecoder(1, out_channels=3, blocks=[2, 2])
    y, _ = jm.apply(jm.init(jax.random.key(1), latent, train=False), latent,
                    train=True, mutable=["batch_stats"])
    want = np.moveaxis(np.asarray(y)[0], -1, 0)
    t_conv.main(_solver_argv(
        tmp_path, "--blocks", "2,2", "--epochs", "1", "--test-freq", "1",
        "--linesearch", "fixed", "--lr", "0", "--adam-warmup", "0",
        "--init-weights", str(tmp_path / "init.npz")))
    run = (tmp_path / "e" / "conv_mixed_residual" /
           "grf_kle128_idx1_dz1_blocks[2, 2]_lr0.0_wb10.0_epochs1")
    np.testing.assert_allclose(np.load(run / "epoch1.npy"), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_f1_jax_init_file_fits_the_canonical_decoder():
    """The committed JAX initialisation of the canonical conv solver
    (Decoder [8,6]/16/48, seed 1) is what ``tools/f1_jax_init.py`` makes
    now, array for array and exactly; it loads strictly into the port's
    Decoder, and its latent is the seed's own numpy draw, as the CLI
    makes it."""
    from pde_surrogate_torch.models.codec import Decoder
    path = ROOT / "pde_surrogate_torch" / "tools" / "f1_jax_init_seed1.npz"
    fresh = _f1_jax_init().jax_decoder_init(1)
    with np.load(path) as init:
        assert sorted(init.files) == sorted(fresh)
        for k in init.files:
            np.testing.assert_array_equal(init[k], fresh[k], err_msg=k)
        Decoder(1, 3, [8, 6]).load_state_dict(
            {k: torch.from_numpy(init[k]) for k in init.files
             if k != "latent"})
        latent = init["latent"]
    want = (np.random.default_rng(1).standard_normal((1, 16, 16, 1))
            .astype(np.float32) * 0.5)
    np.testing.assert_array_equal(latent, np.moveaxis(want, -1, 1))


def test_solve_conv_nonlinear_cli(tmp_path):
    """--nonlinear: the FV-Newton oracle obeys the boundary conditions and
    is cached as output_fv_newton.npy; a second run reuses it (mtime
    unchanged)."""
    argv = _solver_argv(tmp_path, "--blocks", "2,2", "--epochs", "2",
                        "--test-freq", "2", "--nonlinear", "--alpha1",
                        "0.5", "--alpha2", "0.5", "--adam-warmup", "20")
    params, logger, target = t_conv.main(argv)
    assert target.shape == (3, 16, 16) and np.isfinite(target).all()
    assert np.allclose(target[0, :, 0], 1.0, atol=1e-4)
    assert np.allclose(target[0, :, -1], 0.0, atol=1e-4)
    assert (target[2, [0, -1]] == 0.0).all()
    assert np.isfinite(logger["loss"]).all()
    (cache,) = (tmp_path / "e").rglob("output_fv_newton.npy")
    assert cache.parent.name.endswith("_alpha1_0.5_alpha2_0.5")
    assert cache.parent.parent.name == "conv_mixed_residual_nonlinear"
    mtime = cache.stat().st_mtime_ns
    _, _, target2 = t_conv.main(argv)
    assert cache.stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(target2, target)


@pytest.mark.parametrize("linesearch", ["zoom", "fixed"])
def test_solve_conv_divergence_guard(tmp_path, monkeypatch, capsys,
                                     linesearch):
    """A loss that turns NaN: every epoch restarts from the best params.
    zoom (NaN from epoch 2 on) stops after 3 restarts at the best params;
    fixed (NaN in epoch 2 only) halves the step and goes on."""
    epochs = {"n": 0}
    make = t_conv.make_lbfgs_epoch

    def counting(*a, **k):
        epoch = make(*a, **k)

        def wrapped(params, state):
            epochs["n"] += 1
            return epoch(params, state)
        return wrapped

    boundary = t_conv.conv_boundary_condition
    nan_epochs = (lambda e: e >= 2) if linesearch == "zoom" else (
        lambda e: e == 2)

    def turning_nan(output):
        diri, neum = boundary(output)
        return (diri * float("nan") if nan_epochs(epochs["n"]) else diri,
                neum)

    monkeypatch.setattr(t_conv, "make_lbfgs_epoch", counting)
    monkeypatch.setattr(t_conv, "conv_boundary_condition", turning_nan)
    params, logger, _ = t_conv.main(_solver_argv(
        tmp_path, "--blocks", "1,1", "--epochs", "6" if linesearch == "zoom"
        else "3", "--test-freq", "100", "--linesearch", linesearch,
        "--adam-warmup", "5"))
    out = capsys.readouterr().out
    first = logger["loss"][0]
    assert np.isfinite(first)
    if linesearch == "zoom":
        assert epochs["n"] == 4 and logger["loss"] == [first] * 4
        assert "stopping early" in out
    else:
        assert epochs["n"] == 3 and logger["loss"][1] == first
        assert np.isfinite(logger["loss"][2])
        assert "lr x0.5" in out
    assert out.count("diverged (loss nan)") == (3 if linesearch == "zoom"
                                                else 1)
    assert torch.isfinite(params).all()


@pytest.mark.parametrize("cli", [t_fc, t_conv], ids=["fc", "conv"])
def test_solvers_default_to_cuda(tmp_path, cli):
    """The solver CLIs run on CUDA unless told otherwise and never fall
    back to the CPU."""
    assert cli.Parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in SOLVER if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--exp-dir", str(tmp_path), "--data-dir",
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


# --- the conditional Glow --------------------------------------------------

GLOW = ["--imsize", "16", "--kle", "512", "--enc-blocks", "2,2,2",
        "--flow-blocks", "2,2,2", "--ntrain", "16", "--ntest", "8",
        "--batch-size", "8", "--test-batch-size", "8", "--ckpt-freq", "1",
        "--no-plot", "--device", "cpu"]


def _glow_run(tmp_path, *extra, exp="exp"):
    out = t_glow.main(GLOW + ["--data-dir", str(tmp_path / "d"),
                              "--exp-dir", str(tmp_path / exp), *extra])
    (run,) = [p.parent for p in (tmp_path / exp).rglob("args.txt")]
    return out, run


@pytest.mark.parametrize("argv", [
    [], ["--imsize", "64", "--kle", "512", "--data-init", "--epochs", "200"],
    ["--physics", "sobel_fvcg", "--fvcg-weight", "50", "--fvcg-flux-weight",
     "1", "--fvcg-iters", "32", "--imsize", "16"],
    ["--physics", "fvcg", "--fvcg-iters", "16", "--data", "channelized",
     "--debug"]], ids=["defaults", "canonical", "hybrid", "fvcg"])
def test_cglow_run_dir_names_match_jax(tmp_path, argv):
    from pde_surrogate_tpu.cli import train_cglow_reverse_kl as j_glow
    j_args = j_glow.Parser().parse(argv + ["--exp-dir", str(tmp_path / "j")])
    t_args = t_glow.Parser().parse(argv + ["--exp-dir", str(tmp_path / "t")])
    assert (os.path.relpath(t_args.run_dir, tmp_path / "t")
            == os.path.relpath(j_args.run_dir, tmp_path / "j"))
    assert t_args.squeeze_order == j_args.squeeze_order == "subpixel"


def test_cglow_weights_without_effect_exit(tmp_path):
    """Anchor weights under the pure fvcg objective would change nothing:
    both parsers stop; more --n-devices than GPUs on cuda is refused."""
    from pde_surrogate_tpu.cli import train_cglow_reverse_kl as j_glow
    argv = ["--physics", "fvcg", "--fvcg-weight", "50"]
    for parser, exp in ((j_glow.Parser(), "j"), (t_glow.Parser(), "t")):
        with pytest.raises(SystemExit):
            parser.parse(argv + ["--exp-dir", str(tmp_path / exp)])
    with pytest.raises(RuntimeError, match="never share a GPU"):
        t_glow.Parser().parse([
            "--n-devices", str(torch.cuda.device_count() + 1), "--device",
            "cuda", "--exp-dir", str(tmp_path / "t")])
    assert not (tmp_path / "t").exists()


def _write_args(run, **kw):
    run.mkdir(parents=True)
    (run / "args.txt").write_text(json.dumps(kw))


@pytest.mark.parametrize("source", ["legacy resume", "init-from"])
def test_cglow_squeeze_order_inherited_like_jax(tmp_path, source):
    """The squeeze order comes from the source run's args.txt: on resume
    from a run dir made before the _im{N} suffix (which the resume finds),
    or from --init-from; an explicit conflicting order raises."""
    from pde_surrogate_tpu.cli import train_cglow_reverse_kl as j_glow
    for exp in ("j", "t"):
        if source == "legacy resume":
            legacy = (tmp_path / exp / "cglow" / "reverse_kld" /
                      "kle100_ntrain4096_ENC_blocks[3, 4, 4]_FLOW_blocks"
                      "[6, 6, 6]_wb50.0_beta150.0_batch32_lr0.0015_epochs400")
            _write_args(legacy, squeeze_order="reference")
            argv = ["--imsize", "64", "--ckpt-epoch", "5"]
        else:
            _write_args(tmp_path / f"src_{exp}", squeeze_order="reference")
            argv = ["--init-from", f"{tmp_path / f'src_{exp}'}:3"]
        argv += ["--exp-dir", str(tmp_path / exp)]
        j_args = j_glow.Parser().parse(argv) if exp == "j" else None
        t_args = t_glow.Parser().parse(argv) if exp == "t" else None
        args = j_args or t_args
        assert args.squeeze_order == "reference"
        if source == "legacy resume":
            assert args.run_dir == str(legacy)
        with pytest.raises(ValueError, match="conflicts"):
            (j_glow if exp == "j" else t_glow).Parser().parse(
                argv + ["--squeeze-order", "subpixel"])


def test_cglow_train_predict_post_chain(tmp_path):
    """train_cglow_reverse_kl (--data-init) -> predict_cglow -> post_cglow
    on the CPU: finite losses and metrics, the predictive mean and std in
    a file h5py reads, and every artefact of the five UQ tasks."""
    import h5py
    (state, logger), run = _glow_run(tmp_path, "--epochs", "1",
                                     "--data-init")
    assert state.step == state.updates == 2
    assert np.isfinite(logger["loss_train"]).all()
    assert np.isfinite(np.asarray(logger["r2_test"])).all()
    assert run.name.endswith("_epochs1_im16_data_init")
    assert (run / "checkpoints" / "model_epoch1.pt").is_file()
    train = tmp_path / "d" / "16x16" / "kle512_lhs10000_train.hdf5"
    assert th5.dataset_shapes(str(train))["output"] == (16, 3, 16, 16)

    val = str(tmp_path / "d" / "16x16" / "kle512_lhs1000_val.hdf5")
    out = tmp_path / "pred.hdf5"
    mean, std, rel_l2, r2 = t_pglow.main([
        "--device", "cpu", "--run-dir", str(run), "--input", val,
        "--output", str(out), "--n-samples", "4", "--batch-size", "3"])
    assert mean.shape == std.shape == (8, 3, 16, 16)
    assert np.isfinite(std).all() and (std > 0).all()
    assert np.isfinite(rel_l2).all() and np.isfinite(r2).all()
    with h5py.File(out, "r") as f:
        assert sorted(f) == ["input", "output", "output_std"]
        np.testing.assert_array_equal(f["output_std"][()], std)
        np.testing.assert_array_equal(f["output"][()], mean)
        np.testing.assert_array_equal(f["input"][()],
                                      th5.load_data(val, 8)[0])

    uq = t_post.main(["--device", "cpu", "--run-dir", str(run),
                      "--n-monte-carlo", "8", "--ntest", "8", "--n-samples",
                      "3", "--var-samples", "2", "--batch-size", "4",
                      "--n-pred", "2", "--num-loc", "3", "--plot-samples"])
    post = run / "post_proc_epoch1"
    assert uq.post_dir == str(post) and set(uq.seconds) == {
        "predict_at_x", "dist", "test_metric", "reliability", "propagate"}
    for name in ("nrmse_test.txt", "r2_test.txt", "log_stats.txt",
                 "uncertainty_quality/reliability_diagram.txt"):
        assert np.isfinite(np.loadtxt(post / name)).all(), name
    assert np.load(post / "dist_estimate" / "pred.npy").shape == (8, 3, 3)
    mat = scipy.io.loadmat(str(post / "out_stats" / "out_stats.mat"))
    assert mat["y_pred_EE"].shape == (3, 16, 16)
    (at_x,) = sorted((post / "predict_at_x").glob("*idx*.npz"))[:1]
    with np.load(at_x) as z:
        assert z["samples"].shape == (3, 3, 16, 16)
    mc = tmp_path / "d" / "16x16" / "kle512_lhs10000_monte_carlo.hdf5"
    assert th5.dataset_shapes(str(mc))["output"] == (8, 3, 16, 16)


def test_cglow_data_parallel_cli(tmp_path):
    """--n-devices 2 --device cpu with --data-init (ActNorm initialised on
    the full first batch on both ranks): the losses and test metrics within
    1e-4 relative of the one-process run; predict_cglow serves the DP
    run's checkpoint in one process."""
    (s1, l1), _ = _glow_run(tmp_path, "--epochs", "2", "--data-init",
                            exp="one")
    (s2, l2), run = _glow_run(tmp_path, "--epochs", "2", "--data-init",
                              "--n-devices", "2", exp="dp")
    assert s2.step == s2.updates == s1.step == 4
    for k in l1:
        assert _rel(l2[k], l1[k]) < 1e-4, k
    mean, std, rel_l2, r2 = t_pglow.main([
        "--device", "cpu", "--run-dir", str(run), "--input",
        str(tmp_path / "d" / "16x16" / "kle512_lhs1000_val.hdf5"),
        "--n-samples", "4"])
    assert mean.shape == (8, 3, 16, 16) and np.isfinite(std).all()


def test_cglow_resume_matches_uninterrupted(tmp_path):
    """Resuming from epoch 1 redraws what the uninterrupted run drew: the
    step noise is a function of (seed, step), the batches of (seed, epoch),
    and the checkpoint holds the counters, Adam and the BN stats: the
    weights bit for bit."""
    (state, _), run = _glow_run(tmp_path, "--epochs", "2")
    full = _weights(run, 2)
    (state, logger), _ = _glow_run(tmp_path, "--epochs", "2", "--resume",
                                   "--ckpt-epoch", "1")
    assert state.step == state.updates == 4 and len(logger["loss_train"]) == 2
    for k, v in full.items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)


@pytest.mark.parametrize("physics", ["sobel", "fvcg"])
def test_codec_resume_matches_uninterrupted(tmp_path, capsys, physics):
    """The codec CLI resumed from epoch 1 (``--ckpt-epoch 1``, the
    checkpoint of an uninterrupted run copied into a fresh exp dir) ends
    where the uninterrupted 2-epoch run ends: the weights and BN stats
    bit for bit, the same history for the label-free checkpoint selection
    (the last checkpoint's ``ckpt_consistency``, and its loss and R^2
    lists) and the same selected epoch.  The batches are a function of
    (seed, epoch) and the checkpoint holds Adam, the step count and the BN
    stats."""
    extra = ("--epochs", "2", "--physics", physics)
    _, run = _tiny_run(t_train.main, tmp_path / "full", tmp_path / "d",
                       *extra)
    full_out = capsys.readouterr().out
    rel = run.relative_to(tmp_path / "full")
    ckpt = tmp_path / "resumed" / rel / "checkpoints"
    ckpt.mkdir(parents=True)
    for ext in ("pt", "json"):
        name = f"model_epoch1.{ext}"
        (ckpt / name).write_bytes((run / "checkpoints" / name).read_bytes())
    (state, _), run2 = _tiny_run(t_train.main, tmp_path / "resumed",
                                 tmp_path / "d", *extra, "--ckpt-epoch", "1")
    resumed_out = capsys.readouterr().out
    assert "Loaded ckpt at epoch 1; resume from 2 to 2" in resumed_out
    assert state.step == 4
    for k, v in _weights(run, 2).items():
        torch.testing.assert_close(state.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)
    metas = [json.loads((r / "checkpoints" / "model_epoch2.json").read_text())
             for r in (run, run2)]
    hist = [dict(m["ckpt_consistency"]) for m in metas]
    assert list(hist[0]) == list(hist[1]) == [1, 2]
    np.testing.assert_allclose(list(hist[1].values()),
                               list(hist[0].values()), rtol=1e-6)
    for key in ("loss_train", "r2_test", "consistency_test"):
        np.testing.assert_allclose(metas[1]["logger"][key],
                                   metas[0]["logger"][key], rtol=1e-6)
    selected = [[line for line in out.splitlines()
                 if line.startswith("Label-free checkpoint selection")]
                for out in (full_out, resumed_out)]
    assert len(selected[0]) == 1
    assert (selected[0][0].split(": epoch ")[1].split()[0]
            == selected[1][0].split(": epoch ")[1].split()[0])


@pytest.mark.parametrize("cli", [t_glow, t_pglow, t_post],
                         ids=["train", "predict", "post"])
def test_cglow_clis_default_to_cuda(tmp_path, cli):
    """The cGlow entry points run on CUDA unless told otherwise and never
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if cli is t_glow:
        assert cli.Parser().parse_args([]).device == "cuda"
        argv = [a for a in GLOW if a not in ("--device", "cpu")] + [
            "--exp-dir", str(tmp_path), "--data-dir", str(tmp_path / "d")]
    else:
        argv = ["--run-dir", str(tmp_path)] + (
            ["--input", str(tmp_path / "x.hdf5")] if cli is t_pglow else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)

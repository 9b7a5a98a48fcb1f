"""ROADMAP F3's split of the late-epoch u flap, on the CPU at a small size:
the precise BatchNorm statistics of ``tools/f3_bn_split.py`` against a
float64 numpy computation, the split leaving the model and the checkpoint
as they were, its JSON line and its check of the CLI's logged R², and the
replay of ``tools/f3_bn_replay.py`` from the codec recipe test's trained
state in both packages.

The size is ``tests/test_torch_codec_recipe.py``'s: a DenseED [1, 2, 1],
growth 4, 8 initial features, at 16², 32 fields, batch 8.  Tolerances:
the precise statistics within 1e-6 of each tensor's largest value of the
float64 numpy moments (the tool runs the model in float32); the replay
within step 3's bounds (``f3_bn_replay.BOUNDS``, the recipe test's evals
5e-6 and statistics 4e-6, or 3x the port's own float32 distance from its
float64 run where that exceeds a third of a bound); the split's R² within
1e-5 relative of the CLI's (``f3_bn_split.R2_TOL``).
"""

import copy
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import train_codec_mixed_residual as train
from pde_surrogate_torch.models.codec import BatchNorm2d, DenseED
from pde_surrogate_torch.tools import f3_bn_split, r1_seeds

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMSIZE, BLOCKS, GROWTH, FEATURES, NFIELDS, BATCH = 16, [1, 2, 1], 4, 8, 32, 8
# f3_bn_split reads val fields 138, 38 and 28: 144 val fields in 3 batches
TINY = ["--device", "cpu", "--imsize", "16", "--ntrain", "32", "--ntest",
        "144", "--batch-size", "8", "--test-batch-size", "48", "--blocks",
        "1,2,1", "--growth-rate", "4", "--init-features", "8", "--epochs",
        "2", "--ckpt-freq", "1", "--no-plot"]


def _module(name: str, path: pathlib.Path):
    """A file of ``tools/`` or ``tests/`` (neither is a package) as a
    module."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_and_batches():
    """A DenseED with drawn running statistics (so that a forward that read
    them would show) and 4 batches of 8 fields."""
    torch.manual_seed(0)
    model = DenseED(1, 3, IMSIZE, BLOCKS, growth_rate=GROWTH,
                    init_features=FEATURES)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(size=c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, c)))
    x = np.exp(rng.normal(size=(NFIELDS, 1, IMSIZE, IMSIZE))).astype(
        np.float32)
    return model, [torch.from_numpy(x[i:i + BATCH])
                   for i in range(0, NFIELDS, BATCH)]


def test_precise_statistics_match_numpy_float64():
    """(i) Each BatchNorm's precise statistics, from the float32 model,
    against numpy's float64 mean and biased variance over every input the
    BatchNorm sees in the same train-mode batches (its fold off), within
    1e-6 of each tensor's largest value."""
    model, batches = _model_and_batches()
    got = f3_bn_split.precise_statistics(model, batches)

    ref = copy.deepcopy(model).double().train()
    inputs = {}
    for name, m in ref.named_modules():
        if isinstance(m, BatchNorm2d):
            m.fold_stats = False
            m.register_forward_pre_hook(
                lambda mod, a, name=name: inputs.setdefault(name, []).append(
                    a[0].numpy().copy()))
    with torch.no_grad():
        for xb in batches:
            ref(xb.double())
    assert set(got) == set(inputs) and len(got) == 11
    for name, xs in inputs.items():
        x = np.concatenate(xs)                       # (N, C, H, W) float64
        mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
        for g, w in zip(got[name], (mean, var)):
            err = np.max(np.abs(g.numpy() - w)) / np.max(np.abs(w))
            assert err <= 1e-6, (name, err)
        run = dict(model.named_modules())[name]
        # the train-mode moments, not the drawn running statistics
        assert not np.allclose(var, run.running_var.double().numpy())


def test_precise_statistics_leave_the_model_bit_equal():
    """(ii) The precise statistics and their copy of the model leave the
    model handed in bit-equal, parameters and buffers."""
    model, batches = _model_and_batches()
    before = copy.deepcopy(model.state_dict())
    stats = f3_bn_split.precise_statistics(model, batches)
    moved = f3_bn_split.with_statistics(model, stats)
    after = model.state_dict()
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert not torch.equal(moved.state_dict()[
        "features.EncBlock1.denselayer1.norm1.running_var"],
        before["features.EncBlock1.denselayer1.norm1.running_var"])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 2-epoch 16² run of the codec CLI with a checkpoint each epoch."""
    tmp = tmp_path_factory.mktemp("f3_split")
    train.main([*TINY, "--data-dir", str(tmp / "d"), "--exp-dir",
                str(tmp / "e")])
    (args,) = (tmp / "e").rglob("args.txt")
    return args.parent


def test_split_json_line_and_checkpoint_kept(run_dir, capsys):
    """(ii), (iv) The split of epoch 2 prints one JSON line that parses,
    (a) reproduces the CLI's logged R² within 1e-5, (c) measures the move
    from epoch 1, and the checkpoint file keeps its bytes; ``--parse``
    reads the line back into its summary."""
    ckpt = run_dir / "checkpoints" / "model_epoch2.pt"
    before = ckpt.read_bytes()
    f3_bn_split.main(["--run-dir", str(run_dir), "--epochs", "2",
                      "--device", "cpu"])
    assert ckpt.read_bytes() == before
    out = capsys.readouterr().out
    got = json.loads(out.strip().splitlines()[-1])
    res = got["f3_bn_split"]
    (row,) = res["rows"]
    assert row["epoch"] == 2 and res["fields"] == [138, 38, 28]
    assert row["r2_logged_rel_diff"] <= f3_bn_split.R2_TOL
    assert row["r2_precise"] != row["r2_run"]
    assert row["movement"]["params"]["rel"] > 0
    assert 0 < row["fields_share_run"] < 1
    assert res["R_run"] == res["R_pre"] == 0.0     # one epoch
    log = run_dir.parent / "split.log"
    log.write_text(out)
    summary = f3_bn_split.main(["--parse", str(log)])["split.log"]
    assert summary == json.loads(json.dumps(f3_bn_split.summarize(res)))
    assert summary["u_r2_run"] == [row["r2_run"][0]] * 2
    assert summary["params_move"] == [row["movement"]["params"]["rel"]] * 2


def test_split_raises_on_a_wrong_logged_r2(run_dir):
    """(iv) (a)'s check raises where the CLI's logged R² differs by more
    than 1e-5 relative (a copy of the run with its logged u R² moved by
    2e-5), and where the run logged none."""
    bad = run_dir.parent / "bad_log"
    if not bad.exists():
        import shutil
        shutil.copytree(run_dir, bad)
        meta_path = bad / "checkpoints" / "model_epoch2.json"
        meta = json.loads(meta_path.read_text())
        meta["logger"]["r2_test"][-1][0] *= 1 + 2e-5
        meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="does not reproduce"):
        f3_bn_split.split_run(str(bad), [2], "cpu", log=lambda _: None)
    with pytest.raises(ValueError, match="logged no"):
        f3_bn_split.check_logged([0.5, 0.5, 0.5], None, 2)


def test_r1_seeds_splits_and_exports(tmp_path, capsys, monkeypatch):
    """``r1_seeds --split --export-epoch --name``: one 16² run, its split
    log's JSON line, and the exported state with its meta."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = r1_seeds.main(["--device", "cpu", "--runs", "f32:4", "--split",
                        "f32:4", "--export-epoch", "1", "--name", "f3_port",
                        "--out", str(tmp_path), "--extra", *TINY[2:]])
    runs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and runs["r1_seeds"]["f3_port_f32_seed4"]["split_rc"] == 0
    lines = (tmp_path / "f3_port_f32_seed4_split.log").read_text().split(
        "\n")
    res = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    assert res["f3_bn_split"]["seed"] == 4
    # the run's last epochs from epoch 2: the first has no move to measure
    assert [r["epoch"] for r in res["f3_bn_split"]["rows"]] == [2]
    replay = _module("f3_bn_replay", ROOT / "tools" / "f3_bn_replay.py")
    sd, meta = replay.load_state(str(tmp_path / "f3_port_f32_seed4_epoch1.npz"))
    assert meta["epoch"] == 1 and meta["model"]["blocks"] == BLOCKS
    assert meta["n_params"] == sum(v.size for k, v in sd.items()
                                   if "running" not in k
                                   and "num_batches" not in k)
    assert all(v.dtype in (np.float32, np.int64) for v in sd.values())


def test_replay_from_the_recipe_state_matches_jax(tmp_path_factory):
    """(iii) After the codec recipe test's 12 steps, the port (float64,
    float32) and the JAX package (``shared_stats=True`` and plain
    BatchNorm) replay 8 batches with no weight update, 5 evals: every
    eval and running statistic within step 3's bounds, both packages
    folding the biased variance; the JAX package's plain BatchNorm in
    float64 within 1e-12 of the port's float64 statistics; each
    package's float32 moments of the first batch within the statistics'
    bound of float64 (the port's within 1e-6).  Then the precise
    statistics at those weights in two batch orders."""
    recipe = _module("codec_recipe_for_f3",
                     ROOT / "tests" / "test_torch_codec_recipe.py")
    replay = _module("f3_bn_replay", ROOT / "tools" / "f3_bn_replay.py")
    loop = recipe._Loop(tmp_path_factory.mktemp("f3_replay"))
    sd = {k: v.numpy().astype(np.int64 if k.endswith("num_batches_tracked")
                              else np.float32)
          for k, v in loop.port[torch.float64]["state"].items()}
    rng = np.random.default_rng(0)
    perm = np.concatenate([rng.permutation(NFIELDS) for _ in range(2)])
    batches = [loop.x[perm[i:i + BATCH]] for i in range(0, 2 * NFIELDS,
                                                         BATCH)]
    x_val, y_val, stats = loop.t_val
    model_kw = dict(imsize=IMSIZE, blocks=BLOCKS, growth_rate=GROWTH,
                    init_features=FEATURES, drop_rate=0.0,
                    upsample="nearest")
    res = replay.compare(sd, model_kw, batches,
                         (x_val, y_val, stats["y_variation"]), every=2,
                         test_batch=8, log=lambda _: None)
    assert set(res["cases"]) == {"port float64", "port float32",
                                 "JAX f32 shared_stats", "JAX f32 plain BN"}
    for name, case in res["cases"].items():
        assert len(case["u_r2"]) == 5, name
        assert case["within"], (name, case, res["bounds"])
    for k, b in res["bounds"].items():
        assert b == replay.BOUNDS[k] or b == 3 * res["port_f32_distance"][k]
    for name, fold in res["fold_check"].items():
        assert fold["biased"] < fold["unbiased"], (name, fold)
    # the fold moved the statistics, and with them the evals
    assert res["cases"]["port float64"]["u_r2_range"] > 0
    assert res["jax_float64"]["stats_err"] <= 1e-12
    assert 0 < res["moments_f32"]["port"]["var"] <= 1e-6
    assert 0 < res["moments_f32"]["jax"]["var"] <= res["bounds"]["stats"]
    orders = replay.precise_orders(sd, model_kw, loop.x,
                                   (x_val, y_val, stats["y_variation"]),
                                   seeds=(0, 1), batch=BATCH, test_batch=8,
                                   log=lambda _: None)
    assert len(orders["precise"]) == 2 and orders["u_range"] > 0
    assert orders["precise"][0] != orders["own"]

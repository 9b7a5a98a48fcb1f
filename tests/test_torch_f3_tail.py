"""ROADMAP F3's tail replay on the CPU at a small size: the full training
state that ``pde_surrogate_torch/tools/f3_bn_split.py --export`` writes
(the model ``.npz`` and ``<stem>_adam.npz``), and ``tools/f3_tail_replay.py``
training on from it in both packages.

One codec CLI run makes the state: a DenseED [1, 2, 1] (growth 4, 8
initial features) at 16², 32 train fields in batches of 4 (8 steps per
epoch, so that phase A's steps 1 and 8 fall in one epoch), 144 val
fields (``f3_bn_split`` reads val fields 138, 38 and 28), 4 epochs with
a checkpoint each; the export is epoch 2's.  Tolerances:

* the restored state steps bit for bit as the uninterrupted run does
  (the same process, the same thread count);
* Adam's moments moved into optax give the port's Adam update within
  1e-12 of each tensor's largest update in float64, and the new moments
  likewise; the two packages' lrs at the exported step within 1e-7
  relative (``f3_tail_replay.LR_TOL``);
* phase A: the JAX package's float64 within ``f3_tail_replay.BOUNDS``
  (those of ``tests/test_torch_codec_recipe.py``) of the port's float64
  after steps 1 and 8 and at the epoch's eval; its float32 within them
  at step 1;
* where the JAX package's float64 first parts from the port's
  (``first_parts``): the port's float64 Sobel exact against numpy, the
  JAX DenseED's float32 output within 1e-12 of the port's rounded to
  float32, its Sobel 1e-9 to 1e-5 from float64.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import train_codec_mixed_residual as train
from pde_surrogate_torch.cli._codec_common import (_state_kw, _train_data,
                                                   build_model,
                                                   resolve_dataset_files)
from pde_surrogate_torch.data.hdf5 import load_args, load_data
from pde_surrogate_torch.ops.filters import SobelFilter
from pde_surrogate_torch.tools import f3_bn_split
from pde_surrogate_torch.train.codec_trainer import (create_state,
                                                     make_mixed_residual_step)
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import f3_bn_replay  # noqa: E402
import f3_tail_replay as tail  # noqa: E402

EPOCH = 2               # the exported state's epoch
TINY = ["--device", "cpu", "--imsize", "16", "--ntrain", "32", "--ntest",
        "144", "--batch-size", "4", "--test-batch-size", "48", "--blocks",
        "1,2,1", "--growth-rate", "4", "--init-features", "8", "--epochs",
        "4", "--ckpt-freq", "1", "--no-plot"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 16² run, its stdout as a log, epoch 2's full export (through
    ``f3_bn_split.main``, which also checks the export's R² against the
    CLI's and splits epoch 3), and the run's splits."""
    tmp = tmp_path_factory.mktemp("f3_tail")
    flags = [*TINY, "--data-dir", str(tmp / "d"), "--exp-dir",
             str(tmp / "e")]
    # the splits first, so that the log starts as a card run's does
    resolve_dataset_files(train.Parser().parse_args(flags))
    log = tmp / "run.log"
    with open(log, "w") as f:
        stdout, sys.stdout = sys.stdout, f
        try:
            train.main(flags)
        finally:
            sys.stdout = stdout
    (args_file,) = (tmp / "e").rglob("args.txt")
    run_dir = args_file.parent
    state = tmp / f"tiny_epoch{EPOCH}.npz"
    f3_bn_split.main(["--run-dir", str(run_dir), "--epochs", "3",
                      "--device", "cpu", "--export", f"{EPOCH}:{state}"])
    args = load_args(str(run_dir))
    args.device = "cpu"
    train_file, val_file = resolve_dataset_files(args)
    x, _, _ = load_data(train_file, args.ntrain)
    xv, yv, stats = load_data(val_file, args.ntest, only_input=False,
                              return_stats=True)
    return {"dir": run_dir, "args": args, "state": str(state), "log": log,
            "x": x, "val": (xv, yv, stats["y_variation"])}


def _ckpt(run, epoch):
    return torch.load(run["dir"] / "checkpoints" / f"model_epoch{epoch}.pt",
                      weights_only=True)


def test_full_export_resumes_bit_for_bit(run):
    """(a) The export restored into a fresh ``CodecState`` takes epoch 3's
    steps bit for bit as the uninterrupted run did: the model, Adam's
    state and the step equal the CLI's epoch-3 checkpoint.  The Adam file
    holds every parameter's moments and step; the model file still loads
    in ``tools/f3_bn_replay.py``; an export without the Adam file still
    loads in ``f3_bn_split``."""
    args = run["args"]
    state = create_state(build_model(args, "cpu"), **_state_kw(args))
    meta = f3_bn_split.restore_export(run["state"], state)
    assert state.step == meta["state_step"] == EPOCH * 8
    assert {k: meta[k] for k in f3_bn_split.RUN_KEYS} == {
        k: getattr(args, k) for k in f3_bn_split.RUN_KEYS}
    sd, adam, _ = f3_bn_split.load_export(run["state"])
    names = [n for n, _ in state.model.named_parameters()]
    assert sorted(adam["params"]) == sorted(names)
    assert all(set(v) == set(f3_bn_split.ADAM) and v["step"] == EPOCH * 8
               for v in adam["params"].values())
    train_ds, _ = _train_data(args, "mixed_residual", torch.device("cpu"))
    step = make_mixed_residual_step(state, SobelFilter(16, correct=True),
                                    args.weight_bound, dropout_seed=args.seed)
    for (xb,) in train_ds.batches(EPOCH + 1):
        step(xb)
    want = _ckpt(run, EPOCH + 1)
    assert state.step == want["step"]
    got = state.model.state_dict()
    for k, v in want["model"].items():
        assert torch.equal(got[k], v), k
    opt = state.optimizer.state_dict()["state"]
    for i, entry in want["optimizer"]["state"].items():
        for k, v in entry.items():
            assert torch.equal(opt[i][k], v), (i, k)
    # the model file alone, as the frozen-weight replay reads it
    sd2, meta2 = f3_bn_replay.load_state(run["state"])
    assert sd2.keys() == sd.keys() and meta2["epoch"] == EPOCH
    f3_bn_replay.port_model(sd2, torch.float32,
                            {k: meta2["model"][k]
                             for k in f3_bn_replay.MODEL_KEYS})
    old = pathlib.Path(run["state"]).with_name("old_epoch2.npz")
    old.write_bytes(pathlib.Path(run["state"]).read_bytes())
    sd3, none, meta3 = f3_bn_split.load_export(str(old))
    assert none is None and meta3 == meta2 and sd3.keys() == sd.keys()
    with pytest.raises(FileNotFoundError, match="no Adam state"):
        f3_bn_split.restore_export(str(old), state)


def test_adam_moments_into_optax_match_the_port_update(run):
    """(b) In float64, the port's Adam restored from the export and the
    JAX package's optax state made by ``create_state`` with the export's
    moments and step (``f3_tail_replay``'s moves) take one update from
    the same seeded gradients: the updates and the new moments agree
    within 1e-12 of each tensor's largest value; the two packages' lrs
    at the exported step and the schedule's last within 1e-7."""
    port = tail.PortCase(run["state"], True)
    rows = tail.lr_check(port.run, [port.step_count,
                                    tail.total_steps(port.run) - 1])
    assert all(r["rel"] <= tail.LR_TOL for r in rows)
    model = port.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    grads = {n: rng.normal(size=p.shape) * 1e-3 for n, p in
             model.named_parameters()}
    opt = port.state.optimizer
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    lr = port.lr()
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    want = {n: (p.detach() - before[n]).numpy()
            for n, p in model.named_parameters()}
    with jax.enable_x64(True):
        case = tail.JaxCase(run["state"], True, False)
        g, _ = tail.convert_codec_state_dict(grads)
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), g)
        updates, new_opt = case.tx.update(g, case.state.opt_state,
                                          case.state.params)
        (adam,) = [s for s in jax.tree_util.tree_leaves(
            new_opt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
        stats = case.state.batch_stats
        got = {k: v.numpy() for k, v in codec_state_dict_from_jax(
            jax.device_get(updates), jax.device_get(stats)).items()}
        moments = [{k: v.numpy() for k, v in codec_state_dict_from_jax(
            jax.device_get(t), jax.device_get(stats)).items()}
            for t in (adam.mu, adam.nu)]
        assert float(case._schedule(case.state.step)) == lr
    for n, w in want.items():
        assert np.abs(w).max() > 0, n
        assert np.max(np.abs(got[n] - w)) <= 1e-12 * np.abs(w).max(), n
        entry = opt.state[model.get_parameter(n)]
        for mom, key in zip(moments, ("exp_avg", "exp_avg_sq")):
            ref = entry[key].numpy()
            assert np.max(np.abs(mom[n] - ref)) <= 1e-12 * np.abs(ref).max()


@pytest.fixture(scope="module")
def phase_a(run):
    return {c: tail.run_case(c, run["state"], run["x"], run["val"],
                             [EPOCH + 1], (1, 8), log=lambda _: None)
            for c in tail.CASES}


def test_phase_a_holds_at_16(phase_a):
    """(c) Phase A from the 2-epoch state: the JAX package's float64
    (plain BatchNorm) within the recipe test's bounds of the port's
    float64 after steps 1 and 8 and at the epoch's eval; its float32
    (``shared_stats=True``) within them at step 1; every case trained
    (the losses of step 8 differ from step 1's)."""
    out = tail.compare_phase_a(phase_a, log=lambda _: None, steps=(1, 8))
    assert out["holds"], out["cases"]["jax64"]
    j32 = out["cases"]["jax32"]["at"][1]
    for k in ("steps", "params", "stats"):
        assert j32[k] <= tail.BOUNDS[k], (k, j32)
    for c, res in phase_a.items():
        assert res["start_step"] == EPOCH * 8 and len(res["losses"]) == 8
        assert res["losses"][7, 0] != res["losses"][0, 0], c
        assert sorted(res["snapshots"]) == [1, 8]


def test_tail_log_parses(run, tmp_path, monkeypatch):
    """(c) ``--case jax32`` over a 2-epoch tail writes a JSON line per
    epoch and a closing summary that ``parse_log`` reads back, with
    ``R_tail`` and the run's own ``R_card`` over the same epochs; both
    lrs printed first."""
    monkeypatch.setattr(tail, "canonical_data",
                        lambda data_dir: (run["x"], run["val"]))
    out = tmp_path / "tail.log"
    rc = tail.main(["--case", "jax32", "--state", run["state"], "--epochs",
                    "3-4", "--card-log", str(run["log"]), "--out",
                    str(out)])
    assert rc == 0
    parsed = tail.parse_log(str(out))
    assert [r["epoch"] for r in parsed["epochs"]] == [3, 4]
    assert [r["step"] for r in parsed["epochs"]] == [24, 32]
    summ = parsed["summary"]
    u = [r["r2"][0] for r in parsed["epochs"]]
    assert summ["R_tail"] == max(u) - min(u)
    card = tail.card_r2(str(run["log"]), [3, 4])
    assert summ["R_card"] == card["R_card"] and len(card["r2"]) == 2
    assert sorted(map(int, summ["card_r2"])) == [3, 4]
    text = out.read_text()
    assert text.count("lr at step") == 2
    assert text.index("lr at step") < text.index('{"f3_tail_epoch"')


def test_batch_order_is_the_cli_order(run, phase_a):
    """(d) The tool's batches for each epoch are the CLI's
    ``DeviceDataset`` batches for the run's seed, and the port's float32
    case, trained over epoch 3 in that order, lands on the CLI's epoch-3
    checkpoint bit for bit."""
    args = run["args"]
    train_ds, _ = _train_data(args, "mixed_residual", torch.device("cpu"))
    for epoch in (1, EPOCH + 1, 4):
        order = tail.batch_order(len(run["x"]), vars(args), epoch)
        cli = [xb.numpy() for (xb,) in train_ds.batches(epoch)]
        assert len(order) == len(cli) == 8
        for idx, xb in zip(order, cli):
            assert np.array_equal(run["x"][idx], xb)
    assert not np.array_equal(tail.batch_order(32, vars(args), 1),
                              tail.batch_order(32, vars(args), 2))
    want = _ckpt(run, EPOCH + 1)["model"]
    got = phase_a["port32"]["snapshots"][8]
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(got[k], v.double().numpy()), k


def test_first_parts_finds_the_float32_casts(run):
    """Under phase A's failure the first tensors that part, found by
    ``f3_tail_replay.first_parts`` at 16² on the first batch after the
    state: the port's float64 Sobel gradients equal numpy's float64 ones
    exactly, while the JAX package's float64 DenseED returns its output
    in float32 (the port's output rounded to float32, within 1e-12 of its
    largest value) and its Sobel gradients lie 1e-9 to 1e-5 from float64;
    the boundary losses, which read no Sobel, agree within 1e-12."""
    res = tail.first_parts(run["state"], run["x"][:4])
    assert res["sobel_port"] == {"grad_h": 0.0, "grad_v": 0.0}
    assert res["output_dtype"] == "float32"
    assert res["output_vs_rounded"] <= 1e-12 < res["output"] <= 1e-6
    assert all(1e-9 <= e <= 1e-5 for e in res["sobel_jax"].values())
    assert res["losses"]["loss_dirichlet"] <= 1e-12
    assert res["losses"]["loss_neumann"] <= 1e-12

"""The port's diagnostics of its canonical runs on the CPU: the emulated
TPU DEFAULT conv precision (``tools/f1_tpu_precision.py``), the per-sample
split of the val SSE (``tools/r2_breakdown.py``), the reading of R1's logs
(``tools/r1_seeds.parse_log``), and the runner of R2 and R3
(``tools/canon_runs.py``): side by side, stopped and resumed, and its
reading of the JAX package's bar logs."""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import train_codec_mixed_residual as train
from pde_surrogate_torch.models import codec
from pde_surrogate_torch.tools import canon_runs
from pde_surrogate_torch.tools import f1_tpu_precision as tp
from pde_surrogate_torch.tools import r1_seeds
from pde_surrogate_torch.tools.r1_seeds import parse_log
from pde_surrogate_torch.tools.r2_breakdown import breakdown
from pde_surrogate_torch.utils.metrics import r2_score

torch.set_num_threads(1)

LOGS = pathlib.Path(__file__).resolve().parents[1] / "logs"
TINY = ["--device", "cpu", "--imsize", "16", "--ntrain", "32", "--ntest",
        "16", "--batch-size", "8", "--test-batch-size", "8", "--blocks",
        "1,2,1", "--growth-rate", "4", "--init-features", "8", "--epochs",
        "2", "--ckpt-freq", "1", "--no-plot"]


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _by_hand(model):
    """``model`` with every ``Conv2d``'s weight rounded to bf16 in place,
    its input rounded on the way in (the gradient passing straight
    through) and its incoming gradient rounded on the way back."""
    for m in model.modules():
        if isinstance(m, codec.Conv2d):
            with torch.no_grad():
                m.weight.copy_(_bf16(m.weight))
            m.register_forward_pre_hook(
                lambda _, a: (a[0] + (_bf16(a[0]) - a[0]).detach(),))
            m.register_full_backward_pre_hook(
                lambda _, g: (_bf16(g[0]),))
    return model


@pytest.mark.parametrize("train_mode", [True, False])
def test_tpu_default_convs_rounds_every_conv_operand(train_mode):
    """Under ``tpu_default_convs()`` the DenseED (its strided 7x7 in-conv
    with padding 3, the convs after the nearest upsampling) gives what a
    plain forward gives on bf16-rounded conv inputs and weights, within
    1e-6 of the output's largest value, and so do the weight gradients
    (the incoming gradient rounded as well); the plain f32 forward
    differs."""
    torch.manual_seed(0)
    x = torch.exp(torch.randn(4, 1, 16, 16)).requires_grad_()
    model = codec.DenseED(1, 3, 16, [1, 2, 1], growth_rate=4,
                          init_features=8).train(train_mode)
    hand = codec.DenseED(1, 3, 16, [1, 2, 1], growth_rate=4,
                         init_features=8).train(train_mode)
    hand.load_state_dict(model.state_dict())
    _by_hand(hand)
    plain = model(x)
    with tp.tpu_default_convs():
        got = model(x)
        got.square().sum().backward()
    want = hand(x)
    want.square().sum().backward()
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-6 * scale
    assert (plain - want).abs().max() > 1e-4 * scale
    grads = {n: p.grad for n, p in hand.named_parameters() if "conv" in n}
    assert grads
    for n, p in model.named_parameters():
        if n in grads:
            g = grads[n]
            assert (p.grad - g).abs().max() <= 1e-6 * g.abs().max(), n


def test_tpu_default_convs_restores_the_plain_forward():
    """On exit, also after an exception and after a refused row block,
    ``Conv2d.forward`` is the plain one again."""
    plain = codec.Conv2d.forward
    with tp.tpu_default_convs():
        assert codec.Conv2d.forward is not plain
    assert codec.Conv2d.forward is plain
    with pytest.raises(RuntimeError, match="inside"):
        with tp.tpu_default_convs():
            raise RuntimeError("inside")
    assert codec.Conv2d.forward is plain
    conv = codec.Conv2d(1, 1, 3, padding=1, bias=False)
    conv.rows = object()
    with pytest.raises(ValueError, match="whole fields"):
        with tp.tpu_default_convs():
            conv(torch.ones(1, 1, 4, 4))
    assert codec.Conv2d.forward is plain
    with pytest.raises(SystemExit):
        tp.main(["--cli", "bogus"])


@pytest.mark.parametrize("precision", ["f32", "tpuprec"])
def test_r2_breakdown_reproduces_the_cli(tmp_path, precision):
    """On a run the codec CLI writes at 16² (2 epochs; under
    ``tools/f1_tpu_precision.py --cli codec`` for ``tpuprec``):
    ``r2_breakdown``'s mean-offset and remaining SSE sum to each sample's
    SSE within 1e-6 relative, its R² is ``r2_score`` of its SSE and
    equals the CLI's last epoch's within 1e-6 relative, and its largest
    samples are listed by SSE."""
    argv = TINY + ["--data-dir", str(tmp_path / "d"),
                   "--exp-dir", str(tmp_path / "e")]
    if precision == "f32":
        train.main(argv)
    else:
        tp.main(["--cli", "codec", *argv])
    (run_dir,) = [p.parent for p in (tmp_path / "e").rglob("args.txt")]
    res = breakdown(str(run_dir), device="cpu",
                    tpu_precision=precision == "tpuprec")
    s = res["samples"]
    assert res["epoch"] == 2 and res["n"] == 16
    np.testing.assert_allclose(s["offset"] + s["rest"], s["sse"], rtol=1e-6)
    yvar = np.array([ch["y_variation"] for ch in res["channels"].values()])
    np.testing.assert_allclose(res["r2"], r2_score(
        s["sse"].sum(0), yvar), rtol=1e-6)
    np.testing.assert_allclose(res["r2"], res["cli_r2"], rtol=1e-6)
    assert res["r2_rel_diff"] <= 1e-6
    for c, ch in enumerate(res["channels"].values()):
        np.testing.assert_allclose(ch["offset_sse"] + ch["rest_sse"],
                                   ch["sse"], rtol=1e-6)
        top = [t["index"] for t in ch["top"]]
        assert top == list(np.argsort(-s["sse"][:, c], kind="stable")[:10])
        assert 1 <= ch["n_half"] <= 16
        assert all(0 <= t["log_k_rank"] < 16 for t in ch["top"])


def test_r2_breakdown_ranks_the_canonical_val_fields():
    """``--val-ranks`` regenerates the canonical val split's inputs
    (kle512 at 64², 512 fields, the CLI's seed) and ranks the fields by
    mean log K: the three that carry most of u's val SSE in R1 (fields
    138, 38 and 28) are its three lowest, the one that leads σ₁'s (486)
    its highest."""
    from pde_surrogate_torch.tools.r2_breakdown import main
    got = main(["--val-ranks", "138", "38", "28", "486"])
    assert [got[i][1] for i in (138, 38, 28, 486)] == [0, 1, 2, 511]
    assert got[138][0] < got[38][0] < got[28][0] < 0 < got[486][0]


def test_r1_seeds_runs_side_by_side(tmp_path, capsys, monkeypatch):
    """``tools/r1_seeds.py`` at 16² (2 epochs): an f32 and an emulated
    run side by side on one data dir, each log named by its precision and
    seed and parsed, the emulated one's breakdown written with the CLI's
    R² reproduced."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the runs' processes
    rc = r1_seeds.main(["--device", "cpu", "--runs", "f32:3", "tpuprec:3",
                        "--breakdown", "tpuprec:3", "--out", str(tmp_path),
                        "--extra", *TINY[2:]])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    runs = got["r1_seeds"]
    assert rc == 0 and set(runs) == {"r1_port_f32_seed3",
                                     "r1_port_tpuprec_seed3"}
    for name, run in runs.items():
        assert run["rc"] == 0 and run["epochs"] == 2, name
        assert len(run["r2"]) == 3 and run["minutes"] is not None
    assert runs["r1_port_tpuprec_seed3"]["breakdown_rc"] == 0
    assert runs["r1_port_f32_seed3"]["r2"] != runs[
        "r1_port_tpuprec_seed3"]["r2"]
    text = (tmp_path / "r1_port_tpuprec_seed3_breakdown.log").read_text()
    assert "largest relative difference 0.00e+00" in text
    assert (tmp_path / "r1_port_tpuprec_seed3.log").read_text().startswith(
        "DenseED convs: bf16-rounded operands")


@pytest.mark.parametrize("log", ["canon_kle512_300ep_r4.log",
                                 "sharedstats_kle512_300ep.log"])
def test_r1_seeds_parses_the_band_logs(log):
    """``tools/r1_seeds.parse_log`` reads the JAX package's two canonical
    TPU runs (the band) as the records quote them."""
    got = parse_log((LOGS / log).read_text())
    assert got["epochs"] == 300 and got["selected_epoch"] == 300
    if log.startswith("canon"):
        assert got["r2"] == [0.9671568, 0.9547219, 0.8555239]
        assert got["u_r2_last20"] == [0.96441114, 0.96942914]
        assert got["loss_at"][200] == 0.134317
        assert got["loss_at"][300] == 0.048535
        assert got["consistency"] == 0.0772 and got["rises_1p5"] == 2
        assert got["minutes"] == 24.62
    else:
        assert got["r2"] == [0.9568631, 0.95342135, 0.8568643]
        assert got["rel_l2"] == [0.0279729, 0.10889454, 0.35680166]
        assert got["loss_at"][300] == 0.05024 and got["rises_1p5"] == 6
        assert got["median_samples_per_s"] == 4729.0


CANON_CGLOW = ("--imsize 16 --enc-blocks 2,2,2 --flow-blocks 2,2,2 "
               "--ntrain 16 --ntest 8 --batch-size 8 --test-batch-size 8 "
               "--epochs 2 --ckpt-freq 1")
CANON_POST = ("--n-monte-carlo 16 --ntest 8 --var-samples 2 --n-pred 1 "
              "--num-loc 1")
CANON_TINY = ["--device", "cpu", "--codec-extra", " ".join(TINY[2:]),
              "--cglow-extra", CANON_CGLOW, "--post-extra", CANON_POST]


def _canon(tmp_path, capsys, *argv, work="work"):
    rc = canon_runs.main([*CANON_TINY, "--out", str(tmp_path / "out"),
                          "--work", str(tmp_path / work), *argv])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, got["canon_runs"]


def test_canon_runs_side_by_side(tmp_path, capsys, monkeypatch):
    """``tools/canon_runs.py`` at 16² (2 epochs): an fvcg codec run and a
    cGlow run side by side, each log named by its kind and seed and
    parsed, the fvcg run's breakdown written with the CLI's R² reproduced,
    the cGlow's UQ suite run on its last checkpoint and parsed (every task
    timed), and the finished runs' checkpoints removed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the runs' processes
    rc, runs = _canon(tmp_path, capsys, "--runs", "fvcg:3", "cglow:3",
                      "--breakdown", "fvcg:3")
    assert rc == 0
    assert set(runs) == {"r2_port_fvcg_seed3", "r3_port_cglow_seed3"}
    fvcg, glow = runs["r2_port_fvcg_seed3"], runs["r3_port_cglow_seed3"]
    assert fvcg["train_rc"] == 0 and fvcg["epochs"] == 2
    assert fvcg["selected_epoch"] in (1, 2) and len(fvcg["r2"]) == 3
    assert fvcg["breakdown_rc"] == 0
    assert glow["epochs"] == 2 and glow["skipped_steps"] == 0
    assert glow["train_rc"] == glow["post_rc"] == 0
    assert glow["minutes"] is not None and glow["median_samples_per_s"] > 0
    post = glow["post"]
    assert post["num_nan_inf"] == 0 and len(post["r2"]) == 3
    assert set(post["seconds"]) == {"predict_at_x", "dist", "test_metric",
                                    "reliability", "propagate"}
    out = tmp_path / "out"
    text = (out / "r2_port_fvcg_seed3_breakdown.log").read_text()
    assert "largest relative difference 0.00e+00" in text
    assert "--physics fvcg" not in text
    assert '"physics": "fvcg"' in next(
        (tmp_path / "work").rglob("args.txt")).read_text()
    assert (out / "r3_port_cglow_seed3_metrics.jsonl").is_file()
    assert glow["glow_check_rc"] == 0
    check = glow["glow_check"]
    assert check["checkpoint"] == "model_epoch2.pt"
    assert 0 < check["largest_head"] == max(check["heads"].values())
    assert [r[1] for r in check["card_vs_cpu"]] == [0.0] * 7
    assert not list((tmp_path / "work").rglob("*.pt"))


def test_canon_runs_stop_and_resume(tmp_path, capsys, monkeypatch):
    """An fvcg and a cGlow run of 10 epochs, stopped right after the first
    checkpoint at or after epoch 1 that the runner sees (``--stop-after
    1``; it looks every ``POLL_S``, so a tiny run may be a few epochs on):
    each log ends in the stop line, the cGlow keeps only that checkpoint.
    Resumed in a second call from a copy of the first call's work dir
    (``--resume-from``), each ends at epoch 10 with its log in two parts,
    the cGlow's UQ suite run on its last checkpoint, and the fvcg run as
    the unbroken run ends (the same last R² and rel-L2)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    codec = " ".join(TINY[2:]).replace("--epochs 2", "--epochs 10")
    argv = ["--codec-extra", codec, "--cglow-extra",
            CANON_CGLOW.replace("--epochs 2", "--epochs 10")]
    names = ("r2_port_fvcg_seed4", "r3_port_cglow_seed4")
    rc, first = _canon(tmp_path, capsys, "--runs", "fvcg:4", "cglow:4",
                       *argv, "--stop-after", "1", work="w1")
    assert rc == 0
    for name in names:
        run = first[name]
        assert run["stopped"] == "train"
        assert 1 <= run["stopped_after"] < 10
        log = (tmp_path / "out" / f"{name}.log").read_text()
        assert (f"[canon_runs] stopped after epoch {run['stopped_after']}; "
                f"epochs 1-{run['stopped_after']} took") in log
    assert first[names[1]]["minutes"] is not None
    assert (tmp_path / "out" / f"{names[1]}_metrics.jsonl").is_file()
    stop = first[names[1]]["stopped_after"]
    (ckpts,) = [p for p in (tmp_path / "w1").rglob("checkpoints")
                if "cglow" in str(p)]
    assert sorted(p.name for p in ckpts.iterdir()) == [
        f"model_epoch{stop}.json", f"model_epoch{stop}.pt"]
    rc, resumed = _canon(tmp_path, capsys, "--runs", "fvcg:4", "cglow:4",
                         *argv, "--resume-from", str(tmp_path / "w1"),
                         work="w2")
    assert rc == 0
    for name in names:
        (ckpts,) = [p for p in (tmp_path / "w1").rglob("checkpoints")
                    if name.split("_")[2] in str(p)]
        assert max(int(p.stem[11:]) for p in ckpts.iterdir()) == \
            first[name]["stopped_after"], name
        assert resumed[name]["epochs"] == 10, name
        assert resumed[name]["parts"] == 2, name
    assert resumed[names[1]]["post"]["num_nan_inf"] == 0
    rc, whole = _canon(tmp_path / "whole", capsys, "--runs", "fvcg:4",
                       *argv, work="w3")
    got, want = resumed[names[0]], whole[names[0]]
    assert rc == 0 and "parts" not in want
    np.testing.assert_allclose(got["r2"], want["r2"], rtol=1e-6)
    np.testing.assert_allclose(got["rel_l2"], want["rel_l2"], rtol=1e-6)


@pytest.mark.parametrize("log,want", [
    ("fvcg2_kle512_300ep.log",
     {"epochs": 300, "r2": [0.9853437, 0.9919974, 0.9700538],
      "rel_l2": [0.02094203, 0.04194181, 0.16950744],
      "consistency": 0.0286, "selected_epoch": 300, "minutes": 23.34}),
    ("cglow_kle512_im64_canonical_200ep.log",
     {"epochs": 200, "r2": [0.98463094, 0.9841795, 0.9191243],
      "rel_l2": [0.01965215, 0.06463943, 0.26084864],
      "neg_entropy": 7.680119, "skipped_steps": 0, "nonfinite_epochs": 0,
      "selected_epoch": 200, "minutes": 56.46}),
    ("post_cglow_kle512_canonical.log",
     {"r2": [0.98485523, 0.98416805, 0.9190837],
      "rel_l2": [0.01952975, 0.06485741, 0.26111066],
      "num_nan_inf": 0, "abnormal_rate": 0.0}),
    ("r3_port_cglow_seed1_full.log",
     {"epochs": 200, "r2": [0.9921361, 0.9910968, 0.93341607],
      "u_r2_last20": [0.9849652, 0.9921361], "skipped_steps": 0,
      "rises_1p5": 13, "minutes": 85.17, "parts": 2}),
    ("r3_port_post_cglow_seed1_full.log",
     {"r2": [0.99213004, 0.99110013, 0.93342984], "num_nan_inf": 0,
      "abnormal_rate": 0.0}),
    ("r3_port_glow_check_seed1_full.log",
     {"checkpoint": "model_epoch200.pt", "largest_head": 0.5845924019813538}),
])
def test_canon_runs_parses_the_bar_logs(log, want):
    """``tools/canon_runs.parse_file`` reads the JAX package's R2 and R3
    bars (TPU runs) and the port's R3 from epoch 1 to 200 with its UQ
    suite and F2's check (card runs) as the records quote them."""
    got = canon_runs.parse_file(str(LOGS / log))
    assert {k: got[k] for k in want} == want


MONITOR_CSV = canon_runs.MONITOR_HEADER + """
train, 1, 2026/10/17 23:40:01.123, 1980 MHz, 2619 MHz, 250.12 W, 45 %, 40, \
0x0000000000000000, 1.10, 1.20, 1.30, 2/300, 1234
train, 3, 2026/10/17 23:40:31.123, 1755 MHz, 2619 MHz, 310.00 W, 55 %, 45, \
0x0000000000000004, 3.10, 1.20, 1.30, 2/300, 1235
train, 26, 2026/10/17 23:41:01.123, 1980 MHz, 2619 MHz, [N/A], 35 %, 41, \
0x0000000000000000, 2.00, 1.20, 1.30, 2/300, 1236
post, 200, 2026/10/17 23:41:31.123, 1980 MHz, 2619 MHz, 400.00 W, 99 %, 50, \
0x0000000000000001, 2.00, 1.20, 1.30, 2/300, 1237
"""


def test_canon_runs_parses_the_monitor(tmp_path):
    """``parse_monitor`` on a canned monitor CSV (the runner's header, then
    its ``phase, epoch, nvidia-smi fields, /proc/loadavg`` rows): per range
    of 25 epochs and per follow-up phase the median SM clock, utilisation,
    power and load, the throttle masks other than 0, the sample count and
    the range's median samples/s; a field nvidia-smi gives as ``[N/A]`` is
    left out.  ``parse_file`` reads the CSV beside a log (the epoch-75 cGlow
    log, renamed) into ``parse_log``'s ``monitor``."""
    metrics = [{"epoch": 1, "samples_per_sec": 300.0},
               {"epoch": 2, "samples_per_sec": 200.0},
               {"epoch": 30, "samples_per_sec": 100.0}]
    got = canon_runs.parse_monitor(MONITOR_CSV, metrics)
    assert got == {
        "1-25": {"sm_mhz": 1867.5, "util_pct": 50.0, "power_w": 280.06,
                 "load1": 2.1, "throttle": ["0x0000000000000004"],
                 "samples": 2, "samples_per_s": 250.0},
        "26-50": {"sm_mhz": 1980.0, "util_pct": 35.0, "power_w": None,
                  "load1": 2.0, "throttle": [], "samples": 1,
                  "samples_per_s": 100.0},
        "post": {"sm_mhz": 1980.0, "util_pct": 99.0, "power_w": 400.0,
                 "load1": 2.0, "throttle": ["0x0000000000000001"],
                 "samples": 1, "samples_per_s": None}}
    assert "samples_per_s" not in canon_runs.parse_monitor(MONITOR_CSV)["post"]
    log = tmp_path / "r3_port_cglow_seed9.log"
    log.write_text((LOGS / "r3_port_cglow_seed1.log").read_text())
    (tmp_path / "r3_port_cglow_seed9_monitor.csv").write_text(MONITOR_CSV)
    parsed = canon_runs.parse_file(str(log))
    assert parsed["epochs"] == 75
    assert parsed["monitor"]["1-25"]["sm_mhz"] == 1867.5
    assert "monitor" not in canon_runs.parse_file(
        str(LOGS / "r3_port_cglow_seed1.log"))


def test_glow_outputs_take_a_state_dict():
    """``tools/glow_check.glow_outputs`` at 16² (enc [2,2], flow [2,2]):
    given the seeded model's own state dict, every output equals the
    seeded outputs exactly; a state dict with the heads scaled moves them;
    ``effective_heads`` names every ``Conv2dZeros`` and reads its largest
    |w| * exp(3 * scale)."""
    from pde_surrogate_torch.tools import glow_check as gc
    kw = dict(imsize=16, enc_blocks=[2, 2], flow_blocks=[2, 2],
              head_scale=1e-3)
    model = gc.glow_model(16, [2, 2], [2, 2], 1e-3, "cpu")
    seeded = gc.glow_outputs("cpu", torch.float32, **kw)
    given = gc.glow_outputs("cpu", torch.float32, **kw,
                            state_dict=model.state_dict())
    assert seeded.keys() == given.keys()
    for name in seeded:
        assert torch.equal(seeded[name], given[name]), name
    heads = gc.effective_heads(model)
    assert len(heads) == 5 and "encoder.top_latent" in heads
    state = {k: torch.full_like(v, 0.5) if k.endswith("conv_zero.scale")
             else v for k, v in model.state_dict().items()}
    moved = gc.glow_outputs("cpu", torch.float32, **kw, state_dict=state)
    assert not torch.equal(moved["generate y"], seeded["generate y"])
    model.load_state_dict(state)
    scaled = gc.effective_heads(model)
    w = model.revblock1.revlayer1.coupling.coupling_nn.conv_zero.conv.weight
    name = "revblock1.revlayer1.coupling.coupling_nn.conv_zero"
    assert scaled[name] == pytest.approx(
        float(w.detach().abs().max()) * np.exp(1.5), rel=1e-6)


@pytest.mark.parametrize("smi", ["answers", "fails"])
def test_canon_runs_samples_the_card(tmp_path, monkeypatch, smi):
    """``sample_card`` with a stand-in ``nvidia-smi`` first on the PATH:
    it asks for ``SMI_FIELDS`` and returns nvidia-smi's line with the
    host's ``/proc/loadavg`` appended, which ``parse_monitor`` reads once
    the runner has put the phase and epoch in front; an ``nvidia-smi`` that
    fails raises."""
    line = ("2026/10/17 23:40:01.123, 1980 MHz, 2619 MHz, 250.12 W, 45 %, "
            "40, 0x0000000000000000")
    body = (f'[ "$1" = "--query-gpu={canon_runs.SMI_FIELDS}" ] || exit 9\n'
            f'echo "{line}"' if smi == "answers" else "exit 6")
    fake = tmp_path / "nvidia-smi"
    fake.write_text(f"#!/bin/sh\n{body}\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    if smi == "fails":
        with pytest.raises(RuntimeError, match="nvidia-smi failed"):
            canon_runs.sample_card()
        return
    row = canon_runs.sample_card()
    assert row.startswith(line + ", ")
    assert len(row.split(", ")) == 12
    csv_text = f"{canon_runs.MONITOR_HEADER}\ntrain, 3, {row}\n"
    got = canon_runs.parse_monitor(csv_text)["1-25"]
    assert got["sm_mhz"] == 1980.0 and got["util_pct"] == 45.0

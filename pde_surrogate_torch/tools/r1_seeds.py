"""The canonical Sobel codec run (R1) from several seeds, side by side, in
float32 or at an emulated TPU DEFAULT conv precision, and what each run's
log says.

R1 is ``cli.train_codec_mixed_residual`` with its defaults (DenseED
[6,8,6]/16/48, 64², kle512, ntrain 4096, batch 32, 300 epochs, 3x3 Sobel,
boundary weight 10), only ``--seed`` set.  Each ``--runs`` entry
``<precision>:<seed>`` (``f32``, or ``tpuprec`` for
``tools/f1_tpu_precision.py --cli codec``) trains in its own process and
exp dir, all at once on one card, on one data dir whose splits are
generated (the val labels by K1) before they start.  Each run's log goes
to ``<out>/<name>_<precision>_seed<seed>.log`` (``--name``, by default
``r1_port``).  For every entry also in
``--breakdown``, ``tools/r2_breakdown.py`` then splits the val SSE of the
last epoch's checkpoint (``..._breakdown.log`` beside the log).  For
every entry in ``--split``, ``tools/f3_bn_split.py`` then splits the val
R² of the checkpoints of the last 20 epochs into the BatchNorm running
statistics and the weights (``..._split.log``; give the runs
``--extra --ckpt-freq 1``), and with ``--export-epoch N`` writes epoch N's
model state beside it (``..._epoch<N>.npz``) and its Adam state
(``..._epoch<N>_adam.npz``).  ``--sha256 E ...`` writes the sha256 of
every tensor of each run's epoch-E checkpoints (model, Adam, step) into
``..._sha256.log``.  One JSON line at the end holds ``parse_log`` of every
run; ``--parse`` only reads logs (the JAX package's too) and prints that
line; ``--compare A B [A B ...]`` holds pairs of logs of one seed against
each other, every epoch's metric lines and the selection, and the
``_sha256.log`` beside them (a run repeats bit for bit from its seed).

Run:  python3 -m pde_surrogate_torch.tools.r1_seeds --runs tpuprec:1 \
          tpuprec:2 --breakdown tpuprec:1 --out logs
      python3 -m pde_surrogate_torch.tools.r1_seeds --runs f32:4 f32:1 \
          --split f32:4 f32:1 --export-epoch 280 --name f3_port --out logs \
          --extra --ckpt-freq 1
      python3 -m pde_surrogate_torch.tools.r1_seeds --parse \
          logs/r1_port_f32_seed1.log logs/canon_kle512_300ep_r4.log
      python3 -m pde_surrogate_torch.tools.r1_seeds --compare \
          logs/d1a_f32_seed4.log logs/d1b_f32_seed4.log
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

MODULES = {"f32": "pde_surrogate_torch.cli.train_codec_mixed_residual",
           "tpuprec": "pde_surrogate_torch.tools.f1_tpu_precision"}
PREFIX = {"f32": [], "tpuprec": ["--cli", "codec"]}
_NUM = r"[-+\d.eEinfa]+"


def _vec(text: str) -> list[float]:
    return [float(v) for v in text.split()]


def parse_log(text: str) -> dict:
    """From a codec CLI's log (either package's): R^2, rel-L2 and the
    flux-pressure consistency at the last epoch; u's R^2 range over the
    last 20 epochs; the training loss at epochs 200 and 300 and at the
    last; how many epochs' loss rose above 1.5x the epoch before; the
    label-free selected epoch and its R^2; the minutes of training and the
    median samples/s."""
    body, _, tail = text.partition("Finished training")
    per = {}
    for key, pat in (("loss", rf"Epoch (\d+): training loss: ({_NUM})"),
                     ("r2", r"Epoch (\d+): test r2-score: \[([^\]]+)\]"),
                     ("rel", r"Epoch (\d+): test relative-l2: \[([^\]]+)\]"),
                     ("cons", rf"Epoch (\d+): flux-pressure consistency: "
                              rf"({_NUM})"),
                     ("rate", rf"Epoch (\d+), lr {_NUM}, ({_NUM}) "
                              rf"samples/sec")):
        per[key] = {int(e): (_vec(v) if key in ("r2", "rel") else float(v))
                    for e, v in re.findall(pat, body)}
    if not per["loss"]:
        return {"epochs": 0}
    last = max(per["loss"])
    seq = [per["loss"][e] for e in sorted(per["loss"])]
    window = [per["r2"][e][0] for e in range(last - 19, last + 1)
              if e in per["r2"]]
    minutes = re.search(rf" using ({_NUM}) mins", tail)
    sel = re.search(r"consistency\): epoch (\d+)", tail)
    sel_r2 = re.search(r"Epoch \d+: test r2-score: \[([^\]]+)\]",
                       tail.partition("Metrics at the selected")[2])
    rates = [per["rate"][e] for e in sorted(per["rate"]) if e > 1]
    return {"epochs": last,
            "r2": per["r2"].get(last), "rel_l2": per["rel"].get(last),
            "consistency": per["cons"].get(last),
            "u_r2_last20": [min(window), max(window)] if window else None,
            "loss_at": {e: per["loss"].get(e) for e in (200, 300, last)},
            "rises_1p5": sum(b > 1.5 * a for a, b in zip(seq, seq[1:])),
            "selected_epoch": int(sel.group(1)) if sel else None,
            "selected_r2": _vec(sel_r2.group(1)) if sel_r2 else None,
            "minutes": float(minutes.group(1)) if minutes else None,
            "median_samples_per_s": (float(np.median(rates)) if rates
                                     else None)}


_METRIC_LINE = re.compile(r"^Epoch (\d+): (.*)$", re.M)
_SELECTION = re.compile(r"^Label-free checkpoint selection.*$", re.M)


def compare_logs(a: str, b: str) -> dict:
    """Two logs' metric lines (``Epoch N: ...``: training loss, test R^2,
    rel-L2, consistency; not the lines with the host's samples/s) epoch by
    epoch, and their checkpoint selection."""
    lines = []
    for text in (a, b):
        per: dict[int, list[str]] = {}
        for e, line in _METRIC_LINE.findall(text):
            per.setdefault(int(e), []).append(line)
        lines.append(per)
    epochs = sorted(lines[0].keys() | lines[1].keys())
    differ = [e for e in epochs if lines[0].get(e) != lines[1].get(e)]
    return {"epochs": len(epochs), "epochs_differing": len(differ),
            "first_difference": differ[0] if differ else None,
            "selection_equal": _SELECTION.findall(a) == _SELECTION.findall(b)}


def tensor_sha256(path: str) -> list[str]:
    """``<key> <dtype> <shape> <sha256 of its bytes>`` for every tensor of
    a checkpoint file, ``<key> <value>`` for its other leaves."""
    import torch

    from .determinism_check import checkpoint_tensors
    out = []
    for k, v in sorted(checkpoint_tensors(path).items()):
        if torch.is_tensor(v):
            raw = v.detach().cpu().reshape(-1).contiguous().view(torch.uint8)
            out.append(f"{k} {str(v.dtype)[6:]} {list(v.shape)} "
                       f"{hashlib.sha256(raw.numpy().tobytes()).hexdigest()}")
        else:
            out.append(f"{k} {v!r}")
    return out


def _compare(paths: list[str]) -> int:
    """``--compare``: each pair's logs, and the ``_sha256.log`` beside
    them where both have one; prints a JSON line; 0 if every pair is
    equal."""
    if len(paths) % 2:
        raise SystemExit("--compare takes pairs of logs")
    result, same = {}, True
    for a, b in zip(paths[::2], paths[1::2]):
        texts = []
        for path in (a, b):
            with open(path) as f:
                texts.append(f.read())
        res = compare_logs(*texts)
        shas = [p[:-4] + "_sha256.log" for p in (a, b)]
        if all(os.path.isfile(p) for p in shas):
            lines = []
            for path in shas:
                with open(path) as f:
                    lines.append(f.read().splitlines())
            res["sha256_lines"] = len(lines[0])
            res["sha256_differing"] = len(set(lines[0]) ^ set(lines[1]))
        res["identical"] = (res["epochs_differing"] == 0
                            and res["selection_equal"]
                            and res.get("sha256_differing", 0) == 0)
        same &= res["identical"]
        result[f"{os.path.basename(a)} vs {os.path.basename(b)}"] = res
    print(json.dumps({"r1_compare": result}))
    return 0 if same else 1


def _key(entry: str) -> tuple[str, int]:
    prec, _, seed = entry.partition(":")
    if prec not in MODULES or not seed.isdigit():
        raise SystemExit(f"a run is <f32|tpuprec>:<seed>, not {entry!r}")
    return prec, int(seed)


def _follow_up(tool: str, run_dir: str, args, log: str, flags) -> int:
    """Run ``tools/<tool>.py`` on a finished run, its output into ``log``;
    returns its exit code."""
    with open(log, "w") as out:
        return subprocess.run(
            [sys.executable, "-m", f"pde_surrogate_torch.tools.{tool}",
             "--run-dir", run_dir, "--device", args.device, *flags],
            stdout=out, stderr=subprocess.STDOUT).returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", default=[],
                   help="<f32|tpuprec>:<seed> entries, run side by side")
    p.add_argument("--breakdown", nargs="*", default=[],
                   help="entries of --runs whose last checkpoint "
                        "tools/r2_breakdown.py splits")
    p.add_argument("--split", nargs="*", default=[],
                   help="entries of --runs whose last 20 epochs' "
                        "checkpoints tools/f3_bn_split.py splits")
    p.add_argument("--export-epoch", type=int, default=None,
                   help="also write this epoch's model and Adam state of "
                        "every --split run as .npz")
    p.add_argument("--name", default="r1_port",
                   help="prefix of the logs' names")
    p.add_argument("--out", default="logs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--sha256", nargs="*", type=int, default=[],
                   help="epochs whose checkpoints' tensors each run's "
                        "_sha256.log hashes (give the runs --ckpt-freq 1)")
    p.add_argument("--parse", nargs="*", default=[],
                   help="only parse these logs and print the JSON line")
    p.add_argument("--compare", nargs="*", default=[],
                   help="only compare these pairs of logs (and their "
                        "_sha256.log) epoch by epoch")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="further CLI flags (a shorter recipe for a try)")
    args = p.parse_args(argv)
    if args.compare:
        return _compare(args.compare)
    result = {}
    for path in args.parse:
        with open(path) as f:
            result[os.path.basename(path)] = parse_log(f.read())
    if args.parse:
        print(json.dumps({"r1_seeds": result}))
        return 0

    runs = [_key(e) for e in args.runs]
    breakdown = {_key(e) for e in args.breakdown}
    split = {_key(e) for e in args.split}
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="r1_")
    data = os.path.join(work, "data")
    from ..cli._codec_common import resolve_dataset_files
    from ..cli.train_codec_mixed_residual import Parser
    resolve_dataset_files(Parser().parse_args(
        ["--device", args.device, "--data-dir", data, *args.extra]))
    procs = {}
    for prec, seed in runs:
        name = f"{args.name}_{prec}_seed{seed}"
        log = open(os.path.join(args.out, f"{name}.log"), "w")
        cmd = [sys.executable, "-m", MODULES[prec], *PREFIX[prec],
               "--seed", str(seed), "--device", args.device, "--no-plot",
               "--data-dir", data, "--exp-dir", os.path.join(work, name),
               *args.extra]
        procs[(prec, seed)] = (name, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT), log)
    ok = True
    for (prec, seed), (name, proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        ok &= rc == 0
        with open(log.name) as f:
            result[name] = {"rc": rc, **parse_log(f.read())}
        if rc != 0 or ((prec, seed) not in breakdown | split
                       and not args.sha256):
            continue
        (run_dir,) = [r for r, _, files in os.walk(os.path.join(work, name))
                      if "args.txt" in files]
        if args.sha256:
            with open(os.path.join(args.out, f"{name}_sha256.log"),
                      "w") as f:
                for epoch in args.sha256:
                    for line in tensor_sha256(os.path.join(
                            run_dir, "checkpoints", f"model_epoch{epoch}.pt")):
                        f.write(f"epoch {epoch} {line}\n")
        if (prec, seed) in breakdown:
            rc = _follow_up("r2_breakdown", run_dir, args, os.path.join(
                args.out, f"{name}_breakdown.log"),
                ["--tpu-precision"] if prec == "tpuprec" else [])
            result[name]["breakdown_rc"] = rc
            ok &= rc == 0
        if (prec, seed) in split:
            export = ([] if args.export_epoch is None else [
                "--export", f"{args.export_epoch}:" + os.path.join(
                    args.out, f"{name}_epoch{args.export_epoch}.npz")])
            rc = _follow_up("f3_bn_split", run_dir, args, os.path.join(
                args.out, f"{name}_split.log"),
                export)
            result[name]["split_rc"] = rc
            ok &= rc == 0
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"r1_seeds": result}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

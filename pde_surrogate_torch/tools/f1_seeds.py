"""The conv solver's canonical linear recipe from several seeds, side by side.

ROADMAP F1: the canonical run (kle1024 test field 8, 5x5 Sobel, 20 000
Adam steps at lr 2e-3, 500 zoom L-BFGS epochs) missed the bar on u from
one seed.  This runs the recipe through ``solve_conv_mixed_residual`` once
per seed, all at once on one card (each in its own process and exp dir,
on one shared data dir labelled first), and prints one JSON line: per
seed the Adam warmup's final loss, the last epoch's loss, and u / σ₁ / σ₂
rel-L2 at the last test epoch.  Each run's log goes to ``--out``.
``--init-weights`` starts every run from one .npz of initial Decoder
weights and latent: ``f1_jax_init_seed1.npz`` beside this file holds the
JAX package's for seed 1 (``tools/f1_jax_init.py``).  ``--conv-operands
f32 bf16`` runs each seed twice, the second with the Decoder's convs at an
emulated TPU DEFAULT precision (``tools/f1_tpu_precision.py``), keyed
``<seed>-bf16``.  Each run also reports its loss at epochs 1, 50 and 500,
u / σ₁ / σ₂ rel-L2 at epochs 50 and 500, and how many L-BFGS epochs ended
above the epoch before (``rises``), its Adam ms per step, its median
seconds per L-BFGS epoch and the L-BFGS epochs' minutes;
``--reference-log`` adds the same numbers parsed from a JAX run's log
(a TPU run's, or ``logs/f1_jax_cpu_f32_seed1.log``: the JAX package's
recipe in float32 on a CPU from the same start as
``f1_jax_init_seed1.npz``).

Run:  python3 -m pde_surrogate_torch.tools.f1_seeds --seeds 1 2 3 \
          --out chiprun_out/f1
      python3 -m pde_surrogate_torch.tools.f1_seeds --seeds 1 \
          --init-weights pde_surrogate_torch/tools/f1_jax_init_seed1.npz \
          --conv-operands f32 bf16 \
          --reference-log logs/solve_conv_kle1024_longadam.log
      python3 -m pde_surrogate_torch.tools.f1_seeds --seeds 1 \
          --init-weights pde_surrogate_torch/tools/f1_jax_init_seed1.npz \
          --reference-log logs/f1_jax_cpu_f32_seed1.log
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

RECIPE = ["--data", "grf", "--kle", "1024", "--idx", "8", "--epochs", "500",
          "--linesearch", "zoom", "--adam-warmup", "20000", "--adam-lr",
          "2e-3", "--sobel-size", "5", "--no-plot"]


def parse_log(text: str) -> dict:
    """The warmup's loss, the last epoch's loss and the last rel-L2; the
    loss at epochs 1, 50 and 500, the rel-L2 at epochs 50 and 500, and
    the count of epochs whose loss rose over the epoch before; the Adam
    warmup's ms per step, the median seconds of an L-BFGS epoch (the
    port's log prints both) and the minutes of all L-BFGS epochs (both
    packages' logs print them)."""
    warm = re.findall(r"Adam warmup \(\d+ steps\): loss ([\d.eE+-]+)", text)
    losses = {int(e): float(v) for e, v in
              re.findall(r"epoch (\d+): loss ([\d.eE+-]+)", text)}
    rel = {int(e): [float(v) for v in r.split()] for e, r in
           re.findall(r"epoch (\d+): relative l2 \[([^\]]+)\]", text)}
    seq = [losses[e] for e in sorted(losses)]
    adam_ms = re.findall(r"Adam warmup .*, ([\d.]+) ms/step", text)
    epoch_s = sorted(float(v) for v in
                     re.findall(r"loss evaluations, ([\d.]+) s", text))
    minutes = re.findall(r"Finished optimization for \d+ epochs using "
                         r"([\d.]+) minutes", text)
    return {"adam_loss": float(warm[-1]) if warm else None,
            "final_loss": seq[-1] if seq else None,
            "rel_l2": rel[max(rel)] if rel else None,
            "loss_at": {e: losses.get(e) for e in (1, 50, 500)},
            "rel_l2_at": {e: rel.get(e) for e in (50, 500)},
            "rises": sum(b > a for a, b in zip(seq, seq[1:])),
            "adam_ms_per_step": float(adam_ms[-1]) if adam_ms else None,
            "lbfgs_s_per_epoch": (epoch_s[len(epoch_s) // 2] if epoch_s
                                  else None),
            "lbfgs_minutes": float(minutes[-1]) if minutes else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--out", default="chiprun_out/f1")
    p.add_argument("--device", default="cuda")
    p.add_argument("--init-weights", default=None,
                   help="a .npz of initial Decoder weights and latent")
    p.add_argument("--conv-operands", nargs="+", default=["f32"],
                   choices=["f32", "bf16"],
                   help="the Decoder convs' operands: f32, and/or bf16 "
                        "(emulated TPU DEFAULT precision)")
    p.add_argument("--reference-log", default=None,
                   help="a JAX run's log, parsed alike")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="further solver flags (a shorter recipe for a try)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="f1_")
    data = os.path.join(work, "data")
    from ..cli.solve_conv_mixed_residual import Parser, ensure_test_dataset
    ensure_test_dataset(Parser().parse_args(
        RECIPE + ["--device", args.device, "--data-dir", data, *args.extra]))
    procs = {}
    for s in args.seeds:
        for ops in args.conv_operands:
            key = str(s) if ops == "f32" else f"{s}-{ops}"
            module = ("pde_surrogate_torch.cli.solve_conv_mixed_residual"
                      if ops == "f32"
                      else "pde_surrogate_torch.tools.f1_tpu_precision")
            log = open(os.path.join(args.out, f"seed{key}.log"), "w")
            cmd = [sys.executable, "-m", module,
                   *RECIPE, "--seed", str(s), "--device", args.device,
                   "--data-dir", data,
                   "--exp-dir", os.path.join(work, f"s{key}"),
                   *(["--init-weights", os.path.abspath(args.init_weights)]
                     if args.init_weights else []), *args.extra]
            procs[key] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT), log)
    result = {}
    if args.reference_log:
        with open(args.reference_log) as f:
            result["reference"] = {"rc": 0, **parse_log(f.read())}
    for s, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        with open(log.name) as f:
            result[s] = {"rc": rc, **parse_log(f.read())}
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"f1_seeds": result}))
    return 0 if all(r["rc"] == 0 for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

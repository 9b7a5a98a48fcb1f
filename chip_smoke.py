#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pde_surrogate_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: torch/CUDA versions, the card's name and power limit, nvcc,
   the TF32 flags (off).
2. Build every CUDA kernel from ``pde_surrogate_torch/csrc`` (one nvcc per
   source, started together) and print the build time and ptxas report.
3. Hold each kernel against its plain PyTorch version at the main path's
   shapes (and 128^2), plus float64 and closed-form oracles.
4. Time each kernel, its plain version and a library yardstick with CUDA
   events; compute its bound from this run's shapes.
5. The main path at full width: make_dataset (labels by the kernel), then
   label-free training of DenseED [6,8,6]/16/48 at 64^2 for 2 epochs in an
   empty data dir (its val labels solved by the kernel), then predict_codec
   on the checkpoint.  Kernel launch counts are zeroed just before and read
   just after.
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that line; so does a machine without
CUDA or a directory without the package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM, float32 outside the tensor cores
CG_FLOP_PER_CELL_ITER = 23      # stencil 12, two dots 4, three axpys 6, z 1


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def dense_darcy_system(K: torch.Tensor):
    """The eliminated-Dirichlet 5-point operator as dense (B, m, m) matrices
    over the interior columns, and its right-hand side (B, m)."""
    from pde_surrogate_torch.solvers.fd_darcy import _harm
    bsz, n, _ = K.shape
    w = n - 2
    m = n * w
    kx = _harm(K[:, :, :-1], K[:, :, 1:])          # (B, n, n-1) x-faces
    ky = _harm(K[:, :-1, :], K[:, 1:, :])          # (B, n-1, n) y-faces
    A = torch.zeros(bsz, m, m, device=K.device, dtype=K.dtype)
    idx = torch.arange(m, device=K.device).view(n, w)
    rows, cols = torch.meshgrid(torch.arange(n, device=K.device),
                                torch.arange(1, n - 1, device=K.device),
                                indexing="ij")
    kE = kx[:, rows, cols]
    kW = kx[:, rows, cols - 1]
    kN = torch.where(rows > 0, ky[:, (rows - 1).clamp(min=0), cols], 0.0)
    kS = torch.where(rows < n - 1, ky[:, rows.clamp(max=n - 2), cols], 0.0)
    diag = (kE + kW + kN + kS).reshape(bsz, m)
    A[:, idx.flatten(), idx.flatten()] = diag
    A[:, idx[:, :-1].flatten(), idx[:, 1:].flatten()] = -kE[:, :, :-1].reshape(bsz, -1)
    A[:, idx[:, 1:].flatten(), idx[:, :-1].flatten()] = -kW[:, :, 1:].reshape(bsz, -1)
    A[:, idx[1:].flatten(), idx[:-1].flatten()] = -kN[:, 1:].reshape(bsz, -1)
    A[:, idx[:-1].flatten(), idx[1:].flatten()] = -kS[:, :-1].reshape(bsz, -1)
    b = torch.zeros(bsz, n, w, device=K.device, dtype=K.dtype)
    b[:, :, 0] = kW[:, :, 0]                       # u = 1 on column 0
    return A, b.reshape(bsz, m)


def phase_environment():
    from pde_surrogate_torch.utils.config import select_device
    select_device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {gpu_name_power()}")
    log(f"nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}")
    log(f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")


def phase_build():
    from pde_surrogate_torch.ops.kernels.build import SRC_DIR, build
    names = sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))
    tic = time.perf_counter()
    built = build(names)
    log(f"[build] {len(names)} kernel source(s) in "
        f"{time.perf_counter() - tic:.2f} s wall")
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.2f} s; ptxas:")
        for line in info["log"].splitlines():
            if any(k in line for k in ("Compiling entry", "spill", "Used")):
                log("    " + line.strip())


def phase_cg_parity() -> float:
    """K1 against its f32 twin, the f64 twin and the closed form; returns
    the largest |kernel - twin| at the main path's shape (64^2, B=64)."""
    from pde_surrogate_torch.data.grf import sample_channelized, sample_kle
    from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                          solve_darcy_cg_plain)
    main_err = 0.0
    for n in (64, 128):
        n_iter = 24 * n
        for fam, K in (("kle512", sample_kle(64, n, 512, rng=n)),
                       ("channelized", sample_channelized(64, n, rng=n))):
            K = torch.from_numpy(K).cuda()
            u = solve_darcy_cg(K, n_iter)
            torch.cuda.synchronize()
            u_plain = solve_darcy_cg_plain(K, n_iter)
            u64 = solve_darcy_cg_plain(K.double(), n_iter)
            err = (u - u_plain).abs().max().item()

            def rel(a):
                d = (a.double() - u64).flatten(1).norm(dim=1)
                return (d / u64.flatten(1).norm(dim=1)).max().item()
            log(f"[K1] n={n} {fam} B=64 n_iter={n_iter}: "
                f"max|kernel-twin|={err:.3e} (atol 5e-5), "
                f"relL2(kernel,f64)={rel(u):.3e} "
                f"relL2(twin,f64)={rel(u_plain):.3e} (< 1e-4)")
            check(bool(torch.isfinite(u).all()), "kernel output not finite")
            check(err <= 5e-5, f"kernel vs twin {err} > 5e-5")
            check(rel(u) < 1e-4 and rel(u_plain) < 1e-4,
                  "kernel or twin off the f64 oracle")
            if n == 64:
                main_err = max(main_err, err)
        ones = torch.ones(8, n, n, device="cuda")
        u = solve_darcy_cg(ones, n_iter)
        x = torch.linspace(0, 1, n, device="cuda")
        cerr = (u - (1 - x).expand(8, n, n)).abs().max().item()
        log(f"[K1] n={n} constant K: max|u-(1-x)|={cerr:.3e} (1e-5)")
        check(cerr <= 1e-5, "constant K must give 1 - x")
    return main_err


def phase_bn_parity():
    """The port's BatchNorm2d on the card folds the biased batch variance
    into running_var (cuDNN's fused op folds the unbiased one)."""
    from pde_surrogate_torch.models.codec import BatchNorm2d
    bn = BatchNorm2d(16).cuda().train()
    x = torch.randn(2, 16, 4, 4, device="cuda") * 3 + 1
    bn(x)
    want = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    err = (bn.running_var - want).abs().max().item()
    log(f"[bn] running_var vs biased update: max err {err:.3e} (1e-5)")
    check(err <= 1e-5, "BatchNorm2d running_var must use the biased variance")


def phase_cg_times() -> dict:
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                          solve_darcy_cg_plain)
    n, n_iter = 64, 24 * 64
    K = torch.from_numpy(sample_kle(264, n, 512, rng=7)).cuda()
    out = {}
    for bsz in (264, 132, 64):
        ms = cuda_ms(lambda: solve_darcy_cg(K[:bsz], n_iter), reps=5)
        out["ms"] = ms                     # the main path's batch is the last
        log(f"[K1 time] n=64 B={bsz}: {ms:.3f} ms/batch, "
            f"{bsz / ms * 1e3:.1f} fields/s")
    K128 = torch.from_numpy(sample_kle(64, 128, 512, rng=8)).cuda()
    ms = cuda_ms(lambda: solve_darcy_cg(K128, 24 * 128), reps=3)
    log(f"[K1 time] n=128 B=64 n_iter=3072: {ms:.3f} ms/batch, "
        f"{64 / ms * 1e3:.1f} fields/s")
    K64 = K[:64].contiguous()
    out["plain_ms"] = cuda_ms(lambda: solve_darcy_cg_plain(K64, n_iter),
                              reps=2)
    A, b = dense_darcy_system(K64)
    out["library_ms"] = cuda_ms(lambda: torch.linalg.solve(A, b), reps=2)
    sol = torch.linalg.solve(A, b).view(64, n, n - 2)
    u = solve_darcy_cg(K64, n_iter)
    lerr = (sol - u[:, :, 1:-1]).abs().max().item()
    log(f"[K1 time] n=64 B=64: plain twin {out['plain_ms']:.3f} ms, "
        f"torch.linalg.solve on the dense operator {out['library_ms']:.3f} ms "
        f"(max|solve-kernel|={lerr:.2e})")
    check(lerr < 1e-3, "dense solve disagrees with the kernel")
    flops = CG_FLOP_PER_CELL_ITER * 64 * n * n * n_iter
    nbytes = 2 * 64 * n * n * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    out["bound_ms"] = max(t_ops, t_bytes) * 1e3
    out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"[K1 bound] {flops / 1e9:.2f} GFLOP f32 and {nbytes / 1e6:.2f} MB "
        f"per batch of 64: {out['bound_ms']:.4f} ms ({out['bound_by']})")
    return out


def phase_main_path(tmp: str) -> int:
    """Returns the K1 launches of the main path's run."""
    import numpy as np
    from pde_surrogate_torch.cli import make_dataset, predict_codec
    from pde_surrogate_torch.cli import train_codec_mixed_residual as train
    from pde_surrogate_torch.data.hdf5 import dataset_shapes
    from pde_surrogate_torch.ops.kernels.cg_darcy import solve_darcy_cg

    solve_darcy_cg.launches = 0
    data1, data2 = os.path.join(tmp, "data1"), os.path.join(tmp, "data2")
    exp = os.path.join(tmp, "exp")
    tic = time.perf_counter()
    make_dataset.main(["--device", "cuda", "--data-dir", data1, "--imsize",
                       "64", "--kle", "512", "--ntrain", "64", "--nval",
                       "128", "--ntest", "64", "--n-monte-carlo", "64"])
    after_dataset = solve_darcy_cg.launches
    log(f"[main] make_dataset: {time.perf_counter() - tic:.2f} s, "
        f"K1 launches {after_dataset}")
    check(after_dataset > 0, "make_dataset did not launch K1")

    tic = time.perf_counter()
    state, logger = train.main([
        "--device", "cuda", "--data-dir", data2, "--exp-dir", exp,
        "--data", "grf_kle512", "--imsize", "64", "--blocks", "6,8,6",
        "--growth-rate", "16", "--init-features", "48", "--ntrain", "512",
        "--ntest", "128", "--batch-size", "32", "--test-batch-size", "64",
        "--epochs", "2", "--ckpt-freq", "1", "--no-plot"])
    train_launches = solve_darcy_cg.launches - after_dataset
    log(f"[main] train_codec_mixed_residual: "
        f"{time.perf_counter() - tic:.2f} s, K1 launches {train_launches}")
    check(train_launches > 0, "training's ensure_dataset did not launch K1")
    runs = os.path.join(exp, "codec", "mixed_residual")
    run_dir = os.path.join(runs, os.listdir(runs)[0])
    with open(os.path.join(run_dir, "training", "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    first, last = epochs[0]["loss_first_step"], logger["loss_train"][-1]
    log(f"[main] first step loss {first:.4f}, last epoch mean {last:.4f}; "
        f"epoch seconds {[round(e['epoch_seconds'], 3) for e in epochs]}")
    check(all(np.isfinite(logger["loss_train"])) and np.isfinite(first),
          "training losses not finite")
    check(last < first, "last epoch's mean loss is not below the first step's")
    check(np.isfinite(np.asarray(logger["r2_test"])).all()
          and np.isfinite(np.asarray(logger["nrmse_test"])).all(),
          "eval metrics not finite")
    check(os.path.isfile(os.path.join(run_dir, "checkpoints",
                                      "model_epoch2.pt")),
          "checkpoint missing")

    val = os.path.join(data2, "64x64", "kle512_lhs1000_val.hdf5")
    pred_path = os.path.join(tmp, "pred.hdf5")
    tic = time.perf_counter()
    pred, rel_l2, r2 = predict_codec.main([
        "--device", "cuda", "--run-dir", run_dir, "--input", val,
        "--output", pred_path])
    log(f"[main] predict_codec: {time.perf_counter() - tic:.2f} s, "
        f"rel-L2 {rel_l2}, R2 {r2}")
    check(pred.shape == (128, 3, 64, 64), f"prediction shape {pred.shape}")
    check(np.isfinite(pred).all() and np.isfinite(rel_l2).all()
          and np.isfinite(r2).all(), "predictions or metrics not finite")
    check(dataset_shapes(pred_path) == {"input": (128, 1, 64, 64),
                                        "output": (128, 3, 64, 64)},
          "prediction file shapes")
    return solve_darcy_cg.launches


def phase_step_time() -> float:
    """ms per mixed-residual training step, DenseED [6,8,6]/16/48, 64^2,
    batch 32, f32 with TF32 off."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.codec import DenseED
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.codec_trainer import (
        create_state, make_mixed_residual_step)
    torch.manual_seed(0)
    model = DenseED(1, 3, 64, [6, 8, 6], growth_rate=16,
                    init_features=48).cuda()
    state = create_state(model, lr_max=1e-3, total_steps=1000)
    step = make_mixed_residual_step(state, SobelFilter(64), 10.0)
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None].cuda()
    ms = cuda_ms(lambda: step(x), reps=20, warmup=5)
    log(f"[step] DenseED [6,8,6]/16/48 64^2 batch 32 f32: {ms:.3f} ms/step "
        f"({32 / ms * 1e3:.1f} samples/s)")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import pde_surrogate_torch  # noqa: F401  (fails outside the repo)

    phase_environment()
    phase_build()
    max_err = phase_cg_parity()
    phase_bn_parity()
    times = phase_cg_times()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_step_time()

    kernels = [{
        "name": "cg_darcy", "route": "cuda",
        "source": "pde_surrogate_torch/csrc/cg_darcy.cu",
        "replaces": "pde_surrogate_tpu/ops/kernels/cg_darcy.py:137",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

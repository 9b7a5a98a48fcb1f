#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pde_surrogate_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Environment: torch/CUDA versions, the card's name and power limit, nvcc,
   the TF32 flags (off).
2. Build every CUDA kernel from ``pde_surrogate_torch/csrc`` (one nvcc per
   source, started together) and print the build time and ptxas report.
3. Hold each kernel against its plain PyTorch version at the main path's
   shapes (and 128^2, 256^2), plus float64 and closed-form oracles.
4. Time each kernel, its plain version and a library yardstick with CUDA
   events, K1 also by batch size at 64^2 and at 128^2 and 256^2; compute
   its bound from this run's shapes.
5. The finite-volume objectives and their in-loss PCG on the card against
   the CPU at 64^2, B=32, 64 CG iterations (``[fvcg]``); the FC solver's
   loss and parameter gradient at full width (``[fc]``); the FV-Newton
   oracle of the nonlinear law at 64^2 with its wall time (``[nonlinear]``);
   the conditional Glow at its reference width (enc [3,4,4], flow [6,6,6])
   at 64^2, B=8: density, generate and the reverse-KL loss and gradient
   under sobel and fvcg, with its heads at 1e-3 against the CPU and at
   1e-2 against float64 (``[glow]``); the DenseED's options at full width
   ([6,8,6]/16/48, 64^2, B=8): concat-free and remat against the plain
   model, bf16 against f32 and against the CPU's bf16, the peak memory of
   remat (``[codec variants]``, rules in ``tools/codec_check``).
6. Every path at full width, each driven through its CLI with the kernel
   launch counts zeroed just before and read just after: make_dataset
   (labels by the kernel); DenseED [6,8,6]/16/48 at 64^2: label-free
   training (Sobel, 2 epochs) in an empty data dir, whose val labels the
   kernel solves; predict_codec; fvcg and sobel_fvcg training (2 epochs
   each) on that data; supervised (MLE) training, whose train labels
   the kernel attaches in place; predict_codec on it; a warm start from
   the fvcg run (--init-from, 2 epochs at lr 3e-4; the CLI's warm start
   loads the source checkpoint into a fresh model exactly); the LR-range
   test (--find-lr); then the single-instance solvers at their default
   widths on kle512 test field 8 (the kernel labels the 1000-field test
   set): the FC solver (CPPN 512x8), the conv-decoder solver and the
   conv-decoder solver with the nonlinear law (its FV-Newton oracle), each
   with a 300-step Adam warmup and 3 zoom L-BFGS epochs; the cGlow at its
   reference width on kle512 at 64^2 in a fresh data dir: 2 epochs of
   reverse-KL training with --data-init (the kernel labels the val and
   the train split), predict_cglow, and post_cglow's five UQ tasks on a
   512-field Monte-Carlo set that the kernel labels; then the DenseED's
   options through the CLIs: a --dtype bf16 Sobel run in a fresh data dir
   (the kernel labels its val split) and predict_codec on it, a
   --concat-free run on 128 fields whose first epoch is profiled
   (--profile-epoch 1; the trace's CUDA kernels counted), the supervised
   driver with all three;
   import_torch_ckpt of a .pth made from the f32 Sobel run, served by
   predict_codec with the source's metrics; and the figures' note where
   matplotlib is missing, with the .txt stats written.
   ``[tpu precision]``: one Sobel step of the DenseED at 64^2, batch 32,
   with its convs at the emulated TPU DEFAULT precision
   (``tools/f1_tpu_precision``) beside the f32 step from the same weights
   and batch, both timed; ``tools/r2_breakdown`` on the Sobel run's last
   checkpoint, its R^2 held to the CLI's within 1e-6 relative.
7. ms per training step by CUDA events and peak memory for each objective,
   with and without the in-loss CG, the 128^2 fvcg recipe, the Sobel step
   under bf16, concat-free (f32, bf16) and remat, and the cGlow's
   reverse-KL step (sobel, fvcg) and the canonical cGlow's (enc
   [3,3,3,3], flow [4,4,4,4], sobel; ``[step] cglow canonical``); kernel
   launches and device busy time of one step from torch.profiler, and its
   conv and matmul FLOPs.
8. ``[dist]``, in a one-rank NCCL group: the DenseED and cGlow training
   steps at full width under the data mesh (BatchNorm moments reduced over
   it, gradients all-reduced) against the plain steps, 3 steps in float64
   and the first loss in float32, timed against them; the row-sharded
   Darcy solve against K1 on 64 fields of 64^2, timed against it; then
   the codec CLI with --n-devices 1 in a fresh data dir (K1 labels its val
   split on the rank) against the run without the flag (with two cards,
   --n-devices 2 too).
9. ``[dpsp]``, the data x space training step at DenseED [6,8,6]/16/48's
   widths, 64^2, batch 32, TF32 off: (a) the row-block arithmetic of
   every conv kind, the upsampling before a conv and the Sobel stencils,
   at 2 and 4 blocks in one process, forward and backward, against the
   whole field's cuDNN / matmul result (1e-5 of its largest value); (b) a
   1x1 mesh in a one-rank NCCL group (every conv on its row block, the
   halos at both walls, the partial loss) against the plain step, three
   steps in float64 and the first float32 loss; (c) the f32 step, plain
   and mesh, timed in turns by CUDA events, with the peak memory of each;
   (d) the same for fv, fvcg and sobel_fvcg (64 CG iterations) and the
   supervised step (K1's labels); (e) the eval step (sobel_fvcg) against
   the plain one in float32, its per-sample rel-L2 and SSE, consistency
   and loss within 1e-5; (f) dropout 0.1, three float64 steps, both
   drawing from the step's generator; (g) the cGlow (enc [3,4,4], flow
   [6,6,6], 64^2, batch 32) with ActNorm data-init over the mesh and
   three float64 reverse-KL losses within 2e-5, the f32 step timed with
   its peak.
10. ``[determinism]``, under the numerics every entry point's
   ``select_device`` sets (deterministic algorithms, a fixed cuBLAS
   workspace) with fresh memory filled with NaN: (a) each training step
   kind at full width (DenseED sobel, fvcg n_cg 64, MLE; the canonical
   cGlow's reverse-KL; both solvers' Adam steps and a zoom L-BFGS epoch)
   twice from the same seeds, every loss, parameter, buffer and optimizer
   moment bitwise equal; (b) the codec CLI 3 epochs twice and stopped
   after 1 and resumed, the cGlow CLI 2 epochs likewise, every tensor of
   the last checkpoint and the logged metrics equal; (c) K1 twice at 64^2
   and 128^2, bitwise equal; (d) each step kind with deterministic
   algorithms on and off in turns (CUDA-event ms, device busy time, peak
   memory, the kernels that grew) and the Sobel step with the NaN fill
   on and off, beside the card's name and power limit.
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that line; so does a machine without
CUDA or a directory without the package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
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
    """K1 against its f32 twin, the f64 twin and the closed form at 64^2,
    128^2 (B=64) and 256^2 (B=8); returns the largest |kernel - twin| at
    the main path's shape (64^2, B=64)."""
    from pde_surrogate_torch.data.grf import sample_channelized, sample_kle
    from pde_surrogate_torch.ops.kernels.cg_darcy import (launch_geometry,
                                                          solve_darcy_cg,
                                                          solve_darcy_cg_plain)
    main_err = 0.0
    for n, bsz in ((64, 64), (128, 64), (256, 8)):
        n_iter = 24 * n
        log(f"[K1] n={n} B={bsz}: {launch_geometry(n)}")
        for fam, K in (("kle512", sample_kle(bsz, n, 512, rng=n)),
                       ("channelized", sample_channelized(bsz, n, rng=n))):
            K = torch.from_numpy(K).cuda()
            u = solve_darcy_cg(K, n_iter)
            torch.cuda.synchronize()
            u_plain = solve_darcy_cg_plain(K, n_iter)
            u64 = solve_darcy_cg_plain(K.double(), n_iter)
            err = (u - u_plain).abs().max().item()

            def rel(a):
                d = (a.double() - u64).flatten(1).norm(dim=1)
                return (d / u64.flatten(1).norm(dim=1)).max().item()
            log(f"[K1] n={n} {fam} B={bsz} n_iter={n_iter}: "
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
    """K1's times: fields/s by batch at 64^2, B=64 at 128^2 and 256^2; the
    plain twin, the library yardstick and the bound at the main path's
    shape (64^2, B=64)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                          solve_darcy_cg_plain)
    n, n_iter = 64, 24 * 64
    K = torch.from_numpy(sample_kle(264, n, 512, rng=7)).cuda()
    out = {}
    for vn, bsz in ((64, 264), (64, 132), (64, 64), (128, 64), (256, 64)):
        Kb = (K[:bsz].contiguous() if vn == 64 else
              torch.from_numpy(sample_kle(bsz, vn, 512, rng=vn)).cuda())
        v_iter = 24 * vn
        ms = cuda_ms(lambda: solve_darcy_cg(Kb, v_iter),
                     reps=5 if vn == 64 else 2)
        if (vn, bsz) == (64, 64):          # the main path's shape
            out["ms"] = ms
        log(f"[K1 time] n={vn} B={bsz}: {ms:.3f} ms/batch, "
            f"{ms * 1e3 / v_iter:.3f} us/iteration, "
            f"{bsz / ms * 1e3:.1f} fields/s")
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
        f"per batch of 64: {out['bound_ms']:.4f} ms ({out['bound_by']}); "
        f"the kernel at {out['ms'] / out['bound_ms']:.1f}x")
    return out


def phase_fvcg_parity():
    """The FV objectives and the in-loss PCG on the card against the same
    functions on the CPU: 64^2, B=32, 64 CG iterations, kle512 K, random
    outputs.  Loss within 1e-5 relative; the gradient with respect to the
    output within 1e-5 * max|g| of the CPU's, or three times the CPU f32
    gradient's own distance from float64 where that is larger (the CG's
    reverse mode amplifies f32 rounding)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.codec_trainer import _physics_loss
    n, bsz, n_cg = 64, 32, 64
    K = torch.from_numpy(sample_kle(bsz, n, 512, rng=11))[:, None]
    out = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (bsz, 3, n, n)).astype(np.float32))
    sobel = SobelFilter(n)
    fns = {
        "fv_mixed_residual_loss":
            lambda k, o: td.fv_mixed_residual_loss(k, o, 10.0)[0],
        "fv_cg_error_loss":
            lambda k, o: td.fv_cg_error_loss(k, o, 10.0, n_cg)[0],
        "_physics_loss(sobel_fvcg, flux weight 1)":
            lambda k, o: _physics_loss("sobel_fvcg", k, o, sobel, 10.0, None,
                                       100.0, 1.0, n_cg)[0]}
    for name, fn in fns.items():
        def run(device, dtype=torch.float32):
            o = out.to(device, dtype).detach().requires_grad_(True)
            loss = fn(K.to(device, dtype), o)
            loss.backward()
            return float(loss), o.grad.double().cpu()
        l_gpu, g_gpu = run("cuda")
        l_cpu, g_cpu = run("cpu")
        _, g64 = run("cpu", torch.float64)
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        gmax = float(g_cpu.abs().max())
        gerr = float((g_gpu - g_cpu).abs().max()) / gmax
        cpu_err = float((g_cpu - g64).abs().max()) / gmax
        bound = max(1e-5, 3 * cpu_err)
        log(f"[fvcg] {name} 64^2 B={bsz} n_cg={n_cg}: loss {l_gpu:.6e}, "
            f"rel to CPU {rel:.2e} (1e-5); grad max|card-CPU| {gerr:.2e} "
            f"of max|g| ({bound:.2e}; CPU f32 vs f64 {cpu_err:.2e})")
        check(np.isfinite(l_gpu) and bool(torch.isfinite(g_gpu).all()),
              f"{name}: not finite on the card")
        check(rel <= 1e-5, f"{name}: card loss off the CPU's by {rel}")
        check(gerr <= bound, f"{name}: card gradient off the CPU's by {gerr}")


def fc_loss_fn(device, dtype, n: int = 64, width: int = 512,
               depth: int = 8):
    """The FC solver's objective at its default width: a CPPN width x depth
    (seeded weights) on the n^2 on-grid collocation points of a kle512
    field, 512 Dirichlet and 2n Neumann points.  Returns (loss of the flat
    parameter vector, that vector, the model)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.cppn import CPPN
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.ops.sampling import SampleSpatial2d
    from pde_surrogate_torch.train.lbfgs import FlatParams
    torch.manual_seed(1)
    model = CPPN(2, 3, width, depth).to(device, dtype)
    flat = FlatParams(model)
    s = SampleSpatial2d(n, n, rng=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    x = t(s.colloc(True))
    dirichlet = t(np.concatenate([s.left(False, 256), s.right(False, 256)]))
    y_d = torch.cat([torch.ones(256, 1), torch.zeros(256, 1)]).to(device,
                                                                 dtype)
    neumann = t(np.concatenate([s.top(True), s.bottom(True)]))
    K = t(sample_kle(1, n, 512, rng=8)[0].reshape(-1, 1))

    def loss(v):
        p = flat.unflatten(v)
        net = (model, p)
        diri = torch.mean((torch.func.functional_call(
            model, p, (dirichlet,))[:, 0:1] - y_d) ** 2)
        return (td.mixed_residual_fc(net, x, K)
                + 10.0 * (diri + td.neumann_boundary_mixed(net, neumann)))
    return loss, flat.vector(), model


def phase_fc_parity():
    """The FC solver's loss and its parameter gradient (through the
    per-point Jacobians) at full width on the card against the CPU: loss
    within 1e-5 relative; gradient within 1e-5 * max|g| of the CPU's, or
    three times the CPU f32 gradient's own distance from float64."""
    from pde_surrogate_torch.train.lbfgs import value_and_grad

    def run(device, dtype=torch.float32):
        loss, v, _ = fc_loss_fn(device, dtype)
        value, grad = value_and_grad(loss, v)
        return float(value), grad.double().cpu()
    l_gpu, g_gpu = run("cuda")
    l_cpu, g_cpu = run("cpu")
    _, g64 = run("cpu", torch.float64)
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    gmax = float(g_cpu.abs().max())
    gerr = float((g_gpu - g_cpu).abs().max()) / gmax
    cpu_err = float((g_cpu - g64).abs().max()) / gmax
    bound = max(1e-5, 3 * cpu_err)
    log(f"[fc] CPPN 512x8 ({g_gpu.numel()} params), 4096 + 512 + 128 points: "
        f"loss {l_gpu:.6e}, rel to CPU {rel:.2e} (1e-5); grad max|card-CPU| "
        f"{gerr:.2e} of max|g| ({bound:.2e}; CPU f32 vs f64 {cpu_err:.2e})")
    check(np.isfinite(l_gpu) and bool(torch.isfinite(g_gpu).all()),
          "FC loss or gradient not finite on the card")
    check(rel <= 1e-5, f"FC loss: card off the CPU's by {rel}")
    check(gerr <= bound, f"FC gradient: card off the CPU's by {gerr}")


def phase_nonlinear(n: int = 64):
    """The FV-Newton oracle (alpha1 = alpha2 = 1, 12 Newton steps) on one
    kle512 field at n^2: card against CPU within 1e-5 of max|x| or three
    times the CPU f32 result's distance from float64; the boundary
    conditions; the wall time on the card and the CPU."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.solvers.fd_darcy import solve_nonlinear_darcy
    K = torch.from_numpy(sample_kle(1, n, 512, rng=8)[0])

    def timed(k):
        if k.is_cuda:
            torch.cuda.synchronize()
        tic = time.perf_counter()
        out = solve_nonlinear_darcy(k).cpu().double()
        return out, time.perf_counter() - tic
    solve_nonlinear_darcy(K[:8, :8].cuda())            # first-use set-up
    on_gpu, s_gpu = timed(K.cuda())
    on_cpu, s_cpu = timed(K)
    f64, _ = timed(K.double())
    scale = float(f64.abs().max())
    err = float((on_gpu - on_cpu).abs().max()) / scale
    own = float((on_cpu - f64).abs().max()) / scale
    bound = max(1e-5, 3 * own)
    bc = max(float((on_gpu[0, :, 0] - 1).abs().max()),
             float(on_gpu[0, :, -1].abs().max()),
             float(on_gpu[2, [0, -1]].abs().max()))
    log(f"[nonlinear] {n}^2: card {s_gpu:.3f} s, CPU {s_cpu:.3f} s; "
        f"max|card-CPU| {err:.2e} of max|x| ({bound:.2e}; CPU f32 vs f64 "
        f"{own:.2e}); boundary conditions max error {bc:.1e} (1e-6)")
    check(bool(torch.isfinite(on_gpu).all()), "nonlinear solve not finite")
    check(err <= bound, f"nonlinear solve: card off the CPU's by {err}")
    check(bc <= 1e-6, "nonlinear solve violates its boundary conditions")


def phase_glow_parity():
    """The cGlow at full width (enc [3,4,4], flow [6,6,6]), 64^2, B=8
    (``tools/glow_check``).  Heads at 1e-3: on the card against the CPU
    (log p and the losses within 1e-5 relative; generate's output and the
    parameter gradients within 1e-5 of their largest magnitude, or three
    times the CPU f32 result's own distance from float64).  Heads at 1e-2
    (fields of ~5e10; trained heads leave zero): on the card against the
    CPU's float64 within 2e-4 of the largest magnitude, printed beside the
    same outputs with TF32 convolutions."""
    from pde_surrogate_torch.tools.glow_check import (card_vs_cpu,
                                                      card_vs_float64,
                                                      glow_outputs)

    def outputs(device, head_scale, dtype=torch.float32):
        return glow_outputs(device, dtype, imsize=64, enc_blocks=[3, 4, 4],
                            flow_blocks=[6, 6, 6], head_scale=head_scale)
    tic = time.perf_counter()
    on_gpu = outputs("cuda", 1e-3)
    gpu_s = time.perf_counter() - tic
    on_cpu, f64 = outputs("cpu", 1e-3), outputs("cpu", 1e-3, torch.float64)
    log(f"[glow] enc [3,4,4] flow [6,6,6] 64^2 B=8: card {gpu_s:.2f} s, "
        f"CPU f32 and f64 {time.perf_counter() - tic - gpu_s:.2f} s")
    for name, err, bound, own in card_vs_cpu(on_gpu, on_cpu, f64):
        log(f"[glow] {name} ({on_cpu[name].numel()} values): card vs CPU "
            f"{err:.2e} ({bound:.2e}; CPU f32 vs f64 {own:.2e})")
        check(bool(torch.isfinite(on_gpu[name]).all()) and err <= bound,
              f"[glow] {name}: card off the CPU by {err}")

    on_gpu, f64 = outputs("cuda", 1e-2), outputs("cpu", 1e-2, torch.float64)
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for f in flags:
        f.allow_tf32 = True
    try:
        with_tf32 = dict((name, err) for name, err, _ in card_vs_float64(
            outputs("cuda", 1e-2), f64))
    finally:
        for f in flags:
            f.allow_tf32 = False
    for name, err, bound in card_vs_float64(on_gpu, f64):
        log(f"[glow] heads 1e-2, {name} (max "
            f"{float(f64[name].abs().max()):.3e}): card vs float64 "
            f"{err:.2e} of the max ({bound:.0e}; with TF32 "
            f"{with_tf32[name]:.2e})")
        check(bool(torch.isfinite(on_gpu[name]).all()) and err <= bound,
              f"[glow] heads 1e-2, {name}: card off float64 by {err}")


def phase_codec_variants():
    """DenseED [6,8,6]/16/48 at 64^2, B=8, one set of weights: concat-free
    and remat against the plain model, bf16 against f32 on the card (rules
    in ``tools/codec_check``); the card's bf16 against the CPU's (printed);
    the dtype of a conv's output under bf16; the peak memory of plain and
    remat steps."""
    from pde_surrogate_torch.tools.codec_check import (bf16_errors,
                                                       codec_step, rel_l2,
                                                       run_variant_checks)
    shape = dict(imsize=64, blocks=[6, 8, 6], growth=16, init=48, batch=8)
    tic = time.perf_counter()
    rows, steps = run_variant_checks("cuda", **shape)
    log(f"[codec variants] DenseED [6,8,6]/16/48 64^2 B=8: "
        f"{time.perf_counter() - tic:.2f} s (card and CPU)")
    for name, err, bound, ref in rows:
        log(f"[codec variants] {name}: {err:.3e} (bound {bound:.3e}; the "
            f"reference's own error {ref:.3e})")
        check(np.isfinite(err) and err <= bound,
              f"[codec variants] {name}: {err} > {bound}")
    torch.backends.cudnn.enabled = False
    try:
        native = codec_step("cuda", **shape)
    finally:
        torch.backends.cudnn.enabled = True
    log(f"[codec variants] gradient rel-L2 to float64: plain f32 "
        f"{rel_l2(steps['f32']['grads'], steps['f64']['grads']):.3e}, "
        f"concat-free "
        f"{rel_l2(steps['concat_free']['grads'], steps['f64']['grads']):.3e}"
        f", plain f32 without cuDNN "
        f"{rel_l2(native['grads'], steps['f64']['grads']):.3e}; the CPU's "
        f"f32 {rel_l2(steps['cpu f32']['grads'], steps['f64']['grads']):.3e}")
    out, grad = bf16_errors(steps["bf16"], steps["cpu bf16"])
    log(f"[codec variants] bf16 card vs bf16 CPU: output {out:.3e} of its "
        f"max, gradient rel-L2 {grad:.3e}")
    dtype = steps["bf16"]["conv_dtype"]
    log(f"[codec variants] bf16: In_conv output dtype {dtype}; parameters "
        f"and BN statistics f32")
    check(dtype == torch.bfloat16, "bf16 run did not compute in bf16")
    log(f"[codec variants] peak memory of one step: f32 "
        f"{steps['f32']['peak_mib']:.1f} MiB, remat "
        f"{steps['remat']['peak_mib']:.1f} MiB, concat-free "
        f"{steps['concat_free']['peak_mib']:.1f} MiB, bf16 "
        f"{steps['bf16']['peak_mib']:.1f} MiB")


def glow_step_fn(physics: str, n_cg: int | None, enc=(3, 4, 4),
                 flow=(6, 6, 6)):
    """One reverse-KL step of the cGlow (default: the reference width) at
    64^2 on a batch of 32 kle512 fields (f32, TF32 off, NaN guard on)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.tools.glow_check import glow_model
    from pde_surrogate_torch.train.glow_trainer import (create_glow_state,
                                                        make_reverse_kl_step)
    model = glow_model(64, list(enc), list(flow), 1e-3, "cuda")
    state = create_glow_state(model, lr_max=1.5e-3, total_steps=1000, seed=1)
    step = make_reverse_kl_step(state, SobelFilter(64), 150.0, 50.0,
                                3 * 64 * 64, physics=physics,
                                fvcg_iters=n_cg)
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None].cuda()
    return lambda: step(x)


GLOW_STEPS = [("sobel", None), ("fvcg n_cg=64", 64)]


def phase_glow_step_times():
    """ms per reverse-KL step (CUDA events, 10 steps after 3 warm-up
    steps) and peak device memory, sobel and fvcg (64 CG iterations)."""
    for label, n_cg in GLOW_STEPS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn = glow_step_fn(label.split()[0], n_cg)
        ms = cuda_ms(fn, reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        log(f"[step] cglow reverse-KL {label}: enc [3,4,4] flow [6,6,6] "
            f"64^2 batch 32 f32: {ms:.3f} ms/step ({32 / ms * 1e3:.1f} "
            f"samples/s), peak memory {peak:.1f} MiB")
        del fn


def phase_glow_canonical_step():
    """ms per reverse-KL step (CUDA events, 10 steps after 3 warm-up
    steps) and peak device memory of R3's canonical cGlow (enc [3,3,3,3],
    flow [4,4,4,4], the JAX package's 200-epoch kle512 run at 64^2),
    Sobel, and what 200 epochs of 256 steps take at that rate."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn = glow_step_fn("sobel", None, enc=(3, 3, 3, 3), flow=(4, 4, 4, 4))
    ms = cuda_ms(fn, reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"[step] cglow canonical: enc [3,3,3,3] flow [4,4,4,4] 64^2 batch "
        f"32 sobel f32: {ms:.3f} ms/step ({32 / ms * 1e3:.1f} samples/s), "
        f"peak memory {peak:.1f} MiB; 51200 steps at this rate "
        f"{51200 * ms / 6e4:.1f} min")
    del fn


class MainPath:
    """Drives each path through the CLIs in one temporary tree and counts
    K1's launches per path (zeroed just before, read just after)."""

    WIDTH = ["--imsize", "64", "--blocks", "6,8,6", "--growth-rate", "16",
             "--init-features", "48", "--ntrain", "512", "--ntest", "128",
             "--batch-size", "32", "--test-batch-size", "64",
             "--ckpt-freq", "1", "--no-plot", "--device", "cuda"]

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.data1 = os.path.join(tmp, "data1")
        self.data2 = os.path.join(tmp, "data2")
        self.launches: dict[str, int] = {}

    def drive(self, label: str, fn, needs_k1: bool = False):
        from pde_surrogate_torch.ops.kernels.cg_darcy import solve_darcy_cg
        solve_darcy_cg.launches = 0
        tic = time.perf_counter()
        result = fn()
        n = solve_darcy_cg.launches
        self.launches[label] = n
        log(f"[main] {label}: {time.perf_counter() - tic:.2f} s, "
            f"K1 launches {n}")
        if needs_k1:
            check(n > 0, f"{label} did not launch K1")
        return result

    def train(self, label: str, module, *argv, exp: str, needs_k1=False,
              check_descent=True, argv0=None, data_dir=None):
        """One training CLI run in its own exp dir (``argv0`` in place of
        ``WIDTH``, data in ``data_dir``, default ``data2``); checks its
        losses, eval metrics and last checkpoint; returns (state, run
        dir)."""
        exp_dir = os.path.join(self.tmp, exp)
        state, logger = self.drive(label, lambda: module.main(
            (argv0 or self.WIDTH) + ["--data-dir", data_dir or self.data2,
                                     "--exp-dir", exp_dir, *argv]), needs_k1)
        (run_dir,) = [r for r, _, files in os.walk(exp_dir)
                      if "args.txt" in files]
        with open(os.path.join(run_dir, "training", "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        first, last = epochs[0]["loss_first_step"], logger["loss_train"][-1]
        log(f"[main] {label}: first step loss {first:.4f}, last epoch mean "
            f"{last:.4f}; epoch seconds "
            f"{[round(e['epoch_seconds'], 3) for e in epochs]}; R2 "
            f"{logger['r2_test'][-1]}")
        check(all(np.isfinite(logger["loss_train"])) and np.isfinite(first),
              f"{label}: training losses not finite")
        if check_descent:
            check(last < first, f"{label}: the last epoch's mean loss is "
                                f"not below the first step's")
        check(np.isfinite(np.asarray(logger["r2_test"])).all()
              and np.isfinite(np.asarray(logger["nrmse_test"])).all(),
              f"{label}: eval metrics not finite")
        check(os.path.isfile(os.path.join(
            run_dir, "checkpoints", f"model_epoch{len(epochs)}.pt")),
            f"{label}: checkpoint missing")
        return state, run_dir

    def predict(self, label: str, run_dir: str):
        from pde_surrogate_torch.cli import predict_codec
        from pde_surrogate_torch.data.hdf5 import dataset_shapes
        val = os.path.join(self.data2, "64x64", "kle512_lhs1000_val.hdf5")
        pred_path = os.path.join(self.tmp, f"{label}.hdf5")
        pred, rel_l2, r2 = self.drive(label, lambda: predict_codec.main([
            "--device", "cuda", "--run-dir", run_dir, "--input", val,
            "--output", pred_path]))
        log(f"[main] {label}: rel-L2 {rel_l2}, R2 {r2}")
        check(pred.shape == (128, 3, 64, 64), f"prediction shape {pred.shape}")
        check(np.isfinite(pred).all() and np.isfinite(rel_l2).all()
              and np.isfinite(r2).all(), "predictions or metrics not finite")
        check(dataset_shapes(pred_path) == {"input": (128, 1, 64, 64),
                                            "output": (128, 3, 64, 64)},
              "prediction file shapes")
        return rel_l2, r2

    def run(self) -> int:
        """Every path; returns K1's launches summed over them."""
        from pde_surrogate_torch.cli import _codec_common, make_dataset
        from pde_surrogate_torch.cli import train_codec_max_likelihood as mle
        from pde_surrogate_torch.cli import \
            train_codec_mixed_residual as train
        from pde_surrogate_torch.data.hdf5 import dataset_shapes

        self.drive("make_dataset", lambda: make_dataset.main([
            "--device", "cuda", "--data-dir", self.data1, "--imsize", "64",
            "--kle", "512", "--ntrain", "64", "--nval", "128", "--ntest",
            "64", "--n-monte-carlo", "64"]), needs_k1=True)
        _, sobel_run = self.train("train sobel", train, "--epochs", "2",
                                  exp="sobel", needs_k1=True)
        self.sobel_run = sobel_run
        sobel_metrics = self.predict("predict sobel", sobel_run)
        _, fvcg_run = self.train("train fvcg", train, "--epochs", "2",
                                 "--physics", "fvcg", exp="fvcg")
        # 2 epochs: the Sobel part's loss rises through the first epoch
        # (the sobel run's epoch-1 mean is above its first step) and falls
        # in the second
        self.train("train sobel_fvcg", train, "--epochs", "2", "--physics",
                   "sobel_fvcg", "--fvcg-flux-weight", "1", exp="hybrid")

        train_file = os.path.join(self.data2, "64x64",
                                  "kle512_lhs10000_train.hdf5")
        check("output" not in dataset_shapes(train_file),
              "the train split should hold inputs only before MLE")
        _, mle_run = self.train("train mle", mle, "--epochs", "2", exp="mle",
                                needs_k1=True)
        check(dataset_shapes(train_file)["output"] == (512, 3, 64, 64),
              "MLE did not attach the train labels")
        self.predict("predict mle", mle_run)

        # 2 epochs at a fine-tuning lr: the warm start's first batch lies
        # below the mean loss of its first epoch, which a fresh Adam at the
        # default lr raises further
        warm, _ = self.train("train fvcg --init-from", train, "--epochs", "2",
                             "--physics", "fvcg", "--lr", "3e-4",
                             "--init-from", f"{fvcg_run}:2", exp="warm")
        # the warm start the CLI applies before its first step, into a
        # fresh model of the same width
        src = torch.load(os.path.join(fvcg_run, "checkpoints",
                                      "model_epoch2.pt"),
                         map_location="cuda", weights_only=True)["model"]
        model = _codec_common.build_model(train.Parser().parse_args(
            self.WIDTH), torch.device("cuda"))
        fresh = {n: v.clone() for n, v in model.state_dict().items()}
        _codec_common._warm_start(model, f"{fvcg_run}:2")
        got = model.state_dict()
        same = got.keys() == src.keys() and all(
            torch.equal(got[n], v) for n, v in src.items())
        moved = any(not torch.equal(fresh[n], src[n])
                    for n in src if src[n].is_floating_point())
        steps = 2 * (512 // 32)
        log(f"[main] --init-from: warm-started weights equal to the source's "
            f"epoch 2: {same} (a fresh model's differ: {moved}); the warm "
            f"run took {warm.step} optimizer steps from step 0 "
            f"(expected {steps})")
        check(same and moved, "--init-from did not load the source's weights")
        check(warm.step == steps, "--init-from did not start a fresh "
                                  "optimizer and schedule")

        exp = os.path.join(self.tmp, "find_lr")
        self.drive("find-lr", lambda: train.main(
            self.WIDTH + ["--data-dir", self.data2, "--exp-dir", exp,
                          "--find-lr"]))
        (run_dir,) = [r for r, _, files in os.walk(exp) if "args.txt" in files]
        table = np.loadtxt(os.path.join(run_dir, "find_lr.txt"), ndmin=2)
        log(f"[main] find-lr: {len(table)} rows, log10 lr "
            f"{table[0, 0]:.2f}..{table[-1, 0]:.2f}, smoothed loss "
            f"{table[0, 1]:.4f}..{table[-1, 1]:.4f}")
        check(len(table) > 0 and np.isfinite(table).all(),
              "find_lr.txt has no rows or non-finite ones")
        data3 = os.path.join(self.tmp, "data3")
        self.solve("solve_fc", "solve_fc_mixed_residual", data3,
                   needs_k1=True)
        self.solve("solve_conv", "solve_conv_mixed_residual", data3)
        self.solve("solve_conv --nonlinear", "solve_conv_mixed_residual",
                   data3, "--nonlinear")
        self.glow()
        self.codec_options(train, mle, sobel_run, sobel_metrics)
        total = sum(self.launches.values())
        log(f"[main] K1 launches by path: {self.launches}; total {total}")
        return total

    def codec_options(self, train, mle, sobel_run: str, sobel_metrics):
        """--dtype bf16 (in a fresh data dir, whose val split the kernel
        labels; figures on, so that a card without matplotlib prints its
        note), --concat-free with --profile-epoch 1, the supervised driver
        with all three, each served by predict_codec; then
        import_torch_ckpt of a bare .pth of the f32 Sobel run's checkpoint,
        whose predictions must give the source run's metrics."""
        import contextlib
        import importlib.util

        from pde_surrogate_torch.cli import import_torch_ckpt
        width = [a for a in self.WIDTH if a != "--no-plot"]
        data5 = os.path.join(self.tmp, "data5")
        printed = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, printed)):
            _, bf16_run = self.train(
                "train sobel --dtype bf16", train, "--epochs", "2",
                "--dtype", "bf16", exp="bf16", needs_k1=True,
                argv0=width, data_dir=data5)
        rel_l2, r2 = self.predict("predict sobel --dtype bf16", bf16_run)
        log(f"[main] sobel 2 epochs, rel-L2 / R2 (u, s1, s2): bf16 "
            f"{np.round(rel_l2, 4)} / {np.round(r2, 4)}; f32 "
            f"{np.round(sobel_metrics[0], 4)} / {np.round(sobel_metrics[1], 4)}")
        train_dir = os.path.join(bf16_run, "training")
        stats = sorted(f for f in os.listdir(train_dir) if f.endswith(".txt"))
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        figures = sorted(f for f in os.listdir(train_dir)
                         if f.endswith(".pdf"))
        noted = "[note] matplotlib is not installed" in printed.getvalue()
        log(f"[main] figures: matplotlib installed {has_mpl}; note printed "
            f"{noted}; stats {stats}; curves {figures}")
        check(len(stats) == 5, "the .txt stats were not written")
        check(noted != has_mpl and (len(figures) == 5) == has_mpl,
              "figures: neither drawn nor noted")

        # 128 fields (4 steps an epoch): the profiler records every op of
        # the epoch, ~3000 kernels a concat-free step
        _, cf_run = self.train("train sobel --concat-free --profile-epoch 1",
                               train, "--epochs", "2", "--concat-free",
                               "--profile-epoch", "1", "--ntrain", "128",
                               exp="cf")
        self.predict("predict sobel --concat-free", cf_run)
        self.trace_kernels(cf_run)
        _, mle_run = self.train(
            "train mle --dtype bf16 --concat-free --profile-epoch 1", mle,
            "--epochs", "2", "--dtype", "bf16", "--concat-free",
            "--profile-epoch", "1", "--ntrain", "128", exp="mle_options")
        self.predict("predict mle --dtype bf16 --concat-free", mle_run)
        self.trace_kernels(mle_run)

        pth = os.path.join(self.tmp, "model_epoch2.pth")
        torch.save(torch.load(os.path.join(sobel_run, "checkpoints",
                                           "model_epoch2.pt"),
                              map_location="cpu", weights_only=True)["model"],
                   pth)
        imported = os.path.join(self.tmp, "imported")
        self.drive("import_torch_ckpt", lambda: import_torch_ckpt.main([
            "--pth", pth, "--out-run-dir", imported, "--imsize", "64",
            "--blocks", "6", "8", "6", "--device", "cuda"]))
        rel_l2, r2 = self.predict("predict imported", imported)
        diff = max(np.abs(rel_l2 - sobel_metrics[0]).max(),
                   np.abs(r2 - sobel_metrics[1]).max())
        log(f"[main] imported run vs its source: metrics differ by "
            f"{diff:.3e} (0)")
        check(diff == 0.0, "the imported run's metrics differ from the "
                           "source run's")

    def trace_kernels(self, run_dir: str):
        """The CUDA kernels in a run's profiled epoch's trace."""
        path = os.path.join(run_dir, "training", "profile", "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"[main] {os.path.basename(run_dir)} --profile-epoch 1: trace "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, {len(events)} "
            f"events, {kernels} CUDA kernels")
        check(kernels > 0, "the profiled epoch's trace holds no CUDA kernel")

    def solve(self, label: str, module: str, data_dir: str, *argv,
              needs_k1=False):
        """One single-instance solver CLI at its default widths on kle512
        test field 8: a 300-step Adam warmup, then 3 zoom L-BFGS epochs.
        Checks the losses (finite; L-BFGS ends below the warmup) and the
        prediction against the reference solution."""
        import importlib
        cli = importlib.import_module(f"pde_surrogate_torch.cli.{module}")
        exp_dir = os.path.join(self.tmp, "solver_" + label.replace(" ", ""))
        _, logger, target = self.drive(label, lambda: cli.main([
            "--device", "cuda", "--no-plot", "--data-dir", data_dir,
            "--exp-dir", exp_dir, "--adam-warmup", "300", "--epochs", "3",
            "--test-freq", "3", "--ckpt-freq", "3", *argv]), needs_k1)
        losses = logger["loss"]
        epoch, rel = logger["rel_l2"][-1]
        log(f"[main] {label}: Adam {logger['adam_ms_per_step']:.3f} ms/step "
            f"(loss {logger['adam_loss']:.6f}); L-BFGS epochs "
            f"{[round(t, 3) for t in logger['epoch_seconds']]} s, loss "
            f"evaluations {logger['evals']}, losses "
            f"{[round(v, 6) for v in losses]}; rel-L2 (u, s1, s2) at epoch "
            f"{epoch}: {[round(r, 4) for r in rel]}")
        (pred,) = [os.path.join(r, "epoch3.npy")
                   for r, _, files in os.walk(exp_dir) if "epoch3.npy" in files]
        check(np.load(pred).shape == target.shape == (3, 64, 64),
              f"{label}: prediction or reference shape")
        check(np.isfinite(losses).all() and np.isfinite(rel).all(),
              f"{label}: losses or rel-L2 not finite")
        check(losses[-1] < logger["adam_loss"],
              f"{label}: L-BFGS did not go below the Adam warmup's loss")

    def glow(self):
        """The cGlow at its reference width (enc [3,4,4], flow [6,6,6],
        dense coupling, LU, beta 150, weight bound 50, lr 1.5e-3, batch 32)
        on kle512 at 64^2 in a fresh data dir: 2 epochs with --data-init
        (the kernel labels the val split and, for the data-init, the train
        split), predict_cglow on the val split, then post_cglow (the kernel
        labels the 512-field Monte-Carlo set)."""
        import contextlib

        import scipy.io

        from pde_surrogate_torch.cli import post_cglow, predict_cglow
        from pde_surrogate_torch.cli import train_cglow_reverse_kl as train
        from pde_surrogate_torch.data.hdf5 import dataset_shapes
        data = os.path.join(self.tmp, "data4")
        exp = os.path.join(self.tmp, "cglow")
        printed = io.StringIO()
        with contextlib.redirect_stdout(_Tee(sys.stdout, printed)):
            state, logger = self.drive("train cglow", lambda: train.main(
                ["--imsize", "64", "--kle", "512", "--ntrain", "512",
                 "--ntest", "128", "--batch-size", "32", "--test-batch-size",
                 "64", "--ckpt-freq", "1", "--no-plot", "--device", "cuda",
                 "--epochs", "2", "--data-init", "--data-dir", data,
                 "--exp-dir", exp]),
                needs_k1=True)
        (run_dir,) = [r for r, _, files in os.walk(exp) if "args.txt" in files]
        with open(os.path.join(run_dir, "training", "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        log(f"[main] train cglow: first step loss "
            f"{epochs[0]['loss_first_step']:.4f}, epoch mean losses "
            f"{[round(e['loss_train'], 4) for e in epochs]}, epoch seconds "
            f"{[round(e['epoch_seconds'], 3) for e in epochs]}, samples/s "
            f"{[round(e['samples_per_sec'], 1) for e in epochs]}, skipped "
            f"steps {[e['skipped_steps'] for e in epochs]}; R2 "
            f"{logger['r2_test'][-1]}, test entropy "
            f"{logger['entropy_test'][-1]:.4f}")
        check("Finished data initialization" in printed.getvalue(),
              "train cglow: no data initialization")
        check(np.isfinite(logger["loss_train"]).all()
              and np.isfinite(epochs[0]["loss_first_step"]),
              "train cglow: training losses not finite")
        check(np.isfinite(np.asarray(logger["r2_test"])).all(),
              "train cglow: R2 not finite")
        check(os.path.isfile(os.path.join(run_dir, "checkpoints",
                                          "model_epoch2.pt")),
              "train cglow: checkpoint missing")

        val = os.path.join(data, "64x64", "kle512_lhs1000_val.hdf5")
        pred_path = os.path.join(self.tmp, "predict_cglow.hdf5")
        mean, std, rel_l2, r2 = self.drive(
            "predict_cglow", lambda: predict_cglow.main([
                "--device", "cuda", "--run-dir", run_dir, "--input", val, "--output", pred_path]))
        log(f"[main] predict_cglow: rel-L2 {rel_l2}, R2 {r2}, mean std "
            f"{float(np.mean(std)):.4e}")
        check(mean.shape == std.shape == (128, 3, 64, 64),
              f"predict_cglow shapes {mean.shape} {std.shape}")
        check(np.isfinite(std).all() and np.isfinite(rel_l2).all()
              and np.isfinite(r2).all(),
              "predict_cglow: output_std or metrics not finite")
        check(dataset_shapes(pred_path) == {
            "input": (128, 1, 64, 64), "output": (128, 3, 64, 64),
            "output_std": (128, 3, 64, 64)}, "predict_cglow file shapes")

        uq = self.drive("post_cglow", lambda: post_cglow.main([
            "--device", "cuda", "--run-dir", run_dir, "--n-monte-carlo",
            "512", "--ntest", "128"]),
            needs_k1=True)
        log(f"[main] post_cglow: seconds per task "
            f"{ {k: round(v, 3) for k, v in uq.seconds.items()} }")
        post = uq.post_dir
        arrays = {name: np.loadtxt(os.path.join(post, name)) for name in (
            "nrmse_test.txt", "r2_test.txt", "log_stats.txt",
            "uncertainty_quality/reliability_diagram.txt")}
        for name in ("pred", "target", "locations"):
            arrays[f"dist_estimate/{name}.npy"] = np.load(
                os.path.join(post, "dist_estimate", f"{name}.npy"))
        mat = scipy.io.loadmat(os.path.join(post, "out_stats",
                                            "out_stats.mat"))
        for key in ("sample_mean", "sample_var", "y_pred_EE", "y_pred_VE",
                    "y_pred_EV", "y_pred_VV"):
            arrays[f"out_stats.mat:{key}"] = mat[key]
        at_x = [f for f in os.listdir(os.path.join(post, "predict_at_x"))
                if f.endswith(".npz")]
        for f in at_x:
            with np.load(os.path.join(post, "predict_at_x", f)) as z:
                arrays.update({f"{f}:{k}": z[k] for k in z.files})
        bad = [k for k, a in arrays.items() if not np.isfinite(a).all()]
        log(f"[main] post_cglow: {len(arrays)} arrays in {post}; R2 "
            f"{arrays['r2_test.txt']}, reliability (p=0.01..0.99, u) "
            f"{np.round(arrays['uncertainty_quality/reliability_diagram.txt'][:, 1], 3)}")
        check(len(at_x) == 6 and not bad,
              f"post_cglow: missing or non-finite artefacts {bad}")
        check(mat["y_pred_EE"].shape == (3, 64, 64), "out_stats.mat shapes")


class _Tee(io.TextIOBase):
    """Writes to every stream it holds."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


SOBEL = dict(physics="sobel")
STEP_CASES = [
    # label, imsize, blocks, loss kind, physics keywords, DenseED options
    ("sobel", 64, [6, 8, 6], "mixed_residual", SOBEL, {}),
    ("fvcg n_cg=64", 64, [6, 8, 6], "mixed_residual",
     dict(physics="fvcg", fvcg_iters=64), {}),
    ("fvcg n_cg=0", 64, [6, 8, 6], "mixed_residual",
     dict(physics="fvcg", fvcg_iters=0), {}),
    ("sobel_fvcg n_cg=64", 64, [6, 8, 6], "mixed_residual",
     dict(physics="sobel_fvcg", fvcg_iters=64), {}),
    ("mle", 64, [6, 8, 6], "mle", {}, {}),
    ("fvcg n_cg=256", 128, [4, 6, 8, 6, 4], "mixed_residual",
     dict(physics="fvcg", fvcg_iters=256), {}),
]
VARIANT_STEPS = [
    ("sobel bf16", 64, [6, 8, 6], "mixed_residual", SOBEL,
     dict(dtype=torch.bfloat16)),
    ("sobel concat-free", 64, [6, 8, 6], "mixed_residual", SOBEL,
     dict(concat_free=True)),
    ("sobel concat-free bf16", 64, [6, 8, 6], "mixed_residual", SOBEL,
     dict(concat_free=True, dtype=torch.bfloat16)),
    ("sobel remat", 64, [6, 8, 6], "mixed_residual", SOBEL,
     dict(remat=True)),
]


def _step_fn(imsize, blocks, kind, physics_kw, model_kw):
    """A training step of DenseED blocks/16/48 (with the options
    ``model_kw``) on a batch of 32 kle512 fields, TF32 off."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.codec import DenseED
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.codec_trainer import (
        create_state, make_mixed_residual_step, make_mle_step)
    torch.manual_seed(0)
    model = DenseED(1, 3, imsize, blocks, growth_rate=16,
                    init_features=48, **model_kw).cuda()
    state = create_state(model, lr_max=1e-3, total_steps=1000)
    x = torch.from_numpy(sample_kle(32, imsize, 512, rng=3))[:, None].cuda()
    if kind == "mle":
        y = torch.from_numpy(np.random.default_rng(3).normal(
            0, 1, (32, 3, imsize, imsize)).astype(np.float32)).cuda()
        step = make_mle_step(state)
        return lambda: step(x, y)
    step = make_mixed_residual_step(state, SobelFilter(imsize), 10.0,
                                    **physics_kw)
    return lambda: step(x)


def phase_step_times() -> dict:
    """ms per training step (CUDA events, 5 warm-up steps) and peak device
    memory of each objective; returns {label: ms}."""
    out = {}
    for label, imsize, blocks, kind, physics_kw, model_kw in (
            STEP_CASES + VARIANT_STEPS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn = _step_fn(imsize, blocks, kind, physics_kw, model_kw)
        ms = cuda_ms(fn, reps=10 if imsize > 64 else 20, warmup=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        out[label] = ms
        dtype = "bf16" if "dtype" in model_kw else "f32"
        log(f"[step] {label}: DenseED {blocks}/16/48 {imsize}^2 batch 32 "
            f"{dtype}: {ms:.3f} ms/step ({32 / ms * 1e3:.1f} samples/s), "
            f"peak memory {peak:.1f} MiB")
        del fn
    cg = out["fvcg n_cg=64"] - out["fvcg n_cg=0"]
    log(f"[step] in-loss CG at 64^2, n_cg=64: {cg:.3f} ms/step "
        f"({cg / out['fvcg n_cg=64'] * 100:.1f} % of the fvcg step; fvcg / "
        f"sobel {out['fvcg n_cg=64'] / out['sobel']:.2f}x)")
    log("[step] sobel variants / f32 sobel: " + ", ".join(
        f"{c[0][6:]} {out[c[0]] / out['sobel']:.2f}x" for c in VARIANT_STEPS))
    return out


def conv_solver_loss_fn(device, n: int = 64):
    """The conv solver's objective at its default width: Decoder [8,6]/16/48
    (seeded weights, train-mode BatchNorm) on a fixed (1, 1, n/4, n/4)
    latent, the Sobel mixed residual of a kle512 field.  Returns (loss of
    the flat parameter vector, that vector, the Decoder)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.codec import Decoder
    from pde_surrogate_torch.ops.darcy import mixed_residual_loss
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.lbfgs import FlatParams
    torch.manual_seed(1)
    model = Decoder(1, 3, [8, 6]).to(device).train()
    flat = FlatParams(model)
    latent = 0.5 * torch.randn(1, 1, n // 4, n // 4, device=device)
    K = torch.from_numpy(sample_kle(1, n, 512, rng=8))[:, None].to(device)
    sobel = SobelFilter(n)

    def loss(v):
        out = torch.func.functional_call(model, flat.unflatten(v), (latent,))
        return mixed_residual_loss(K, out, sobel)[0]
    return loss, flat.vector(), model


def _adam_step(loss, v, _model=None):
    """One Adam step (lr 2e-3) of ``loss`` on the flat vector ``v``, as the
    solvers' warmup takes it."""
    x = v.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=2e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss(x).backward()
        opt.step()
    return step


def solver_steps():
    return [("solve_fc Adam step", _adam_step(*fc_loss_fn("cuda",
                                                          torch.float32))),
            ("solve_conv Adam step", _adam_step(*conv_solver_loss_fn("cuda")))]


def phase_tpu_precision(path: "MainPath") -> None:
    """One Sobel training step of DenseED [6,8,6]/16/48 at 64^2, batch 32,
    with its convs at the emulated TPU DEFAULT precision beside the f32
    step from the same weights and batch: both losses finite and apart by
    more than 0 and less than 1e-2 relative; each step timed.  Then
    ``tools/r2_breakdown`` on the main path's Sobel run: its R^2 within
    1e-6 relative of what the CLI logged at that epoch."""
    from pde_surrogate_torch.tools.f1_tpu_precision import tpu_default_convs
    from pde_surrogate_torch.tools.r2_breakdown import breakdown
    losses, ms = {}, {}
    for name, ctx in (("f32", contextlib.nullcontext), ("tpu",
                                                        tpu_default_convs)):
        step = _step_fn(64, [6, 8, 6], "mixed_residual", SOBEL, {})
        with ctx():
            losses[name] = float(step()["loss"])
            ms[name] = cuda_ms(step, reps=10, warmup=2)
    rel = abs(losses["tpu"] - losses["f32"]) / abs(losses["f32"])
    log(f"[tpu precision] first step loss f32 {losses['f32']:.6f}, emulated "
        f"TPU DEFAULT {losses['tpu']:.6f} (relative difference {rel:.3e}); "
        f"{ms['f32']:.3f} and {ms['tpu']:.3f} ms/step; {gpu_name_power()}")
    check(np.isfinite(list(losses.values())).all() and 0 < rel < 1e-2,
          f"[tpu precision] the emulated step's loss is {rel} from f32's")
    tic = time.perf_counter()
    res = breakdown(path.sobel_run, device="cuda")
    u = res["channels"]["u"]
    log(f"[tpu precision] r2_breakdown of the Sobel run, epoch "
        f"{res['epoch']}: R2 {res['r2']}, the CLI's {res['cli_r2']} "
        f"(largest relative difference {res['r2_rel_diff']:.2e}); u: mean "
        f"offsets {100 * u['offset_share']:.1f} % of the SSE, half of it in "
        f"{u['n_half']} of {res['n']} samples; "
        f"{time.perf_counter() - tic:.2f} s")
    check(res["cli_r2"] is not None and res["r2_rel_diff"] <= 1e-6,
          "[tpu precision] r2_breakdown does not reproduce the CLI's R2")


def phase_solver_step_times():
    """ms per Adam step of both solvers at their default widths, by CUDA
    events (20 steps after 5 warm-up steps)."""
    for label, fn in solver_steps():
        ms = cuda_ms(fn, reps=20, warmup=5)
        log(f"[step] {label}: {ms:.3f} ms/step")


def profile_call(fn) -> tuple[float, list]:
    """One call of ``fn`` under torch.profiler: its wall time by CUDA
    events (ms) and the device kernels it launched (the profiler's
    events; its annotations of host ranges on the device, named with a
    '#', left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end), [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "#" not in e.name]


def phase_step_profile():
    """One step of sobel, of its bf16, concat-free and remat variants and
    of fvcg (n_cg=64) at 64^2, one Adam step of each solver and one cGlow
    reverse-KL step (sobel, batch 32), under
    torch.profiler: device kernels launched and their summed time against
    the step's wall time (CUDA events); the convolution and matmul FLOPs of
    one step, counted by torch.utils.flop_counter, over that busy time."""
    from torch.utils.flop_counter import FlopCounterMode
    cases = [(c[0], lambda c=c: _step_fn(*c[1:]))
             for c in STEP_CASES[:2] + VARIANT_STEPS]
    cases += [(label, lambda f=fn: f) for label, fn in solver_steps()]
    cases += [("cglow sobel", lambda: glow_step_fn("sobel", None))]
    for label, make in cases:
        fn = make()
        for _ in range(3):
            fn()
        with FlopCounterMode(display=False) as counter:
            fn()
        flops = counter.get_total_flops()
        wall, kernels = profile_call(fn)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        if kernels:
            log(f"[profile] {label}: {len(kernels)} device kernels in one "
                f"step, {busy:.3f} ms busy of {wall:.3f} ms "
                f"({busy / wall * 100:.1f} %); {flops / 1e9:.3f} GFLOP of "
                f"convolutions and matmuls, {flops / busy / 1e9:.3f} TFLOP/s "
                f"of busy time")
        else:
            log(f"[profile] {label}: the profiler recorded no device "
                f"kernels (device time not measured); step {wall:.3f} ms")
        del fn


DIST_CODEC = dict(in_channels=1, out_channels=3, imsize=64, blocks=[6, 8, 6],
                  growth_rate=16, init_features=48)
DIST_GLOW = dict(img_size=64, x_channels=1, y_channels=3, enc_blocks=[3, 4, 4],
                 flow_blocks=[6, 6, 6])
K1_TWIN_ATOL = 5e-5     # K1 against its plain PyTorch twin (tests, [K1])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def _turns(first, second, reps: int, warmup: int) -> tuple[float, float]:
    """ms per call of ``first`` and of ``second`` (zero-argument
    callables, such as the plain and the mesh step) by CUDA events, timed
    in turns (first, second, second, first) and averaged per version."""
    f1 = cuda_ms(first, reps, warmup)
    s1 = cuda_ms(second, reps, warmup)
    s2 = cuda_ms(second, reps, warmup)
    f2 = cuda_ms(first, reps, warmup)
    return (f1 + f2) / 2, (s1 + s2) / 2


def _dist_checks(mesh) -> None:
    """[dist] on one rank of a one-rank NCCL group: the DenseED and cGlow
    steps under the mesh (BatchNorm moments reduced over it, gradients
    all-reduced) against the plain steps, three steps in float64 and the
    first loss in float32 (``tools/dist_check``: three float32 steps are
    ill-conditioned), with both float32 steps timed; the sharded Darcy
    solve against K1."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.codec import DenseED
    from pde_surrogate_torch.ops.kernels.cg_darcy import solve_darcy_cg
    from pde_surrogate_torch.parallel.spatial import (solve_darcy_spatial,
                                                      spatial_mesh)
    from pde_surrogate_torch.tools import dist_check as dc
    from pde_surrogate_torch.tools.glow_check import glow_model
    card = gpu_name_power()
    dev = mesh.device
    log(f"[dist] one-rank NCCL group: rank {mesh.rank} of "
        f"{mesh.world_size} on {mesh.device}")

    torch.manual_seed(0)
    sd = DenseED(**DIST_CODEC).state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None]
    m64 = dc.codec_run(mesh, sd, x, DIST_CODEC, 3, dev, torch.float64)
    p64 = dc.codec_run(None, sd, x, DIST_CODEC, 3, dev, torch.float64)
    m32 = dc.codec_run(mesh, sd, x, DIST_CODEC, 1, dev)
    p32 = dc.codec_run(None, sd, x, DIST_CODEC, 1, dev)
    loss_rel = _rel(m64["losses"], p64["losses"])
    state_err = max(float((v - p64["state"][k]).abs().max())
                    for k, v in m64["state"].items()
                    if not k.endswith("num_batches_tracked"))
    first_rel = _rel(m32["losses"], p32["losses"])
    log(f"[dist] codec: DenseED [6,8,6]/16/48 64^2 batch 32, 3 steps in "
        f"float64: loss {loss_rel:.3e} relative (bound "
        f"{dc.CODEC_LOSS_RTOL:g}), parameters and BN buffers {state_err:.3e} "
        f"(bound {dc.CODEC_STATE_ATOL:g}); first float32 loss "
        f"{first_rel:.3e} relative")
    check(loss_rel <= dc.CODEC_LOSS_RTOL and first_rel <= dc.CODEC_LOSS_RTOL
          and state_err <= dc.CODEC_STATE_ATOL,
          "[dist] codec: the mesh steps differ from the plain steps")
    step_p, _ = dc.codec_step(None, sd, x, DIST_CODEC, dev)
    step_m, _ = dc.codec_step(mesh, sd, x, DIST_CODEC, dev)
    ms_p, ms_m = _turns(step_p, step_m, reps=10, warmup=3)
    log(f"[dist] codec step f32: plain {ms_p:.3f} ms, mesh {ms_m:.3f} ms "
        f"({ms_m / ms_p:.2f}x); {card}")
    del step_p, step_m

    # heads at 1e-3, as [glow]'s well-conditioned case: with the zero
    # init's heads the coupling nets, and their BatchNorm, do not act
    sd = glow_model(64, DIST_GLOW["enc_blocks"], DIST_GLOW["flow_blocks"],
                    1e-3, "cpu").state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=4))[:, None]
    m64 = dc.glow_run(mesh, sd, x, DIST_GLOW, 3, None, dev, torch.float64)
    p64 = dc.glow_run(None, sd, x, DIST_GLOW, 3, None, dev, torch.float64)
    m32 = dc.glow_run(mesh, sd, x, DIST_GLOW, 1, None, dev)
    p32 = dc.glow_run(None, sd, x, DIST_GLOW, 1, None, dev)
    loss_rel = _rel(m64["losses"], p64["losses"])
    first_rel = _rel(m32["losses"], p32["losses"])
    log(f"[dist] cglow: enc [3,4,4] flow [6,6,6] 64^2 batch 32, 3 losses in "
        f"float64 {loss_rel:.3e} relative, first float32 loss "
        f"{first_rel:.3e} (bound {dc.GLOW_LOSS_RTOL:g})")
    check(loss_rel <= dc.GLOW_LOSS_RTOL and first_rel <= dc.GLOW_LOSS_RTOL,
          "[dist] cglow: the mesh losses differ from the plain losses")
    step_p, _ = dc.glow_step(None, sd, x, DIST_GLOW, dev)
    step_m, _ = dc.glow_step(mesh, sd, x, DIST_GLOW, dev)
    ms_p, ms_m = _turns(step_p, step_m, reps=5, warmup=2)
    log(f"[dist] cglow step f32: plain {ms_p:.3f} ms, mesh {ms_m:.3f} ms "
        f"({ms_m / ms_p:.2f}x); {card}")
    del step_p, step_m
    torch.cuda.empty_cache()

    smesh = spatial_mesh(1, mesh.device)
    K = torch.from_numpy(sample_kle(64, 64, 512, rng=5)).to(dev)
    n_iter = 24 * 64
    u_sp = solve_darcy_spatial(K, smesh, n_iter)
    u_k1 = solve_darcy_cg(K, n_iter)
    err = float((u_sp - u_k1).abs().max())
    ms_sp = cuda_ms(lambda: solve_darcy_spatial(K, smesh, n_iter), reps=2)
    ms_k1 = cuda_ms(lambda: solve_darcy_cg(K, n_iter), reps=20)
    log(f"[dist] spatial: solve_darcy_spatial on 1 rank, 64 fields of 64^2, "
        f"{n_iter} iterations: max |u - K1| {err:.3e} (bound "
        f"{K1_TWIN_ATOL:g}, K1's own rule against its plain twin); {ms_sp:.3f} ms against "
        f"K1's {ms_k1:.3f} ms ({ms_sp / ms_k1:.0f}x); {card}")
    check(err <= K1_TWIN_ATOL, "[dist] spatial: the sharded solve differs "
                               "from K1")


def phase_dist(path: "MainPath") -> None:
    """[dist]: the mesh checks in a one-rank NCCL group (a file store in a
    temporary directory, destroyed afterwards), then the codec CLI with
    --n-devices 1 (one rank in this process; a fresh data dir, whose val
    labels K1 solves on that rank) against the same run without it: one
    epoch of one step, each logged metric within 1e-5 relative.  With two
    cards --n-devices 2 too."""
    from pde_surrogate_torch.cli import train_codec_mixed_residual as train
    from pde_surrogate_torch.parallel.launch import run
    n_cards = torch.cuda.device_count()
    log(f"[dist] torch.cuda.device_count() = {n_cards}")
    run(_dist_checks, 1, device="cuda", workdir=path.tmp)

    data = os.path.join(path.tmp, "data_dist")
    argv = (path.WIDTH + ["--ntrain", "32", "--ntest", "64", "--epochs", "1",
                          "--data-dir", data])

    def cli(label, exp, *extra, needs_k1=False):
        return path.drive(label, lambda: train.main(
            argv + ["--exp-dir", os.path.join(path.tmp, exp), *extra]),
            needs_k1)[1]

    dp = cli("dist train sobel --n-devices 1", "dist1", "--n-devices", "1",
             needs_k1=True)
    one = cli("dist train sobel", "dist0")
    runs = [("--n-devices 1", dp)]
    if n_cards >= 2:
        runs.append(("--n-devices 2", cli("dist train sobel --n-devices 2",
                                          "dist2", "--n-devices", "2")))
    else:
        log("[dist] --n-devices 2: needs two cards; this machine has one")
    for label, got in runs:
        rel = max(_rel(torch.tensor(got[k]), torch.tensor(one[k]))
                  for k in one)
        log(f"[dist] cli {label} against one process: metrics within "
            f"{rel:.3e} relative (bound 1e-5)")
        check(rel <= 1e-5, f"[dist] cli {label}: metrics differ")


def _dpsp_checks(mesh) -> None:
    """[dpsp] (b)-(g) on one rank of a one-rank NCCL group: the 1x1
    data x space mesh's Sobel steps against the plain ones, three in
    float64 and the first in float32 (``tools/dist_check``'s rules), then
    the f32 steps timed in turns, with the peak memory of each (b, c);
    then the finite-volume objectives and the supervised step (d), the
    eval step (e), dropout (f) and the cGlow (g)."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.models.codec import DenseED
    from pde_surrogate_torch.parallel.mesh import dp_sp_mesh
    from pde_surrogate_torch.tools import dist_check as dc
    card = gpu_name_power()
    dev = mesh.device
    m2 = dp_sp_mesh(1, 1, dev)
    torch.manual_seed(0)
    sd = DenseED(**DIST_CODEC).state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None]
    m64 = dc.codec_run(m2, sd, x, DIST_CODEC, 3, dev, torch.float64)
    p64 = dc.codec_run(None, sd, x, DIST_CODEC, 3, dev, torch.float64)
    m32 = dc.codec_run(m2, sd, x, DIST_CODEC, 1, dev)
    p32 = dc.codec_run(None, sd, x, DIST_CODEC, 1, dev)
    loss_rel = _rel(m64["losses"], p64["losses"])
    state_err = max(float((v - p64["state"][k]).abs().max())
                    for k, v in m64["state"].items()
                    if not k.endswith("num_batches_tracked"))
    first_rel = _rel(m32["losses"], p32["losses"])
    log(f"[dpsp] (b) 1x1 data x space mesh, DenseED [6,8,6]/16/48 64^2 "
        f"batch 32, 3 steps in float64: loss {loss_rel:.3e} relative "
        f"(bound {dc.CODEC_LOSS_RTOL:g}), parameters and BN buffers "
        f"{state_err:.3e} (bound {dc.CODEC_STATE_ATOL:g}); first float32 "
        f"loss {first_rel:.3e} relative (bound {dc.CODEC_LOSS_RTOL:g})")
    check(loss_rel <= dc.CODEC_LOSS_RTOL and first_rel <= dc.CODEC_LOSS_RTOL
          and state_err <= dc.CODEC_STATE_ATOL,
          "[dpsp] (b): the mesh steps differ from the plain steps")
    steps, peaks = {}, {}
    for name, m in (("plain", None), ("mesh", m2)):
        step, _ = dc.codec_step(m, sd, x, DIST_CODEC, dev)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**20
        steps[name] = step
    ms_p, ms_m = _turns(steps["plain"], steps["mesh"], reps=10, warmup=3)
    log(f"[dpsp] (c) step f32: plain {ms_p:.3f} ms, 1x1 mesh {ms_m:.3f} ms "
        f"({ms_m / ms_p:.2f}x); peak memory of a step: plain "
        f"{peaks['plain']:.1f} MiB, mesh {peaks['mesh']:.1f} MiB; {card}")
    del steps
    torch.cuda.empty_cache()
    from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast
    y = solve_darcy_batch_fast(x[:, 0].to(dev)).cpu()
    _dpsp_objectives(m2, sd, x, y, card)
    _dpsp_eval(m2, sd, x, y, card)
    _dpsp_dropout(m2, sd, x, card)
    _dpsp_glow(mesh, m2, card)


def _peak_mib(step) -> float:
    """Peak device memory of one call of ``step`` after a first one."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def _state_err(got: dict, want: dict) -> float:
    return max(float((v - want[k]).abs().max()) for k, v in got.items()
               if not k.endswith("num_batches_tracked"))


def _dpsp_objectives(m2, sd, x, y, card) -> None:
    """[dpsp] (d): the fv, fvcg and sobel_fvcg steps (64 CG iterations)
    and the supervised step on the 1x1 mesh against the plain steps:
    three in float64 under (b)'s bounds, the first float32 loss too; the
    f32 steps timed in turns, with the peak memory of each."""
    from pde_surrogate_torch.tools import dist_check as dc
    dev = m2.device
    for obj in ("fv", "fvcg", "sobel_fvcg", "mle"):
        kw = {"physics": obj, "y": y, "n_cg": 64}
        m64 = dc.codec_run(m2, sd, x, DIST_CODEC, 3, dev, torch.float64, **kw)
        p64 = dc.codec_run(None, sd, x, DIST_CODEC, 3, dev, torch.float64,
                           **kw)
        m32 = dc.codec_run(m2, sd, x, DIST_CODEC, 1, dev, **kw)
        p32 = dc.codec_run(None, sd, x, DIST_CODEC, 1, dev, **kw)
        loss_rel = _rel(m64["losses"], p64["losses"])
        state_err = _state_err(m64["state"], p64["state"])
        first_rel = _rel(m32["losses"], p32["losses"])
        steps = {name: dc.codec_step(m, sd, x, DIST_CODEC, dev, **kw)[0]
                 for name, m in (("plain", None), ("mesh", m2))}
        peaks = {name: _peak_mib(st) for name, st in steps.items()}
        ms_p, ms_m = _turns(steps["plain"], steps["mesh"], reps=3, warmup=1)
        log(f"[dpsp] (d) {obj}: 3 steps in float64: loss {loss_rel:.3e} "
            f"relative (bound {dc.CODEC_LOSS_RTOL:g}), parameters and BN "
            f"buffers {state_err:.3e} (bound {dc.CODEC_STATE_ATOL:g}); "
            f"first float32 loss {float(p32['losses'][0]):.6e}, mesh "
            f"{first_rel:.3e} relative; step f32: plain {ms_p:.3f} ms, 1x1 "
            f"mesh {ms_m:.3f} ms ({ms_m / ms_p:.2f}x); peak plain "
            f"{peaks['plain']:.1f} MiB, mesh {peaks['mesh']:.1f} MiB; "
            f"{card}")
        check(loss_rel <= dc.CODEC_LOSS_RTOL
              and first_rel <= dc.CODEC_LOSS_RTOL
              and state_err <= dc.CODEC_STATE_ATOL,
              f"[dpsp] (d) {obj}: the mesh steps differ from the plain steps")
        del steps
        torch.cuda.empty_cache()


def _dpsp_eval(m2, sd, x, y, card) -> None:
    """[dpsp] (e): the eval step (sobel_fvcg, 64 CG iterations) on the
    1x1 mesh against the plain one in float32: per-sample rel-L2 and SSE,
    the consistency and the loss within 1e-5 relative."""
    from pde_surrogate_torch.tools import dist_check as dc
    got = dc.codec_eval_run(m2, None, sd, x, y, DIST_CODEC, "sobel_fvcg", 64,
                            m2.device)
    want = dc.codec_eval_run(None, None, sd, x, y, DIST_CODEC, "sobel_fvcg",
                             64, m2.device)
    errs = {k: _rel(got[k], want[k])
            for k in ("rel_l2", "sse", "consistency", "loss")}
    log("[dpsp] (e) eval sobel_fvcg, 1x1 mesh vs plain, float32: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" relative (bound 1e-5); {card}")
    check(max(errs.values()) <= 1e-5,
          "[dpsp] (e): the mesh eval step differs from the plain one")


def _dpsp_dropout(m2, sd, x, card) -> None:
    """[dpsp] (f): DenseED with dropout 0.1, three float64 Sobel steps on
    the 1x1 mesh against the plain steps, both drawing their masks from
    the step's generator (seed 0, step), under (b)'s bounds."""
    from pde_surrogate_torch.tools import dist_check as dc
    kw = dict(DIST_CODEC, drop_rate=0.1)
    m64 = dc.codec_run(m2, sd, x, kw, 3, m2.device, torch.float64)
    p64 = dc.codec_run(None, sd, x, kw, 3, m2.device, torch.float64)
    loss_rel = _rel(m64["losses"], p64["losses"])
    state_err = _state_err(m64["state"], p64["state"])
    log(f"[dpsp] (f) dropout 0.1, 3 steps in float64: loss {loss_rel:.3e} "
        f"relative (bound {dc.CODEC_LOSS_RTOL:g}), parameters and BN buffers "
        f"{state_err:.3e} (bound {dc.CODEC_STATE_ATOL:g}); {card}")
    check(loss_rel <= dc.CODEC_LOSS_RTOL
          and state_err <= dc.CODEC_STATE_ATOL,
          "[dpsp] (f): the mesh dropout steps differ from the plain steps")


def _dpsp_glow(mesh, m2, card) -> None:
    """[dpsp] (g): the cGlow (enc [3,4,4], flow [6,6,6], 64^2, batch 32,
    heads at 1e-3) with ActNorm data-init on the 1x1 mesh (the group's
    moments, within 2e-5 of its largest value) and three float64
    reverse-KL steps (Sobel) against the plain ones: losses within the
    [dist] cglow bound, parameters and buffers within (b)'s; the f32 step (after the
    data-init) timed in turns, with the peak memory of each and of the
    data mesh's step (``mesh``), which parts the synced BatchNorm's
    memory from the row blocks'."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast
    from pde_surrogate_torch.tools import dist_check as dc
    from pde_surrogate_torch.tools.glow_check import glow_model
    dev = m2.device
    sd = glow_model(64, DIST_GLOW["enc_blocks"], DIST_GLOW["flow_blocks"],
                    1e-3, "cpu").state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=4))[:, None]
    y = solve_darcy_batch_fast(x[:, 0].to(dev)).cpu()
    m64 = dc.glow_run(m2, sd, x, DIST_GLOW, 3, None, dev, torch.float64,
                      init_y=y)
    p64 = dc.glow_run(None, sd, x, DIST_GLOW, 3, None, dev, torch.float64,
                      init_y=y)
    loss_rel = _rel(m64["losses"], p64["losses"])
    init_err = max(float((v - p64["init"][k]).abs().max()
                         / p64["init"][k].abs().max())
                   for k, v in m64["init"].items()
                   if k.endswith(("norm.weight", "norm.bias")))
    state_err, state_key = max(
        (float((v - p64["state"][k]).abs().max()), k)
        for k, v in m64["state"].items()
        if not k.endswith("num_batches_tracked"))
    steps = {name: dc.glow_step(m, sd, x, DIST_GLOW, dev, init_y=y)[0]
             for name, m in (("plain", None), ("data", mesh), ("mesh", m2))}
    peaks = {name: _peak_mib(st) for name, st in steps.items()}
    del steps["data"]
    torch.cuda.empty_cache()
    ms_p, ms_m = _turns(steps["plain"], steps["mesh"], reps=3, warmup=1)
    log(f"[dpsp] (g) cglow enc [3,4,4] flow [6,6,6] 64^2 batch 32, ActNorm "
        f"data-init {init_err:.3e} of max (bound {dc.GLOW_LOSS_RTOL:g}); 3 "
        f"losses in float64 {loss_rel:.3e} relative (bound "
        f"{dc.GLOW_LOSS_RTOL:g}), parameters and buffers after them "
        f"{state_err:.3e} (bound {dc.CODEC_STATE_ATOL:g}; largest in "
        f"{state_key}); step f32: "
        f"plain {ms_p:.3f} ms, 1x1 mesh {ms_m:.3f} ms ({ms_m / ms_p:.2f}x); "
        f"peak plain {peaks['plain']:.1f} MiB, data mesh "
        f"{peaks['data']:.1f} MiB, 1x1 mesh {peaks['mesh']:.1f} MiB; {card}")
    check(loss_rel <= dc.GLOW_LOSS_RTOL and init_err <= dc.GLOW_LOSS_RTOL
          and state_err <= dc.CODEC_STATE_ATOL,
          "[dpsp] (g): the mesh cGlow's data init, losses or state differ "
          "from the plain one's")
    del steps
    torch.cuda.empty_cache()


def phase_dpsp(path: "MainPath") -> None:
    """[dpsp]: (a) the row-block arithmetic on the card, then (b) and (c)
    in a one-rank NCCL group (``_dpsp_checks``)."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    worst = 0.0
    for n_blocks in (2, 4):
        errs = dc.row_block_errors(dc.row_block_cases(full=True), n_blocks,
                                   "cuda", torch.float32, batch=32)
        for name, e in errs.items():
            grad_w = "-" if e["grad_w"] is None else f"{e['grad_w']:.3e}"
            f64 = [max(v for v in e[k].values() if v is not None)
                   for k in ("blocks_vs_f64", "whole_vs_f64")]
            log(f"[dpsp] (a) {n_blocks} blocks, {name}: halo {e['halo']}, "
                f"output {e['out']:.3e}, grad x {e['grad_x']:.3e}, grad w "
                f"{grad_w} of max|y|; from float64: blocks {f64[0]:.3e}, "
                f"whole field {f64[1]:.3e}")
            worst = max([worst, e["out"], e["grad_x"], e["grad_w"] or 0.0])
    log(f"[dpsp] (a) worst block-arithmetic error {worst:.3e} of max|y| "
        f"(bound {dc.ROW_BLOCK_RTOL_F32:g}); {gpu_name_power()}")
    check(worst <= dc.ROW_BLOCK_RTOL_F32,
          "[dpsp] (a): the row blocks differ from the whole field")
    torch.cuda.empty_cache()
    run(_dpsp_checks, 1, device="cuda", workdir=path.tmp)


def determinism_cases():
    """[determinism] (a)'s step kinds: (label, case, steps per run)."""
    from pde_surrogate_torch.tools import determinism_check as dc
    return [
        ("codec sobel", dc.codec_case("cuda", "sobel"), 3),
        ("codec fvcg n_cg=64", dc.codec_case("cuda", "fvcg", fvcg_iters=64),
         3),
        ("codec mle", dc.codec_case("cuda", "mle"), 3),
        ("cglow canonical reverse-KL", dc.glow_case("cuda"), 3),
        ("solve_fc Adam", dc.adam_case(lambda: fc_loss_fn(
            "cuda", torch.float32)), 3),
        ("solve_conv Adam", dc.adam_case(lambda: conv_solver_loss_fn(
            "cuda")), 3),
        ("solve_conv L-BFGS zoom epoch", dc.zoom_case(
            lambda: conv_solver_loss_fn("cuda")), 1),
    ]


@contextlib.contextmanager
def nondeterministic():
    """PyTorch's deterministic algorithms and cuDNN's deterministic flag
    off inside, restored after: only to time what determinism costs;
    nothing of the port runs under it."""
    mode = torch.are_deterministic_algorithms_enabled()
    cudnn = torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode)
        torch.backends.cudnn.deterministic = cudnn


def _under(mode, step):
    """``step`` with the context ``mode()`` entered around each call."""
    def run():
        with mode():
            return step()
    return run


def _in_modes(step, modes: dict, reps: int, warmup: int) -> dict:
    """``step`` under each of two modes (name -> context factory), timed
    in turns by ``_turns``: mean ms, peak memory (MiB), device busy time
    (ms) and device kernel time by name (us) under each."""
    runs = {m: _under(mode, step) for m, mode in modes.items()}
    out = {m: {"ms": ms} for m, ms in zip(
        modes, _turns(*runs.values(), reps, warmup))}
    for m, run in runs.items():
        out[m]["peak"] = _peak_mib(run)
        kernels: dict[str, float] = {}
        for e in profile_call(run)[1]:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        out[m]["kernels"] = kernels
        out[m]["busy"] = sum(kernels.values()) / 1e3
    return out


def _cost_line(label: str, what: str, names: tuple, r: dict,
               card: str) -> None:
    """One ``[determinism] cost`` line; above +10 % of step or busy time
    a ``kernels`` line with the kernels whose device time grew most."""
    a, b = (r[n] for n in names)
    log(f"[determinism] cost {label}: {what + ', ' if what else ''}"
        f"{names[0]} {a['ms']:.3f} ms/step, {names[1]} {b['ms']:.3f} "
        f"({(a['ms'] / b['ms'] - 1) * 100:+.1f} %, in turns); device busy "
        f"{a['busy']:.3f} / {b['busy']:.3f} ms "
        f"({(a['busy'] / b['busy'] - 1) * 100:+.1f} %); peak "
        f"{a['peak']:.1f} / {b['peak']:.1f} MiB; {card}")
    if a["ms"] > 1.1 * b["ms"] or a["busy"] > 1.1 * b["busy"]:
        ka, kb = a["kernels"], b["kernels"]
        grew = sorted(((ka.get(k, 0.0) - kb.get(k, 0.0), k)
                       for k in ka.keys() | kb.keys()), reverse=True)
        log(f"[determinism] kernels {label} ({names[0]} / {names[1]}), grew "
            f"most: " + "; ".join(
                f"{k[:90]} {kb.get(k, 0.0):.0f} -> {ka.get(k, 0.0):.0f} us"
                for _, k in grew[:5]))


def _filling(select):
    """``select_device`` that leaves fresh memory filled with NaN, so the
    CLIs' runs in the check would show a read of memory no kernel wrote."""
    def select_and_fill(*a, **kw):
        device = select(*a, **kw)
        torch.utils.deterministic.fill_uninitialized_memory = True
        return device
    return select_and_fill


def phase_determinism(tmp: str) -> None:
    """[determinism], with cuDNN / cuBLAS / PyTorch as ``select_device``
    sets them, and in (a)-(c) every fresh allocation filled with NaN
    (``torch.utils.deterministic.fill_uninitialized_memory``, which the
    entry points leave off), so a read of memory no kernel wrote shows:
    (a) each training step kind at full width run twice from the same
    weights, batches and generator: every loss, parameter, BatchNorm
    buffer and Adam moment ``torch.equal``;
    (b) the codec CLI (``MainPath.WIDTH``, 512 / 128 fields) 3 epochs
    twice and 1 epoch stopped and resumed to 3 (``--ckpt-epoch 1``), the
    cGlow CLI (reference width, --data-init) 2 epochs twice and resumed
    at 1: every tensor of the last checkpoint and its logged losses, R^2
    and consistency equal;
    (c) K1 twice on the same K at 64^2 (B=64) and 128^2 (the cluster
    path): bitwise equal;
    (d) what determinism costs, as the entry points run (no NaN fill):
    each step kind of (a) with deterministic algorithms on and off in
    turns, its CUDA-event time, device busy time and peak memory; then
    the Sobel step with the NaN fill on and off."""
    from unittest import mock

    from pde_surrogate_torch.cli import _codec_common
    from pde_surrogate_torch.cli import train_cglow_reverse_kl as glow_cli
    from pde_surrogate_torch.cli import train_codec_mixed_residual as train
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.kernels.cg_darcy import solve_darcy_cg
    from pde_surrogate_torch.tools import determinism_check as dc
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = True
    card = gpu_name_power()
    log(f"[determinism] deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()}, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, CUBLAS_WORKSPACE_CONFIG "
        f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}, NaN fill of fresh "
        f"memory at the entry points {fill}")
    check(torch.are_deterministic_algorithms_enabled()
          and not torch.backends.cudnn.benchmark
          and os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8",
          "[determinism] select_device did not set the port's numerics")
    cases = determinism_cases()
    for label, make, n in cases:
        tic = time.perf_counter()
        diff = dc.repeat(make, n)
        log(f"[determinism] (a) {label}: {n} step(s) twice, "
            f"{'bitwise equal' if not diff else f'{len(diff)} differ'} "
            f"({time.perf_counter() - tic:.2f} s){'' if not diff else ': '}"
            f"{', '.join(diff[:8])}")
        check(not diff, f"[determinism] (a) {label} does not repeat")
        torch.cuda.empty_cache()

    quiet = io.StringIO()
    for label, module, argv, epochs, kw in (
            ("codec CLI", train, MainPath.WIDTH + [
                "--data-dir", os.path.join(tmp, "data2")], 3,
             dict(saver=_codec_common)),
            ("cglow CLI", glow_cli, [
                "--imsize", "64", "--kle", "512", "--ntrain", "512",
                "--ntest", "128", "--batch-size", "32", "--test-batch-size",
                "64", "--ckpt-freq", "1", "--no-plot", "--device", "cuda",
                "--data-init", "--data-dir", os.path.join(tmp, "data4")], 2,
             {})):
        tic = time.perf_counter()
        select = _filling(_codec_common.select_device)
        with contextlib.redirect_stdout(quiet), \
                mock.patch.object(_codec_common, "select_device", select), \
                mock.patch.object(glow_cli, "select_device", select):
            diff = dc.cli_repeat(module, argv, os.path.join(
                tmp, f"determinism_{label.split()[0]}"), epochs, 1, **kw)
        log(f"[determinism] (b) {label}: {epochs} epochs twice and 1 + "
            f"{epochs - 1} resumed, the last checkpoint's tensors and "
            f"logged metrics: second run {diff['second'] or 'equal'}, "
            f"resumed {diff['resumed'] or 'equal'} "
            f"({time.perf_counter() - tic:.2f} s)")
        check(not diff["second"] and not diff["resumed"],
              f"[determinism] (b) the {label} does not repeat")

    for n, bsz in ((64, 64), (128, 64)):
        K = torch.from_numpy(sample_kle(bsz, n, 512, rng=n + 1)).cuda()
        u1 = solve_darcy_cg(K, 24 * n)
        u2 = solve_darcy_cg(K, 24 * n)
        same = torch.equal(u1, u2)
        log(f"[determinism] (c) K1 n={n} B={bsz}: two launches "
            f"{'bitwise equal' if same else 'differ'}")
        check(same and bool(torch.isfinite(u1).all()),
              f"[determinism] (c) K1 at {n}^2 does not repeat")

    torch.utils.deterministic.fill_uninitialized_memory = fill
    modes = {"deterministic": contextlib.nullcontext,
             "not": nondeterministic}
    for label, make, n in cases:
        step, _ = make()
        zoom = "zoom" in label
        r = _in_modes(step, modes, reps=2 if zoom else 10,
                      warmup=1 if zoom else 3)
        _cost_line(label, "", ("deterministic", "not"), r, card)
        del step
        torch.cuda.empty_cache()

    def filled(on):
        @contextlib.contextmanager
        def ctx():
            torch.utils.deterministic.fill_uninitialized_memory = on
            try:
                yield
            finally:
                torch.utils.deterministic.fill_uninitialized_memory = fill
        return ctx
    step, _ = cases[0][1]()
    r = _in_modes(step, {"on": filled(True), "off": filled(False)}, 10, 3)
    _cost_line("codec sobel", "NaN fill of fresh memory", ("on", "off"), r,
               card)
    check(torch.utils.deterministic.fill_uninitialized_memory == fill,
          "[determinism] the NaN fill was not restored")


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
    phase_fvcg_parity()
    phase_fc_parity()
    phase_nonlinear()
    phase_glow_parity()
    phase_codec_variants()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = MainPath(tmp)
        path.run()
        phase_tpu_precision(path)
        phase_step_times()
        phase_solver_step_times()
        phase_glow_step_times()
        phase_glow_canonical_step()
        phase_step_profile()
        phase_dist(path)
        phase_dpsp(path)
        phase_determinism(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = sum(path.launches.values())
    log(f"[main] K1 launches over every path: {launches}")

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

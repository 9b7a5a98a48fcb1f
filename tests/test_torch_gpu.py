"""Kernel tests that need a CUDA device (marker ``gpu``; they skip without
one).  This file imports torch and the port only, so it also runs on a
machine without the JAX package:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import _codec_common
from pde_surrogate_torch.cli import train_codec_mixed_residual as t_train
from pde_surrogate_torch.data.grf import sample_channelized, sample_kle
from pde_surrogate_torch.ops.kernels.cg_darcy import (solve_darcy_cg,
                                                      solve_darcy_cg_plain)
from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast
from pde_surrogate_torch.tools import determinism_check as dc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card with the port's numerics, as every entry point sets them:
    TF32 off (torch's default runs cuDNN convolutions in TF32, ~1e-3
    relative), deterministic algorithms on and cuBLAS's workspace fixed,
    before the first CUDA op of the process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pde_surrogate_torch.utils.config import select_device
    return select_device("cuda")


@pytest.mark.parametrize("n,family,batch", [
    (16, "kle", 5), (33, "channelized", 5), (64, "channelized", 5),
    (64, "kle", 64), (64, "channelized", 132), (128, "kle", 5),
    (128, "channelized", 64), (200, "kle", 3), (256, "channelized", 3)])
def test_cg_kernel_matches_twin(cuda, n, family, batch):
    """atol 5e-5 against the f32 twin: the sums run in another order and
    the kernel contracts multiply-adds.  64^2 at B=64 is the main path's
    shape and B=132 a full wave of one CTA per SM; 128^2 and up run as
    clusters of 4 and 16 CTAs per field."""
    K = (sample_kle(batch, n, 64, rng=n) if family == "kle"
         else sample_channelized(batch, n, rng=n))
    K = torch.from_numpy(np.ascontiguousarray(K)).to(cuda)
    before = solve_darcy_cg.launches
    u = solve_darcy_cg(K, 24 * n)
    torch.cuda.synchronize()
    assert solve_darcy_cg.launches == before + 1
    torch.testing.assert_close(u, solve_darcy_cg_plain(K, 24 * n), atol=5e-5,
                               rtol=0)


def test_labels_on_gpu_match_cpu(cuda):
    K = torch.from_numpy(sample_kle(3, 32, 64, rng=1))
    on_gpu = solve_darcy_batch_fast(K.to(cuda)).cpu()
    on_cpu = solve_darcy_batch_fast(K)
    torch.testing.assert_close(on_gpu[:, 0], on_cpu[:, 0], atol=5e-5, rtol=0)
    flux_atol = 5e-5 * 2 * 31 * float(K.max())
    torch.testing.assert_close(on_gpu[:, 1:], on_cpu[:, 1:], atol=flux_atol,
                               rtol=0)


def test_cg_kernel_rejects_what_it_cannot_take(cuda):
    K = torch.ones(2, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        solve_darcy_cg(K.double(), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(K.transpose(1, 2), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(torch.ones(1, 257, 257, device=cuda), 10)
    with pytest.raises(ValueError):
        solve_darcy_cg(torch.ones(2, 16, 8, device=cuda), 10)


def test_batchnorm_running_var_is_biased_on_gpu(cuda):
    from pde_surrogate_torch.models.codec import BatchNorm2d
    bn = BatchNorm2d(8).to(cuda).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        1, 3, (2, 8, 4, 4)).astype(np.float32)).to(cuda)
    bn(x)
    want = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["fv", "fvcg", "sobel_fvcg"])
def test_fvcg_losses_on_gpu_match_cpu(cuda, name):
    """The FV objectives and the in-loss PCG (64 iterations) at 64^2, B=4,
    on the card against the CPU: loss 1e-5 relative; the gradient with
    respect to the output within 1e-5 * max|g| of the CPU's, or within
    three times the CPU f32 gradient's own distance from float64, whichever
    is larger (the CG's reverse mode amplifies f32 rounding)."""
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.codec_trainer import _physics_loss
    n = 64
    K = torch.from_numpy(sample_kle(4, n, 512, rng=5))[:, None]
    out = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (4, 3, n, n)).astype(np.float32))
    fns = {"fv": lambda k, o: td.fv_mixed_residual_loss(k, o)[0],
           "fvcg": lambda k, o: td.fv_cg_error_loss(k, o, 10.0, 64)[0],
           "sobel_fvcg": lambda k, o: _physics_loss(
               "sobel_fvcg", k, o, SobelFilter(n), 10.0, None, 100.0, 1.0,
               64)[0]}

    def run(device, dtype=torch.float32):
        o = out.to(device, dtype).detach().requires_grad_(True)
        loss = fns[name](K.to(device, dtype), o)
        loss.backward()
        return float(loss), o.grad.double().cpu()

    l_gpu, g_gpu = run(cuda)
    l_cpu, g_cpu = run("cpu")
    _, g64 = run("cpu", torch.float64)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    bound = max(1e-5 * float(g_cpu.abs().max()),
                3 * float((g_cpu - g64).abs().max()))
    assert float((g_gpu - g_cpu).abs().max()) <= bound


def _fc_loss_and_grad(device, dtype):
    """The FC solver's loss (mixed residual, Dirichlet and Neumann terms)
    of a CPPN 2-64x4-3 on 256 points, and its parameter gradient."""
    from pde_surrogate_torch.models.cppn import CPPN
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.train.lbfgs import FlatParams, value_and_grad
    torch.manual_seed(0)
    model = CPPN(2, 3, 64, 4).to(device, dtype)
    flat = FlatParams(model)
    rng = np.random.default_rng(0)
    x, b = (torch.from_numpy(rng.random((n, 2))).to(device, dtype)
            for n in (256, 32))
    K = torch.from_numpy(np.exp(rng.normal(0, 1, (256, 1)))).to(device, dtype)

    def loss(v):
        net = (model, flat.unflatten(v))
        return (td.mixed_residual_fc(net, x, K)
                + 10.0 * td.neumann_boundary_mixed(net, b))

    value, grad = value_and_grad(loss, flat.vector())
    return float(value), grad.double().cpu()


def test_fc_loss_and_gradient_on_gpu_match_cpu(cuda):
    """Loss within 1e-5 relative; the parameter gradient (through the
    per-point Jacobians) within 1e-5 * max|g| of the CPU's, or three times
    the CPU float32 gradient's own distance from float64."""
    l_gpu, g_gpu = _fc_loss_and_grad(cuda, torch.float32)
    l_cpu, g_cpu = _fc_loss_and_grad("cpu", torch.float32)
    _, g64 = _fc_loss_and_grad("cpu", torch.float64)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    bound = max(1e-5 * float(g_cpu.abs().max()),
                3 * float((g_cpu - g64).abs().max()))
    assert float((g_gpu - g_cpu).abs().max()) <= bound


def test_nonlinear_solve_on_gpu_matches_cpu(cuda):
    """The FV-Newton oracle at 32^2 on the card against the CPU: within
    1e-5 of max|x|, or three times the CPU float32 result's own distance
    from float64."""
    from pde_surrogate_torch.solvers.fd_darcy import solve_nonlinear_darcy
    K = torch.from_numpy(sample_kle(1, 32, 64, rng=3)[0])
    on_gpu = solve_nonlinear_darcy(K.to(cuda)).cpu().double()
    on_cpu = solve_nonlinear_darcy(K).double()
    own = float((on_cpu - solve_nonlinear_darcy(K.double())).abs().max())
    bound = max(1e-5 * float(on_cpu.abs().max()), 3 * own)
    assert float((on_gpu - on_cpu).abs().max()) <= bound
    torch.testing.assert_close(on_gpu[0, :, 0], torch.ones(32,
                               dtype=torch.float64), atol=1e-6, rtol=0)


def test_zoom_lbfgs_epoch_on_gpu_matches_cpu(cuda):
    """One zoom L-BFGS epoch (20 steps) of the FC loss in float64: the
    iterate, the loss and the loss evaluations of the card equal the
    CPU's (1e-8 of max|x|)."""
    from pde_surrogate_torch.models.cppn import CPPN
    from pde_surrogate_torch.ops import darcy as td
    from pde_surrogate_torch.train.lbfgs import (FlatParams, lbfgs_optimizer,
                                                 make_lbfgs_epoch)

    def run(device):
        torch.manual_seed(0)
        model = CPPN(2, 3, 16, 3).to(device, torch.float64)
        flat = FlatParams(model)
        x = torch.from_numpy(np.random.default_rng(1).random((64, 2))).to(
            device)
        K = torch.ones(64, 1, dtype=torch.float64, device=device)
        opt = lbfgs_optimizer(learning_rate=None)
        params = flat.vector()
        epoch = make_lbfgs_epoch(
            lambda v: td.mixed_residual_fc((model, flat.unflatten(v)), x, K),
            opt)
        params, state, loss = epoch(params, opt.init(params))
        return params.cpu(), float(loss), state.evals

    p_gpu, l_gpu, e_gpu = run(cuda)
    p_cpu, l_cpu, e_cpu = run("cpu")
    assert e_gpu == e_cpu
    assert float((p_gpu - p_cpu).abs().max()) <= 1e-8 * float(
        p_cpu.abs().max())
    assert abs(l_gpu - l_cpu) <= 1e-8 * abs(l_cpu)


GLOW_SMALL = dict(imsize=32, enc_blocks=[2, 2, 2], flow_blocks=[2, 2, 2])


def test_glow_on_gpu_matches_cpu(cuda):
    """A 32^2 cGlow (enc/flow blocks [2,2,2]) with its heads at 1e-3, held
    as chip_smoke.py's ``[glow]`` holds the full width
    (``tools/glow_check.card_vs_cpu``): log p and the losses within 1e-5
    relative; generate's output and the parameter gradients within 1e-5 of
    their largest magnitude, or three times the CPU float32 result's own
    distance from float64."""
    from pde_surrogate_torch.tools.glow_check import card_vs_cpu, glow_outputs
    on_gpu = glow_outputs(cuda, torch.float32, head_scale=1e-3, **GLOW_SMALL)
    on_cpu = glow_outputs("cpu", torch.float32, head_scale=1e-3, **GLOW_SMALL)
    f64 = glow_outputs("cpu", torch.float64, head_scale=1e-3, **GLOW_SMALL)
    for name, err, bound, _ in card_vs_cpu(on_gpu, on_cpu, f64):
        assert torch.isfinite(on_gpu[name]).all(), name
        assert err <= bound, (name, err, bound)


def test_glow_ill_conditioned_on_gpu_near_float64(cuda):
    """The same cGlow with its heads at 1e-2, where trained heads may go and
    where cuDNN's float32 gradients lie ~100x farther from the CPU's than
    the CPU's from float64: every output within 2e-4 of its largest
    float64 magnitude (``tools/glow_check.card_vs_float64``)."""
    from pde_surrogate_torch.tools.glow_check import (card_vs_float64,
                                                      glow_outputs)
    on_gpu = glow_outputs(cuda, torch.float32, head_scale=1e-2, **GLOW_SMALL)
    f64 = glow_outputs("cpu", torch.float64, head_scale=1e-2, **GLOW_SMALL)
    for name, err, bound in card_vs_float64(on_gpu, f64):
        assert torch.isfinite(on_gpu[name]).all(), name
        assert err <= bound, (name, err, bound)


def test_codec_options_on_gpu_match_plain(cuda):
    """concat_free, remat and bf16 on the card against the plain f32 model
    on the card, DenseED [2,3,2]/4/8 at 32^2, B=4, by the rules of
    ``tools/codec_check`` (the CPU tests' bounds, or the card's own float32
    error for concat-free and the CPU's own bf16 error for bf16, where
    larger), and bf16 really computing its convolutions in bf16."""
    from pde_surrogate_torch.tools.codec_check import run_variant_checks
    rows, steps = run_variant_checks(cuda, imsize=32, blocks=[2, 3, 2],
                                     growth=4, init=8, batch=4)
    for name, err, bound, _ in rows:
        assert err <= bound, f"{name}: {err} > {bound}"
    assert steps["bf16"]["conv_dtype"] == torch.bfloat16


DP_KW = dict(in_channels=1, out_channels=3, imsize=32, blocks=[2, 3, 2],
             growth_rate=8, init_features=16)


def _dp_inputs():
    from pde_surrogate_torch.models.codec import DenseED
    torch.manual_seed(0)
    return (DenseED(**DP_KW).state_dict(),
            torch.from_numpy(sample_kle(8, 32, 32, rng=0))[:, None])


def _assert_dp_equal(got, want):
    """``tools/dist_check``'s rules on three float64 steps."""
    from pde_surrogate_torch.tools import dist_check as dc
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(),
                               rtol=dc.CODEC_LOSS_RTOL)
    for k, v in want["state"].items():
        torch.testing.assert_close(got["state"][k], v, rtol=0,
                                   atol=dc.CODEC_STATE_ATOL, msg=k)


def test_dp_codec_steps_on_one_nccl_rank_match_plain(cuda, tmp_path):
    """Three DenseED steps on a one-rank NCCL group (BatchNorm moments and
    gradients all-reduced) against three plain steps on the card."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    sd, x = _dp_inputs()
    got = run(dc.codec_run, 1, sd, x, DP_KW, 3, "cuda", torch.float64,
              device="cuda", workdir=str(tmp_path))
    _assert_dp_equal(got, dc.codec_run(None, sd, x, DP_KW, 3, "cuda",
                                       torch.float64))


def test_dp_codec_steps_on_two_gpus_match_plain(cuda, tmp_path):
    """The same on two NCCL ranks, one GPU each (both replicas equal)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: ranks never share one")
    from pde_surrogate_torch.parallel.launch import spawn
    from pde_surrogate_torch.tools import dist_check as dc
    sd, x = _dp_inputs()
    ranks = spawn(dc.codec_run, 2, sd, x, DP_KW, 3, "cuda", torch.float64,
                  device="cuda", workdir=str(tmp_path))
    _assert_dp_equal(ranks[0], dc.codec_run(None, sd, x, DP_KW, 3, "cuda",
                                            torch.float64))
    _assert_dp_equal(ranks[1], ranks[0])


def test_spatial_solve_on_one_nccl_rank_matches_k1(cuda, tmp_path):
    """The row-sharded solve on one NCCL rank against K1, by K1's own rule
    against its plain twin (5e-5)."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    K = torch.from_numpy(sample_kle(4, 32, 64, rng=2))
    (u,), = run(dc.spatial_runs, 1, [(K, [24 * 32])], device="cuda",
                workdir=str(tmp_path))
    torch.testing.assert_close(u, solve_darcy_cg(K.to(cuda), 24 * 32).cpu(),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_row_blocks_on_gpu_match_the_whole_field(cuda, n_blocks):
    """The data x space mesh's block arithmetic at DenseED [6,8,6]/16/48's
    widths on 64^2, batch 32, in float32: every conv kind, the
    upsampling before a conv and the Sobel stencils, forward and backward,
    within 1e-5 of the whole field's cuDNN / matmul result's largest
    value (``tools/dist_check.row_block_errors``)."""
    from pde_surrogate_torch.tools import dist_check as dc
    errs = dc.row_block_errors(dc.row_block_cases(full=True), n_blocks,
                               cuda, torch.float32, batch=32)
    for name, e in errs.items():
        for k in ("out", "grad_x", "grad_w"):
            if e[k] is not None:
                assert e[k] <= dc.ROW_BLOCK_RTOL_F32, (name, k, e)


def test_dpsp_codec_steps_on_one_nccl_rank_match_plain(cuda, tmp_path):
    """Three DenseED steps on a 1x1 data x space mesh of one NCCL rank
    (the row-block convs, their halos at both walls, the partial loss)
    against three plain steps on the card, in float64."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    sd, x = _dp_inputs()
    got = run(dc.codec_dpsp_run, 1, (1, 1), sd, x, DP_KW, 3, "cuda",
              torch.float64, device="cuda", workdir=str(tmp_path))
    _assert_dp_equal(got, dc.codec_run(None, sd, x, DP_KW, 3, "cuda",
                                       torch.float64))


def test_dpsp_codec_steps_on_two_gpus_match_plain(cuda, tmp_path):
    """The same on a 1x2 mesh, one GPU per space rank: the halos cross
    between the cards (both replicas equal)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: ranks never share one")
    from pde_surrogate_torch.parallel.launch import spawn
    from pde_surrogate_torch.tools import dist_check as dc
    sd, x = _dp_inputs()
    ranks = spawn(dc.codec_dpsp_run, 2, (1, 2), sd, x, DP_KW, 3, "cuda",
                  torch.float64, device="cuda", workdir=str(tmp_path))
    _assert_dp_equal(ranks[0], dc.codec_run(None, sd, x, DP_KW, 3, "cuda",
                                            torch.float64))
    _assert_dp_equal(ranks[1], ranks[0])


@pytest.mark.parametrize("objective", ["fv", "fvcg", "sobel_fvcg", "mle"])
def test_dpsp_objectives_on_one_nccl_rank_match_plain(cuda, tmp_path,
                                                      objective):
    """Three DenseED steps of each finite-volume objective (16 CG
    iterations) and of the supervised step on a 1x1 data x space mesh of
    one NCCL rank (the row-block FV terms, the in-loss PCG's halo rows and
    space all-reduces) against three plain steps on the card, in
    float64."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    sd, x = _dp_inputs()
    y = solve_darcy_batch_fast(x[:, 0].to(cuda)).cpu()
    kw = {"physics": objective, "y": y, "n_cg": 16}
    got, = run(dc.calls, 1, [(dc.codec_dpsp_run, ((1, 1), sd, x, DP_KW, 3,
                                                  "cuda", torch.float64),
                              kw)], device="cuda", workdir=str(tmp_path))
    _assert_dp_equal(got, dc.codec_run(None, sd, x, DP_KW, 3, "cuda",
                                       torch.float64, **kw))


def test_dpsp_glow_steps_on_one_nccl_rank_match_plain(cuda, tmp_path):
    """The cGlow (enc and flow [2, 2, 2], 32^2, heads at 1e-3) on a 1x1
    data x space mesh of one NCCL rank: ActNorm data-init over the group
    (within 2e-5 of each parameter's largest value), then three
    reverse-KL steps in float64, the losses within 2e-5 relative and the
    parameters and buffers within 2e-5 of the plain steps on the card
    (the bounds of ``tools/dist_check``)."""
    from pde_surrogate_torch.parallel.launch import run
    from pde_surrogate_torch.tools import dist_check as dc
    from pde_surrogate_torch.tools.glow_check import glow_model
    kw = dict(img_size=32, x_channels=1, y_channels=3, enc_blocks=[2, 2, 2],
              flow_blocks=[2, 2, 2])
    sd = glow_model(32, [2, 2, 2], [2, 2, 2], 1e-3, "cpu").state_dict()
    x = torch.from_numpy(sample_kle(8, 32, 64, rng=6))[:, None]
    y = solve_darcy_batch_fast(x[:, 0].to(cuda)).cpu()
    got, = run(dc.calls, 1, [(dc.glow_dpsp_run, ((1, 1), sd, x, kw, 3, None,
                                                 "cuda", torch.float64),
                              {"init_y": y})],
               device="cuda", workdir=str(tmp_path))
    want = dc.glow_run(None, sd, x, kw, 3, None, "cuda", torch.float64,
                       init_y=y)
    for k, v in want["init"].items():
        torch.testing.assert_close(
            got["init"][k], v, rtol=0,
            atol=dc.GLOW_LOSS_RTOL * max(float(v.abs().max()), 1.0), msg=k)
    np.testing.assert_allclose(got["losses"].numpy(), want["losses"].numpy(),
                               rtol=dc.GLOW_LOSS_RTOL)
    for k, v in want["state"].items():
        torch.testing.assert_close(got["state"][k], v, rtol=0,
                                   atol=dc.CODEC_STATE_ATOL, msg=k)


@pytest.mark.parametrize("kind", ["sobel", "fvcg", "mle"])
def test_determinism_codec_steps_repeat(cuda, kind):
    """Three DenseED [6,8,6]/16/48 steps at 64^2, batch 32, twice from the
    same seeds: every loss, parameter, BatchNorm buffer and Adam moment
    bitwise equal (``chip_smoke.py`` ``[determinism] (a)``)."""
    case = dc.codec_case(cuda, kind,
                         fvcg_iters=64 if kind == "fvcg" else None)
    assert dc.repeat(case) == []


def test_determinism_glow_steps_repeat(cuda):
    """Three reverse-KL steps of the canonical cGlow (enc [3,3,3,3], flow
    [4,4,4,4], 64^2, batch 32) twice: bitwise equal."""
    assert dc.repeat(dc.glow_case(cuda)) == []


def test_determinism_codec_cli_resume_is_exact(cuda, tmp_path):
    """The codec CLI at 32^2 (K1 labels the val split), 3 epochs twice and
    stopped after epoch 1 and resumed: the last checkpoint's every tensor
    and the logged losses, R^2 and consistency equal."""
    argv = ["--imsize", "32", "--blocks", "3,4,3", "--growth-rate", "8",
            "--init-features", "16", "--ntrain", "64", "--ntest", "32",
            "--batch-size", "16", "--test-batch-size", "32", "--ckpt-freq",
            "1", "--no-plot", "--device", "cuda", "--data-dir",
            str(tmp_path / "d")]
    assert dc.cli_repeat(t_train, argv, str(tmp_path), 3, 1,
                         saver=_codec_common) == {"second": [],
                                                  "resumed": []}


@pytest.mark.parametrize("n", [64, 128])
def test_determinism_k1_launches_repeat(cuda, n):
    """K1 twice on the same K (64^2 in one CTA a field, 128^2 in a
    cluster): bitwise equal, its sums in a fixed order."""
    K = torch.from_numpy(sample_kle(64, n, 512, rng=n)).to(cuda)
    assert torch.equal(solve_darcy_cg(K, 24 * n), solve_darcy_cg(K, 24 * n))


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_determinism_cublas_config_must_precede_cuda(cuda):
    """CUBLAS_WORKSPACE_CONFIG takes effect only if set before the first
    CUDA op, and torch does not check the order (torch 2.11 runs a GEMM
    under deterministic algorithms without the variable): a process that
    calls select_device after a CUDA op is refused; one that calls it
    first runs a GEMM with the variable set and deterministic algorithms
    on."""
    refused = _python("import torch; torch.ones(1, device='cuda'); from "
                      "pde_surrogate_torch.utils.config import select_device"
                      "; select_device('cuda')")
    assert refused.returncode != 0
    assert "CUBLAS_WORKSPACE_CONFIG" in refused.stderr
    first = _python("from pde_surrogate_torch.utils.config import "
                    "select_device; select_device('cuda'); import os, torch; "
                    "print(os.environ['CUBLAS_WORKSPACE_CONFIG'], "
                    "torch.are_deterministic_algorithms_enabled()); "
                    "a = torch.randn(256, 256, device='cuda'); "
                    "print(bool(torch.isfinite(a @ a).all()))")
    assert first.stdout.split() == [":4096:8", "True", "True"], first.stderr

"""The port repeats bit for bit from a seed, as the JAX package does.

* ``select_device`` (every entry point's) turns PyTorch's deterministic
  algorithms on and fixes cuBLAS's workspace (``CUBLAS_WORKSPACE_CONFIG``),
  and refuses when CUDA started before the variable was set: cuBLAS reads
  it only when the process makes its first handle.
* Three reverse-KL steps of the cGlow, and three Sobel steps of the
  DenseED, run twice from the same seeds: every loss, parameter, buffer
  and Adam moment ``torch.equal`` (the port's counterpart of
  ``tests/test_glow_training.py::test_reverse_kl_deterministic``).
* The codec and cGlow CLIs run twice, and stopped after epoch 1 and
  resumed: every tensor of the last checkpoint and its logged metrics
  equal (``tools/determinism_check.cli_repeat``, which ``chip_smoke.py``
  runs at full width on the card).
* The ops that were given a deterministic formulation, against the JAX
  package: the running sum of ``reconstruct_pressure`` (a triangular
  product in place of ``torch.cumsum``) within 1e-6 of the output's
  largest value, as ``tests/test_torch_filters_darcy.py`` holds it; the
  bilinear upsampling (the axes' interpolation matrices in place of
  ``F.interpolate``) and its gradient within 1e-6 of their largest
  value (f32 products of two nonzero terms a row).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import _codec_common
from pde_surrogate_torch.cli import train_cglow_reverse_kl as t_glow
from pde_surrogate_torch.cli import train_codec_mixed_residual as t_train
from pde_surrogate_torch.models.codec import upsample_bilinear as t_bilinear
from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.tools import determinism_check as dc
from pde_surrogate_torch.utils.config import select_device
from pde_surrogate_tpu.models.codec import upsample_bilinear as j_bilinear
from pde_surrogate_tpu.ops import darcy as jd

torch.set_num_threads(1)


def test_select_device_sets_determinism(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert select_device("cpu") == torch.device("cpu")
    assert torch.are_deterministic_algorithms_enabled()
    assert not torch.utils.deterministic.fill_uninitialized_memory
    assert not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_select_device_refuses_cuda_started_without_cublas_config(
        monkeypatch):
    """The variable set after the first CUDA op would pass torch's own
    check and change nothing; select_device raises instead, also when
    CUDA started under another workspace size.  Set to the port's one
    before, it goes on."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        select_device("cpu")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with pytest.raises(RuntimeError, match=":4096:8"):
        select_device("cpu")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    assert select_device("cpu") == torch.device("cpu")


def test_reverse_kl_deterministic():
    """Same seed + same steps = bitwise identical parameters, BatchNorm
    and ActNorm buffers, Adam moments and losses (3 steps, enc [2,2]
    flow [2,2] at 16^2, batch 4)."""
    select_device("cpu")
    case = dc.glow_case("cpu", enc=(2, 2), flow=(2, 2), imsize=16, batch=4)
    a, b = dc.run_case(case), dc.run_case(case)
    assert dc.differences(a, b) == []
    params = [k for k in a if k.startswith("param.")]
    assert len(params) > 10 and any(k.startswith("optim.") for k in a)
    assert a["step2.loss"].isfinite()


@pytest.mark.parametrize("kind", ["sobel", "mle"])
def test_codec_steps_deterministic(kind):
    """Three DenseED [1,2,1]/4/8 steps at 16^2, batch 4, twice: every
    loss, parameter, BatchNorm buffer and Adam moment bitwise equal, and
    the steps moved the weights."""
    select_device("cpu")
    case = dc.codec_case("cpu", kind, imsize=16, blocks=(1, 2, 1),
                         growth_rate=4, init_features=8, batch=4)
    assert dc.repeat(case) == []
    step, record = case()
    before = record()
    step()
    assert dc.differences(before, record())


def _tiny_data(tmp_path):
    return ["--data-dir", str(tmp_path / "d")]


def test_codec_cli_repeats_and_resumes(tmp_path):
    """The codec CLI, 3 epochs twice and 1 + 2 resumed: the epoch-3
    checkpoints' every tensor (model, Adam, step) and the logged losses,
    R^2 and consistency equal."""
    argv = ["--imsize", "16", "--blocks", "1,2,1", "--growth-rate", "4",
            "--init-features", "8", "--no-plot", "--device", "cpu",
            "--ntrain", "32", "--ntest", "16", "--batch-size", "16",
            "--test-batch-size", "16", "--ckpt-freq", "1",
            *_tiny_data(tmp_path)]
    assert dc.cli_repeat(t_train, argv, str(tmp_path), 3, 1,
                         saver=_codec_common) == {"second": [],
                                                  "resumed": []}


def test_cglow_cli_repeats_and_resumes(tmp_path):
    argv = ["--imsize", "16", "--kle", "512", "--enc-blocks", "2,2",
            "--flow-blocks", "2,2", "--ntrain", "16", "--ntest", "8",
            "--batch-size", "8", "--test-batch-size", "8", "--ckpt-freq",
            "1", "--no-plot", "--device", "cpu", *_tiny_data(tmp_path)]
    assert dc.cli_repeat(t_glow, argv, str(tmp_path), 2, 1) == {
        "second": [], "resumed": []}


def test_differences_sees_one_ulp():
    """The comparison is not vacuous: one element one ulp apart, another
    dtype, another shape or a missing entry are each named."""
    a = {"w": torch.ones(3), "v": torch.zeros(2), "s": torch.tensor(1.0),
         "m": torch.ones(2, 2)}
    b = {k: v.clone() for k, v in a.items()}
    assert dc.differences(a, b) == []
    b["w"][1] = torch.nextafter(torch.tensor(1.0), torch.tensor(2.0))
    b["v"] = b["v"].double()
    b["m"] = b["m"].reshape(4)
    del b["s"]
    assert dc.differences(a, b) == ["m", "s", "v", "w"]


@pytest.mark.parametrize("n", [16, 17, 32])
def test_reconstruct_pressure_matches_jax(n):
    rng = np.random.default_rng(n)
    K = np.exp(rng.normal(0, 1, (3, 1, n, n))).astype(np.float32)
    out = rng.normal(0, 1, (3, 3, n, n)).astype(np.float32)
    ours = td.reconstruct_pressure(torch.from_numpy(K),
                                   torch.from_numpy(out)).numpy()
    ref = np.asarray(jd.reconstruct_pressure(
        jnp.asarray(np.moveaxis(K, 1, -1)), jnp.asarray(np.moveaxis(out, 1,
                                                                    -1))))
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (2, 5, 4, 16), (1, 2, 1, 3)])
def test_upsample_bilinear_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, shape).astype(np.float32)
    g = rng.normal(0, 1, shape[:2] + (2 * shape[2], 2 * shape[3])).astype(
        np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t_bilinear(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    yj, vjp = jax.vjp(j_bilinear, xj)
    (gj,) = vjp(jnp.asarray(np.moveaxis(g, 1, -1)))
    for ours, ref in ((yt.detach().numpy(), yj), (gt.numpy(), gj)):
        ref = np.moveaxis(np.asarray(ref), -1, 1)
        assert ours.shape == ref.shape
        assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (2, 5, 4, 16), (1, 2, 1, 3)])
def test_upsample_bilinear_bf16_matches_jax(shape):
    """A bf16 input: the JAX package's f32 matrices promote it and return
    f32; the port's products run in f32 too and round once to bf16.  Its
    output is within half a bf16 ulp of JAX's (2^-8 of each value, plus
    1e-6 of the largest for f32's own sums), and its gradient, from a
    bf16 cotangent, within one bf16 ulp of JAX's (2^-7 of each value):
    both round the same f32 sums.  Matrices rounded to bf16 miss these
    bounds some 15-150 times."""
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                          ).bfloat16()
    gb = torch.from_numpy(rng.normal(0, 1, shape[:2] + (
        2 * shape[2], 2 * shape[3])).astype(np.float32)).bfloat16()
    xt = xb.clone().requires_grad_(True)
    yt = t_bilinear(xt)
    (gt,) = torch.autograd.grad(yt, xt, gb)
    assert yt.dtype == gt.dtype == torch.bfloat16
    xj = jnp.asarray(np.moveaxis(xb.float().numpy(), 1, -1), jnp.bfloat16)
    yj, vjp = jax.vjp(j_bilinear, xj)
    (gj,) = vjp(jnp.asarray(np.moveaxis(gb.float().numpy(), 1, -1),
                            yj.dtype))
    for ours, ref, ulps in ((yt, yj, 2.0 ** -8), (gt, gj, 2.0 ** -7)):
        ours = ours.detach().float().numpy()
        ref = np.moveaxis(np.asarray(ref, np.float32), -1, 1)
        assert ours.shape == ref.shape
        assert np.all(np.abs(ours - ref) <= ulps * np.abs(ref)
                      + 1e-6 * np.abs(ref).max())

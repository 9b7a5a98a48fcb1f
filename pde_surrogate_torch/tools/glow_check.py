"""The cGlow's card-against-CPU check, shared by ``chip_smoke.py``'s
``[glow]`` phase and ``tests/test_torch_gpu.py``.

A seeded model whose zero-initialised ``Conv2dZeros`` kernels get
N(0, head_scale^2) weights from a seeded numpy stream, so that every
coupling net acts on the output, runs with BatchNorm in train mode, as the
training step runs it (at init the running stats do not normalise the
encoder's features).  ``glow_outputs`` returns, as float64 CPU tensors, the
density log p of a seeded y, ``generate``'s output and log p from fixed
eps, and the reverse-KL loss with its parameter gradient under sobel and
fvcg.

Two rules hold the card's float32 outputs:

* ``card_vs_cpu`` (heads at 1e-3, a well-conditioned flow): log p and the
  losses within 1e-5 relative of the CPU's float32 result; generate's
  output and the gradients within 1e-5 of their largest magnitude, or three
  times the CPU float32 result's own distance from float64.
* ``card_vs_float64`` (heads at 1e-2: the reverse flow blows the fields up
  to ~5e10 at full width and amplifies cuDNN's float32 rounding well past
  the CPU's): every output within ``ILL_CONDITIONED_BOUND`` of its largest
  float64 magnitude.  TF32 convolutions (~1e-3 relative per product) are
  what this bound keeps out.
"""

from __future__ import annotations

import numpy as np
import torch

ILL_CONDITIONED_BOUND = 2e-4


def glow_model(imsize: int, enc_blocks, flow_blocks, head_scale: float,
               device, dtype=torch.float32):
    """A dense-coupling, LU cGlow (growth 16, init features 48) with weights
    from seed 0 and its heads drawn from N(0, head_scale^2)."""
    from pde_surrogate_torch.models.flow import Conv2dZeros
    from pde_surrogate_torch.models.glow import MultiScaleCondGlow
    model = MultiScaleCondGlow(imsize, 1, 3, enc_blocks, flow_blocks, seed=0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2dZeros):
                m.conv.weight.copy_(torch.from_numpy(rng.normal(
                    0, head_scale, tuple(m.conv.weight.shape)).astype(
                        np.float32)))
    return model.to(device, dtype)


def glow_outputs(device, dtype, *, imsize: int, enc_blocks, flow_blocks,
                 head_scale: float) -> dict[str, torch.Tensor]:
    """The model's outputs (module docstring) on 8 seeded kle512 fields,
    fvcg with 64 CG iterations, float64 on the CPU."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.glow_trainer import reverse_kl_objective
    model = glow_model(imsize, enc_blocks, flow_blocks, head_scale, device,
                       dtype).train()
    rng, bsz = np.random.default_rng(1), 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)
    K = t(sample_kle(bsz, imsize, 512, rng=13)[:, None])
    y = t(rng.normal(0, 0.3, (bsz, 3, imsize, imsize)))
    eps = [t(rng.normal(size=(bsz,) + s)) for s in model.z_shapes]
    out = {}
    with torch.no_grad():
        out["density log p"] = model(y, K)[1]
        out["generate y"], out["generate log p"] = model.generate(
            K, eps_list=eps)
    sobel = SobelFilter(imsize)
    for physics in ("sobel", "fvcg"):
        model.zero_grad(set_to_none=True)
        y_gen, ll = model.generate(K, eps_list=eps)
        loss = reverse_kl_objective(K, y_gen, ll, sobel, 150.0, 50.0,
                                    3 * imsize * imsize, physics,
                                    fvcg_iters=64)["loss"]
        loss.backward()
        out[f"{physics} loss"] = loss.detach().reshape(1)
        out[f"{physics} grad"] = torch.cat([
            p.grad.flatten() for p in model.parameters()
            if p.grad is not None])
    return {k: v.detach().double().cpu() for k, v in out.items()}


def card_vs_cpu(on_card: dict, on_cpu: dict,
                f64: dict) -> list[tuple[str, float, float, float]]:
    """(name, error, bound, the CPU float32 result's own error) for each
    output.  log p and the losses: largest relative error, bound 1e-5.  The
    rest: largest absolute error over the CPU result's largest magnitude,
    bound max(1e-5, 3x the CPU's own error on that scale)."""
    rows = []
    for name, cpu in on_cpu.items():
        card, ref = on_card[name], f64[name]
        if "log p" in name or "loss" in name:
            err = float(((card - cpu).abs() / cpu.abs()).max())
            own = float(((cpu - ref).abs() / cpu.abs()).max())
            rows.append((name, err, 1e-5, own))
        else:
            scale = float(cpu.abs().max())
            err = float((card - cpu).abs().max()) / scale
            own = float((cpu - ref).abs().max()) / scale
            rows.append((name, err, max(1e-5, 3 * own), own))
    return rows


def card_vs_float64(on_card: dict,
                    f64: dict) -> list[tuple[str, float, float]]:
    """(name, error, bound) for each output: the largest absolute error
    over the float64 result's largest magnitude, bound
    ``ILL_CONDITIONED_BOUND``."""
    return [(name, float((on_card[name] - ref).abs().max())
             / float(ref.abs().max()), ILL_CONDITIONED_BOUND)
            for name, ref in f64.items()]

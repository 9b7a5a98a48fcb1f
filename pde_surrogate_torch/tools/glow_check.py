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

A trained model (ROADMAP F2: trained heads may pass 1e-2): ``--checkpoint``
loads a cGlow run's checkpoint and prints the largest effective head,
max |w| * exp(3 * scale), of each ``Conv2dZeros``, then both rules' rows on
the first 8 fields of the run's val split, the model on ``--device``
against the CPU's float32 and float64; the last line is one JSON object.
A row beyond its bound is reported, not raised: it is the measurement.

Run:  python3 -m pde_surrogate_torch.tools.glow_check \
          --checkpoint <run dir>/checkpoints/model_epoch200.pt
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
                 head_scale: float, state_dict: dict | None = None,
                 inputs: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> dict[str, torch.Tensor]:
    """The model's outputs (module docstring) on 8 seeded kle512 fields,
    fvcg with 64 CG iterations, float64 on the CPU.  ``state_dict`` (a
    trained run's) replaces the seeded weights; ``inputs`` (K, y), 8 fields
    each, replace the seeded K and y."""
    from pde_surrogate_torch.data.grf import sample_kle
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.train.glow_trainer import reverse_kl_objective
    model = glow_model(imsize, enc_blocks, flow_blocks, head_scale, device,
                       dtype).train()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    rng, bsz = np.random.default_rng(1), 8

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)
    K = t(sample_kle(bsz, imsize, 512, rng=13)[:, None])
    y = t(rng.normal(0, 0.3, (bsz, 3, imsize, imsize)))
    if inputs is not None:
        K, y = t(inputs[0][:bsz]), t(inputs[1][:bsz])
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


def effective_heads(model) -> dict[str, float]:
    """Each ``Conv2dZeros``'s largest effective weight,
    max |w| * exp(3 * scale) over its output channels, by module name."""
    from pde_surrogate_torch.models.flow import Conv2dZeros
    with torch.no_grad():
        return {name: float((m.conv.weight.abs().flatten(1).amax(1)
                             * torch.exp(3 * m.scale)).max())
                for name, m in model.named_modules()
                if isinstance(m, Conv2dZeros)}


def check_checkpoint(path: str, device) -> dict:
    """F2 on a trained cGlow: its effective heads, then ``card_vs_cpu`` and
    ``card_vs_float64`` of its outputs on the first 8 val fields (K and
    y) of its run, the model from ``path`` (``<run dir>/checkpoints/
    model_epoch<E>.pt``) on ``device`` against the CPU's float32 and
    float64."""
    from pde_surrogate_torch.cli._codec_common import resolve_dataset_files
    from pde_surrogate_torch.data.hdf5 import load_args, load_data
    run_dir = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    run = load_args(run_dir)
    arch = (getattr(run, "coupling", "dense"), run.LU_decompose,
            getattr(run, "squeeze_order", None) or "subpixel",
            run.x_channels, run.y_channels)
    if arch != ("dense", True, "subpixel", 1, 3):
        raise ValueError(f"glow_model builds a dense, LU, subpixel cGlow "
                         f"of 1 -> 3 channels, not {arch}")
    state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    run.device = str(device)
    _, val = resolve_dataset_files(run)
    x, y, _ = load_data(val, 8, only_input=False)
    kw = dict(imsize=run.imsize, enc_blocks=run.enc_blocks,
              flow_blocks=run.flow_blocks, head_scale=0.0, state_dict=state,
              inputs=(x, y))
    model = glow_model(run.imsize, run.enc_blocks, run.flow_blocks, 0.0,
                       "cpu")
    model.load_state_dict(state)
    heads = effective_heads(model)
    on_card = glow_outputs(device, torch.float32, **kw)
    on_cpu = glow_outputs("cpu", torch.float32, **kw)
    f64 = glow_outputs("cpu", torch.float64, **kw)
    return {"checkpoint": os.path.basename(path), "heads": heads,
            "largest_head": max(heads.values()),
            "card_vs_cpu": card_vs_cpu(on_card, on_cpu, f64),
            "card_vs_float64": card_vs_float64(on_card, f64)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="F2's check on a trained cGlow")
    p.add_argument("--checkpoint", required=True,
                   help="<run dir>/checkpoints/model_epoch<E>.pt")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from pde_surrogate_torch.utils.config import select_device
    device = select_device(args.device)
    out = check_checkpoint(args.checkpoint, device)
    for name, head in out["heads"].items():
        print(f"[heads] {name}: {head:.4e}")
    print(f"[heads] largest {out['largest_head']:.4e} (F2's rule holds "
          f"below 1e-2)")
    for name, err, bound, own in out["card_vs_cpu"]:
        print(f"[card_vs_cpu] {name}: {err:.3e} ({bound:.3e}; CPU f32 vs "
              f"f64 {own:.3e}) {'within' if err <= bound else 'BEYOND'}")
    for name, err, bound in out["card_vs_float64"]:
        print(f"[card_vs_float64] {name}: {err:.3e} ({bound:.0e}) "
              f"{'within' if err <= bound else 'BEYOND'}")
    print(json.dumps({"glow_check": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

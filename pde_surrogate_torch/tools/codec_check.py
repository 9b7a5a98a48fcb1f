"""The DenseED options' card check, shared by ``chip_smoke.py``'s
``[codec variants]`` phase and ``tests/test_torch_gpu.py``.

One set of weights (seed 0, BN scales, biases and running statistics drawn
from a seeded generator so that every norm acts) and one batch of kle512
fields go through one train-mode step (forward, mean(y^2), backward) of
the plain DenseED and of its options on one device, and of the plain model
on the CPU in float64.  ``variant_checks`` returns (name, error, bound,
reference error) rows; an output's or a statistic's error is the largest
|a - b| over the largest |b| of a tensor, a gradient's the rel-L2 of all
parameter gradients together:

* ``concat_free`` against the plain f32 path (output, running statistics)
  and against float64 (gradient): within the JAX package's bounds for the
  two (tests/test_codec.py:173-190: 2e-5, 1e-5, 5e-4), or three times the
  plain f32 path's own error against float64, where that is larger.  At
  full width the gradient is mostly cancellation in places, and each f32
  path rounds it its own way: on the card (DenseED [6,8,6]/16/48, 64^2,
  B=8) cuDNN's f32 gradient lies 5.2e-4 rel-L2 from float64 and the
  concat-free one 9.8e-4 (``chip_smoke.py`` ``[codec variants]``, which
  also prints the plain path without cuDNN), so each is held to float64.
* ``remat`` against plain (cuDNN's deterministic algorithms): output and
  running buffers identical, every gradient within 1e-6 of its largest
  magnitude.
* bf16 against f32: the output within 2e-2 and the gradient's rel-L2
  within 0.05 (tests/test_codec.py:192-229), or three times the CPU's own
  bf16-vs-f32 error on the same weights, where that is larger.  Those
  bounds hold between two bf16 computations; bf16 against f32 they hold
  only for narrow nets: at DenseED [6,8,6]/16/48 the JAX package's own
  bf16 gradient lies 0.135 rel-L2 from its f32 one
  (tools/codec_bf16_probe.py), so the rule holds the card to the CPU's
  bf16, which the CPU tests hold to the JAX package's.
"""

from __future__ import annotations

import torch

__all__ = ["codec_model", "codec_step", "of_max", "rel_l2", "bf16_errors",
           "variant_checks", "run_variant_checks"]


def codec_model(imsize: int, blocks, growth: int, init: int, **options):
    """A DenseED with seed-0 conv weights and seeded BN parameters and
    running statistics (``options``: dtype, concat_free, remat)."""
    from pde_surrogate_torch.models.codec import DenseED
    torch.manual_seed(0)
    model = DenseED(1, 3, imsize, blocks, growth_rate=growth,
                    init_features=init, **options)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif name.endswith("running_mean") or (
                    name.endswith("bias") and t.dim() == 1):
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))
            elif name.endswith("weight") and t.dim() == 1:
                t.copy_(1 + 0.3 * torch.randn(t.shape, generator=gen))
    return model


def codec_step(device, *, imsize: int, blocks, growth: int, init: int,
               batch: int, float64: bool = False, **options) -> dict:
    """One train-mode step on ``batch`` seeded kle512 fields: the output,
    the running buffers and the parameter gradients of mean(y^2) as float64
    CPU tensors, the dtype of the first conv's output and, on a card, the
    step's peak memory in MiB.  ``float64``: the model and the input in
    float64."""
    from pde_surrogate_torch.data.grf import sample_kle
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    dtype = torch.float64 if float64 else torch.float32
    model = codec_model(imsize, blocks, growth, init, **options).to(
        device, dtype)
    x = torch.from_numpy(sample_kle(batch, imsize, 512, rng=3))[:, None].to(
        dtype)
    seen = []
    hook = model.features.In_conv.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    y = model.train()(x.to(device))
    hook.remove()
    (y ** 2).mean().backward()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else None
    return {"output": y.detach().double().cpu(), "peak_mib": peak,
            "stats": {k: v.double().cpu() for k, v in
                      model.state_dict().items() if "running" in k},
            "grads": {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()},
            "conv_dtype": seen[0]}


def of_max(a: dict, b: dict) -> tuple[float, str]:
    """The largest of max|a - b| / max|b| over the tensors of ``b`` (zero
    tensors skipped), and the tensor where it is."""
    errs = [(float((a[k] - v).abs().max() / v.abs().max()), k)
            for k, v in b.items() if v.abs().max() > 0]
    return max(errs)


def _parts(step: dict) -> dict:
    return {"output": {"output": step["output"]}, "running stats":
            step["stats"], "gradients": step["grads"]}


def _flat(grads: dict) -> torch.Tensor:
    return torch.cat([grads[k].flatten() for k in sorted(grads)])


def rel_l2(a: dict, b: dict) -> float:
    """rel-L2 of two sets of gradients, all tensors together."""
    a, b = _flat(a), _flat(b)
    return float((a - b).norm() / b.norm())


def bf16_errors(bf16: dict, f32: dict) -> tuple[float, float]:
    """(output error of max, gradient rel-L2) of a bf16 step against an f32
    one."""
    return (of_max({"y": bf16["output"]}, {"y": f32["output"]})[0],
            rel_l2(bf16["grads"], f32["grads"]))


def variant_checks(steps: dict, cpu_bf16_errors: tuple[float, float]
                   ) -> list[tuple[str, float, float, float]]:
    """(name, error, bound, reference error) rows from the steps of one
    device, keyed ``f32``, ``concat_free``, ``remat``, ``bf16``, and
    ``f64`` (the plain model on the CPU in float64); ``cpu_bf16_errors``
    are ``bf16_errors`` of the same steps on the CPU.  The reference error
    is the plain f32 path's against float64 (for bf16: the CPU's own
    bf16-vs-f32 error)."""
    f32, f64 = steps["f32"], steps["f64"]
    cf, rem = steps["concat_free"], steps["remat"]
    rows = []
    for part, key, tol in (("output", "output", 2e-5),
                           ("running stats", "stats", 1e-5)):
        a, b, ref = ((s[key] if key == "stats" else {"y": s[key]})
                     for s in (cf, f32, f64))
        own = of_max(b, ref)[0]
        err, where = of_max(a, b)
        rows.append((f"concat_free {part} (worst: {where})", err,
                     max(tol, 3 * own), own))
    own = rel_l2(f32["grads"], f64["grads"])
    rows.append(("concat_free gradient rel-L2 to float64",
                 rel_l2(cf["grads"], f64["grads"]), max(5e-4, 3 * own), own))
    rows += [("remat output", of_max({"y": rem["output"]},
                                     {"y": f32["output"]})[0], 0.0, 0.0),
             ("remat running stats", of_max(rem["stats"], f32["stats"])[0],
              0.0, 0.0)]
    err, where = of_max(rem["grads"], f32["grads"])
    rows.append((f"remat gradients (worst: {where})", err, 1e-6, 0.0))
    out, grad = bf16_errors(steps["bf16"], f32)
    rows += [("bf16 output", out, max(2e-2, 3 * cpu_bf16_errors[0]),
              cpu_bf16_errors[0]),
             ("bf16 gradient rel-L2", grad,
              max(0.05, 3 * cpu_bf16_errors[1]), cpu_bf16_errors[1])]
    return rows


_VARIANTS = {"f32": {}, "concat_free": {"concat_free": True},
            "remat": {"remat": True}, "bf16": {"dtype": torch.bfloat16}}


def run_variant_checks(device, **shape) -> tuple[list, dict]:
    """Every variant's step on ``device`` and the f32, bf16 and float64
    steps on the CPU; returns (``variant_checks`` rows, the steps on
    ``device`` with ``cpu f32``, ``cpu bf16`` and ``f64`` added)."""
    # the port's deterministic algorithms (select_device): two runs of one
    # path are bitwise equal, so remat is compared with plain exactly
    steps = {name: codec_step(device, **shape, **opt)
             for name, opt in _VARIANTS.items()}
    steps["cpu f32"] = codec_step("cpu", **shape)
    steps["cpu bf16"] = codec_step("cpu", **shape, dtype=torch.bfloat16)
    steps["f64"] = codec_step("cpu", **shape, float64=True)
    return variant_checks(steps, bf16_errors(steps["cpu bf16"],
                                             steps["cpu f32"])), steps


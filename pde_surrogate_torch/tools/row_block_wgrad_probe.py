"""Which row-block convs need their weight gradient reduced in float64,
and what that costs the data x space step: a card probe.

    python3 -m pde_surrogate_torch.tools.row_block_wgrad_probe \\
        [--out chiprun_out/wgrad_probe.jsonl]

cuDNN chooses its weight-gradient algorithm by shape, so a conv's row
blocks may get another algorithm than its whole field.  The probe runs
three rules for ``parallel.halo._wgrad_in_float64``: ``none`` (cuDNN's
float32 weight gradient for every conv), ``stride-1`` (the port's rule:
the stride-1 convs wider than 1x1) and ``all``, and prints JSON lines:

* ``kind``: each conv kind of DenseED [6,8,6]/16/48 at 64^2, batch 32,
  f32 (``dist_check.row_block_cases``), in 2 and 4 row blocks, under each
  rule: the blocks' weight gradient's distance from the whole field's (of
  its largest value; ``[dpsp] (a)`` bounds it by 1e-5) and both from
  float64; under ``none`` also the kernels of the blocks' and of the whole
  field's weight gradient (``torch.profiler``);
* ``formulation``: for the kinds that ``stride-1`` covers, the blocks
  convolved in float32 with the whole field's symmetric padding (extra
  rows cropped) or channels-last, against float64;
* ``step``: one f32 Sobel step of that DenseED, plain, under the 1-D data
  mesh and under the 1x1 data x space mesh with each rule, on a one-rank
  NCCL group: ms by CUDA events in turns (every version, then back), the
  kernels and busy ms of one profiled step, the peak memory of a step;
* ``transient``: under ``stride-1`` and ``all``, the largest memory one
  float64 weight gradient holds at once (its float64 copies of the input
  and cotangent, its output and cuDNN's workspace) beside the float32
  tensors it copies, and the number of such reductions per step.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import halo

CODEC = dict(in_channels=1, out_channels=3, imsize=64, blocks=[6, 8, 6],
             growth_rate=16, init_features=48)
RULES = {"none": lambda weight, stride: False,
         "stride-1": halo._wgrad_in_float64,
         "all": lambda weight, stride: True}


class _Rule:
    """``halo._wgrad_in_float64`` replaced by ``RULES[name]`` inside."""

    def __init__(self, name: str):
        self.rule = RULES[name]

    def __enter__(self):
        self.saved = halo._wgrad_in_float64
        halo._wgrad_in_float64 = self.rule

    def __exit__(self, *exc):
        halo._wgrad_in_float64 = self.saved


def _emit(out, **record) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    out.write(line + "\n")


def _kernels(fn) -> list[str]:
    """The distinct device kernels ``fn()`` launches, with their counts."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
    return [f"{n} x{c}" for n, c in sorted(names.items())]


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def kinds(out) -> None:
    from . import dist_check as dc
    for n_blocks in (2, 4):
        for rule in RULES:
            with _Rule(rule):
                errs = dc.row_block_errors(dc.row_block_cases(full=True),
                                           n_blocks, "cuda", torch.float32,
                                           batch=32)
            for name, e in errs.items():
                if e["grad_w"] is not None:
                    _emit(out, part="kind", kind=name, blocks=n_blocks,
                          rule=rule, grad_w=e["grad_w"],
                          blocks_vs_f64=e["blocks_vs_f64"]["grad_w"],
                          whole_vs_f64=e["whole_vs_f64"]["grad_w"])
        rng = np.random.default_rng(0)

        def t(*shape):
            shape = tuple(32 if d is None else d for d in shape)
            return torch.from_numpy(rng.standard_normal(shape)).to(
                "cuda", torch.float32)

        for name, kind, args in dc.row_block_cases(full=True):
            if kind == "sobel":
                continue
            (x, w), run, _ = dc.row_block_case(kind, args, n_blocks, t)
            w = w.requires_grad_(True)
            with _Rule("none"):
                y_whole, y_blocks = run(x, w)
                g = t(*y_whole.shape)
                _emit(out, part="kind", kind=name, blocks=n_blocks,
                      rule="none",
                      block_wgrad_kernels=_kernels(
                          lambda: torch.autograd.grad(y_blocks, w, g,
                                                      retain_graph=True)),
                      whole_wgrad_kernels=_kernels(
                          lambda: torch.autograd.grad(y_whole, w, g,
                                                      retain_graph=True)))
            del y_whole, y_blocks


def formulations(out) -> None:
    """The blocks of the stride-1 kinds' input as the whole field pads
    them, convolved with symmetric padding and cropped, or channels-last:
    the weight gradient against float64 (for the kinds after an
    upsampling, a random input of the conv's own shape)."""
    from . import dist_check as dc
    rng = np.random.default_rng(0)
    for name, kind, args in dc.row_block_cases(full=True):
        if kind == "conv":
            k, s, p, cin, cout, n = args
        elif kind == "up":
            _, cin, cout, n = args
            k, s, p, n = 3, 1, 1, 2 * n
        else:
            continue
        if s != 1 or k == 1:
            continue
        x = torch.from_numpy(rng.standard_normal((32, cin, n, n))).cuda()
        w = torch.from_numpy(rng.standard_normal((cout, cin, k, k))).cuda()
        g = torch.from_numpy(rng.standard_normal((32, cout, n, n))).cuda()
        exact = torch.nn.grad.conv2d_weight(x, w.shape, g, 1, p)
        whole = torch.nn.grad.conv2d_weight(x.float(), w.shape, g.float(),
                                            1, p)
        for n_blocks in (2, 4):
            h = n // n_blocks
            xp = F.pad(x.float(), (0, 0, p, p))
            for variant in ("zero-H", "symmetric", "channels-last"):
                gw = torch.zeros_like(w, dtype=torch.float32)
                for j in range(n_blocks):
                    xb = xp[..., j * h:(j + 1) * h + 2 * p, :].contiguous()
                    gb = g.float()[..., j * h:(j + 1) * h, :].contiguous()
                    wv = w.float().requires_grad_(True)
                    if variant == "symmetric":
                        y = F.conv2d(xb, wv, None, 1, p)[..., p:p + h, :]
                    elif variant == "channels-last":
                        cl = torch.channels_last
                        y = F.conv2d(xb.contiguous(memory_format=cl),
                                     wv.contiguous(memory_format=cl),
                                     None, 1, (0, p))
                    else:
                        y = F.conv2d(xb, wv, None, 1, (0, p))
                    gw += torch.autograd.grad(y, wv, gb)[0]
                _emit(out, part="formulation", kind=name, blocks=n_blocks,
                      variant=variant, grad_w_vs_f64=_rel(gw, exact),
                      whole_vs_f64=_rel(whole, exact))


def _cuda_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _busy(fn) -> tuple[int, float, float]:
    """(kernels, busy ms, wall ms) of one profiled call of ``fn``."""
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(kernels), sum(e.time_range.elapsed_us() for e in kernels)
            / 1e3, start.elapsed_time(end))


def _transient(step) -> dict:
    """The largest memory one float64 weight gradient of ``step()`` holds:
    its float64 input and cotangent (made just before the call), then
    whatever the call adds at its peak (the output, cuDNN's workspace)."""
    seen = []
    conv2d_weight = torch.nn.grad.conv2d_weight

    def spy(x, shape, g, *args):
        if x.dtype != torch.float64:
            return conv2d_weight(x, shape, g, *args)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gw = conv2d_weight(x, shape, g, *args)
        copies = x.nbytes + g.nbytes
        seen.append({"bytes": copies + torch.cuda.max_memory_allocated()
                     - base, "f32_copied": copies // 2,
                     "input": list(x.shape), "weight": list(shape)})
        return gw

    torch.nn.grad.conv2d_weight = spy
    try:
        step()
        torch.cuda.synchronize()
    finally:
        torch.nn.grad.conv2d_weight = conv2d_weight
    if not seen:
        return {"reductions": 0}
    top = max(seen, key=lambda r: r["bytes"])
    return {"reductions": len(seen), "largest_MiB": top["bytes"] / 2**20,
            "its_f32_copied_MiB": top["f32_copied"] / 2**20,
            "its_input": top["input"], "its_weight": top["weight"],
            "sum_MiB": sum(r["bytes"] for r in seen) / 2**20}


def _steps(mesh, out) -> None:
    from ..data.grf import sample_kle
    from ..models.codec import DenseED
    from ..parallel.mesh import dp_sp_mesh
    from . import dist_check as dc
    dev = mesh.device
    torch.manual_seed(0)
    sd = DenseED(**CODEC).state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None]
    plain, _ = dc.codec_step(None, sd, x, CODEC, dev)
    data, _ = dc.codec_step(mesh, sd, x, CODEC, dev)
    dpsp, _ = dc.codec_step(dp_sp_mesh(1, 1, dev), sd, x, CODEC, dev)

    def under(rule):
        def step():
            with _Rule(rule):
                return dpsp()
        return step

    versions = {"plain": plain, "data mesh": data,
                **{f"1x1 mesh, f64 wgrad {r}": under(r) for r in RULES}}
    record = {}
    for name, step in versions.items():
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        kernels, busy, wall = _busy(step)
        record[name] = {"peak_MiB": torch.cuda.max_memory_allocated()
                        / 2**20, "kernels": kernels, "busy_ms": busy,
                        "profiled_wall_ms": wall, "ms": []}
    order = list(versions)
    for name in order + order[::-1]:
        record[name]["ms"].append(_cuda_ms(versions[name], 10, 3))
    for name, r in record.items():
        _emit(out, part="step", version=name, ms=sum(r.pop("ms")) / 2, **r)
    for rule in ("stride-1", "all"):
        _emit(out, part="transient", rule=rule, **_transient(under(rule)))


def main(argv=None) -> int:
    from ..parallel.launch import run
    from ..utils.config import select_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out/wgrad_probe.jsonl")
    args = p.parse_args(argv)
    select_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        kinds(out)
        formulations(out)
    with tempfile.TemporaryDirectory() as tmp:
        with open(args.out, "a") as out:
            run(_steps, 1, out, device="cuda", workdir=tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

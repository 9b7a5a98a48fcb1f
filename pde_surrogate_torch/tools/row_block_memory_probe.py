"""Where the data x space step's extra memory goes: a card probe.

    python3 -m pde_surrogate_torch.tools.row_block_memory_probe \\
        [--out memory_probe.jsonl]

(~1 min on the card.)

On a one-rank NCCL group, one f32 training step of each model of
``chip_smoke.py``'s ``[dpsp]`` lines, the cGlow (enc [3,4,4], flow
[6,6,6], reverse KL with Sobel, ActNorm data-init) and DenseED
[6,8,6]/16/48 (Sobel), both at 64^2, batch 32, in four versions: plain,
on the 1-D data mesh (its synced BatchNorm), and on the 1x1 data x space
mesh (the row blocks) with the float64 weight-gradient rule of
``parallel.halo._wgrad_in_float64`` and without it (``none``).  One JSON
line per version:

* ``peak_MiB``: the peak device memory of a step (after a first one);
* ``resident_MiB``: what is allocated before it (weights, Adam's state,
  the batch);
* ``saved_MiB``: the distinct storages that the step's forward saves for
  its backward (``torch.autograd.graph.saved_tensors_hooks``), the
  activations the backward keeps alive; ``saved_by_dtype`` splits them;
* ``ms``: the step's time by CUDA events (10 steps after 3), to compare
  two trees run in turns (parent, change, change, parent).

The difference of two versions' ``saved_MiB`` is what one layer keeps
more; the rest of a difference of peaks is transient (the float64
weight-gradient copies among it).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..parallel import halo

CODEC = dict(in_channels=1, out_channels=3, imsize=64, blocks=[6, 8, 6],
             growth_rate=16, init_features=48)
GLOW = dict(img_size=64, x_channels=1, y_channels=3, enc_blocks=[3, 4, 4],
            flow_blocks=[6, 6, 6])


class _NoFloat64Wgrad:
    """``halo._wgrad_in_float64`` answering False inside."""

    def __enter__(self):
        self.saved = halo._wgrad_in_float64
        halo._wgrad_in_float64 = lambda weight, stride: False

    def __exit__(self, *exc):
        halo._wgrad_in_float64 = self.saved


def _saved(step) -> tuple[float, dict]:
    """MiB of the distinct storages ``step()``'s forward saves for
    backward, in all and by dtype."""
    seen: dict = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = (s.nbytes(), str(t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    torch.cuda.synchronize()
    by_dtype: dict = {}
    for nbytes, dtype in seen.values():
        by_dtype[dtype] = by_dtype.get(dtype, 0.0) + nbytes / 2**20
    return sum(by_dtype.values()), by_dtype


def _measure(step) -> dict:
    step()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    saved, by_dtype = _saved(step)
    for _ in range(3):
        step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        step()
    end.record()
    end.synchronize()
    return {"peak_MiB": peak / 2**20, "resident_MiB": resident / 2**20,
            "saved_MiB": saved, "saved_by_dtype": by_dtype,
            "ms": start.elapsed_time(end) / 10}


def _steps(mesh, out) -> None:
    from ..data.grf import sample_kle
    from ..models.codec import DenseED
    from ..ops.kernels.cg_darcy import solve_darcy_cg_plain
    from ..parallel.mesh import dp_sp_mesh
    from ..solvers.fd_darcy import darcy_fields
    from . import dist_check as dc
    from .glow_check import glow_model
    dev = mesh.device
    m2 = dp_sp_mesh(1, 1, dev)
    card = torch.cuda.get_device_name(0)
    torch.manual_seed(0)
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=4))[:, None]
    K = x[:, 0].to(dev)
    y = darcy_fields(K, solve_darcy_cg_plain(K, 24 * 64)).cpu()
    sd = glow_model(64, GLOW["enc_blocks"], GLOW["flow_blocks"], 1e-3,
                    "cpu").state_dict()
    glow = {name: dc.glow_step(m, sd, x, GLOW, dev, init_y=y)[0]
            for name, m in (("plain", None), ("data mesh", mesh),
                            ("1x1 mesh", m2))}
    sd = DenseED(**CODEC).state_dict()
    x = torch.from_numpy(sample_kle(32, 64, 512, rng=3))[:, None]
    codec = {name: dc.codec_step(m, sd, x, CODEC, dev)[0]
             for name, m in (("plain", None), ("data mesh", mesh),
                             ("1x1 mesh", m2))}
    for model, steps in (("cglow", glow), ("densed", codec)):
        for name, step in steps.items():
            rules = ["stride-1", "none"] if name == "1x1 mesh" else [None]
            for rule in rules:
                if rule == "none":
                    with _NoFloat64Wgrad():
                        record = _measure(step)
                else:
                    record = _measure(step)
                line = json.dumps({"model": model, "version": name,
                                   "f64_wgrad": rule, **record,
                                   "card": card})
                print(line, flush=True)
                out.write(line + "\n")
        steps.clear()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    from ..parallel.launch import run
    from ..utils.config import select_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="memory_probe.jsonl")
    args = p.parse_args(argv)
    select_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        with open(args.out, "w") as out:
            run(_steps, 1, out, device="cuda", workdir=tmp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

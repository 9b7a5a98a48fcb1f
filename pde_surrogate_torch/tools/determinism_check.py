"""Bit-for-bit repeatability of the port's training, and what it costs.

The JAX package's training repeats bit for bit from a key; the port's
does from a seed once ``utils.config.select_device`` has set its numerics
(deterministic algorithms, a fixed cuBLAS workspace).  The rules here are
shared by ``chip_smoke.py``'s ``[determinism]`` phase and the tests
(``tests/test_torch_determinism.py`` on the CPU, ``tests/test_torch_gpu.py``
on the card):

* a *case* is a function that builds a fresh training set-up from fixed
  seeds (weights, batches, noise generator) and returns ``(step,
  record)``: ``step()`` takes one step and returns its scalar metrics,
  ``record()`` the state after it (``training_state``: every parameter,
  buffer and optimizer-state tensor).  ``run_case`` takes ``n`` steps and
  gathers the metrics and the state; ``repeat`` runs a case twice and
  names what is not ``torch.equal`` between the two (``differences``).
* ``codec_case`` (the DenseED under ``sobel``, ``fvcg``, ``sobel_fvcg``
  or MLE), ``glow_case`` (the cGlow's reverse-KL step), ``adam_case`` (a
  solver's Adam step on its flat vector) and ``zoom_case`` (one L-BFGS
  epoch with the zoom linesearch).
* ``cli_repeat``: a training CLI run twice without a break and once
  stopped after an epoch's checkpoint and resumed from it
  (``--ckpt-epoch``); every tensor of the last checkpoint and its JSON
  sidecar (the logged losses, R^2 and consistency) compared.
"""

from __future__ import annotations

import contextlib
import json
import os
from unittest import mock

import numpy as np
import torch

__all__ = ["training_state", "run_case", "differences", "repeat",
           "codec_case", "glow_case", "adam_case", "zoom_case",
           "checkpoint_tensors", "cli_repeat"]


def training_state(model, optimizer=None) -> dict[str, torch.Tensor]:
    """Copies of ``model``'s parameters and buffers and of every tensor in
    ``optimizer``'s state (Adam's moments and step), by name."""
    out = {f"param.{n}": p.detach().clone()
           for n, p in model.named_parameters()}
    out.update({f"buffer.{n}": b.clone() for n, b in model.named_buffers()})
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        for p, st in optimizer.state.items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    out[f"optim.{names[id(p)]}.{k}"] = v.clone()
    return out


def run_case(make, n_steps: int = 3) -> dict[str, torch.Tensor]:
    """``n_steps`` steps of the case ``make``: each step's metrics
    (``step{i}.<name>``) and the state after the last."""
    step, record = make()
    out = {}
    for i in range(n_steps):
        for k, v in step().items():
            out[f"step{i}.{k}"] = torch.as_tensor(v).detach().clone()
    out.update(record())
    return out


def _same(a, b) -> bool:
    if not (torch.is_tensor(a) and torch.is_tensor(b)):
        return type(a) is type(b) and a == b
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.cpu(), b.cpu()))


def differences(a: dict, b: dict) -> list[str]:
    """Names of the entries of two records that are missing from one or not
    bitwise equal (tensors: dtype, shape and every element; other values:
    type and value)."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not _same(a[k], b[k]))


def repeat(make, n_steps: int = 3) -> list[str]:
    """The case run twice from scratch; what differs (empty: bitwise
    equal)."""
    return differences(run_case(make, n_steps), run_case(make, n_steps))


def _kle(batch: int, imsize: int, rng: int, device) -> torch.Tensor:
    from ..data.grf import sample_kle
    return torch.from_numpy(sample_kle(batch, imsize, 512, rng=rng))[
        :, None].to(device)


def codec_case(device, kind: str, imsize: int = 64, blocks=(6, 8, 6),
               growth_rate: int = 16, init_features: int = 48,
               batch: int = 32, fvcg_iters: int | None = None):
    """The DenseED's training step (Adam + OneCycle, lr 1e-3), its weights
    from torch seed 0, step i on kle512 batch i mod 3 (made on the device
    beforehand, so a timed step holds no data generation): ``kind``
    ``mle`` (labels drawn from numpy seed i mod 3) or a physics objective
    (``sobel``, ``fvcg``, ``sobel_fvcg``)."""
    from ..models.codec import DenseED
    from ..ops.filters import SobelFilter
    from ..train.codec_trainer import (create_state, make_mixed_residual_step,
                                       make_mle_step)

    def make():
        torch.manual_seed(0)
        model = DenseED(1, 3, imsize, list(blocks), growth_rate=growth_rate,
                        init_features=init_features).to(device)
        state = create_state(model, lr_max=1e-3, total_steps=1000)
        if kind == "mle":
            fn = make_mle_step(state)
        else:
            fn = make_mixed_residual_step(state, SobelFilter(imsize),
                                          10.0, physics=kind,
                                          fvcg_iters=fvcg_iters)
        xs = [_kle(batch, imsize, i, device) for i in range(3)]
        ys = [torch.from_numpy(np.random.default_rng(i).normal(
            0, 1, (batch, 3, imsize, imsize)).astype(np.float32)).to(device)
            for i in range(3)] if kind == "mle" else None

        def step():
            i = state.step % 3
            return fn(xs[i]) if ys is None else fn(xs[i], ys[i])
        return step, lambda: training_state(model, state.optimizer)
    return make


def glow_case(device, enc=(3, 3, 3, 3), flow=(4, 4, 4, 4), imsize: int = 64,
              batch: int = 32):
    """The cGlow's Sobel reverse-KL step (beta 150, weight bound 50, lr
    1.5e-3, the NaN guard on; default: the canonical enc [3,3,3,3] flow
    [4,4,4,4])
    from ``tools/glow_check.glow_model``'s seeded weights, its noise from
    the state's generator (seed 1, step i), step i on kle512 batch i mod
    3 (made on the device beforehand)."""
    from ..ops.filters import SobelFilter
    from ..train.glow_trainer import create_glow_state, make_reverse_kl_step
    from .glow_check import glow_model

    def make():
        model = glow_model(imsize, list(enc), list(flow), 1e-3, device)
        state = create_glow_state(model, lr_max=1.5e-3, total_steps=1000,
                                  seed=1)
        fn = make_reverse_kl_step(state, SobelFilter(imsize),
                                  150.0, 50.0, 3 * imsize * imsize)
        xs = [_kle(batch, imsize, i, device) for i in range(3)]

        def step():
            return fn(xs[state.step % 3])
        return step, lambda: training_state(model, state.optimizer)
    return make


def adam_case(make_loss, lr: float = 2e-3):
    """A solver's Adam step (the warmup's) on its flat parameter vector:
    ``make_loss()`` returns ``(loss of the vector, the vector, module)``;
    the module's buffers (train-mode BatchNorm statistics) are recorded
    with the vector and Adam's state."""

    def make():
        loss, v, module = make_loss()
        x = v.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([x], lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            value = loss(x)
            value.backward()
            opt.step()
            return {"loss": value}

        def record():
            out = {"vector": x.detach().clone()}
            out.update({f"optim.{k}": t.clone()
                        for k, t in opt.state[x].items()})
            out.update({f"buffer.{n}": b.clone()
                        for n, b in module.named_buffers()})
            return out
        return step, record
    return make


def zoom_case(make_loss, iters: int = 20):
    """One L-BFGS epoch (``iters`` steps, the zoom linesearch, memory 50)
    on a solver's flat vector: the epoch's loss, the vector, the
    optimizer's memory and cached gradient."""
    from ..train.lbfgs import lbfgs_optimizer, make_lbfgs_epoch

    def make():
        loss, v, module = make_loss()
        opt = lbfgs_optimizer(learning_rate=None)
        epoch = make_lbfgs_epoch(loss, opt, iters)
        held = {"params": v.detach().clone(), "state": opt.init(v.detach())}

        def step():
            held["params"], held["state"], value = epoch(held["params"],
                                                         held["state"])
            st = held["state"]
            return {"loss": value, "value": torch.tensor(st.value),
                    "stepsize": torch.tensor(st.stepsize),
                    "evals": torch.tensor(st.evals)}

        def record():
            st = held["state"]
            out = {"vector": held["params"].detach().clone()}
            out.update({f"lbfgs.{k}": getattr(st, k).clone() for k in (
                "params", "updates", "diff_params", "diff_updates",
                "weights", "grad")})
            out.update({f"buffer.{n}": b.clone()
                        for n, b in module.named_buffers()})
            return out
        return step, record
    return make


def checkpoint_tensors(path: str) -> dict:
    """Every leaf of a checkpoint file by its key path (tensors, and the
    optimizer's and counters' plain values), for a bytewise comparison."""
    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = obj
    walk("", torch.load(path, map_location="cpu", weights_only=True))
    return out


def _run_record(exp: str, epoch: int) -> dict:
    (run_dir,) = [r for r, _, files in os.walk(exp) if "args.txt" in files]
    ckpt = os.path.join(run_dir, "checkpoints", f"model_epoch{epoch}")
    record = {f"ckpt.{k}": v
              for k, v in checkpoint_tensors(ckpt + ".pt").items()}
    with open(ckpt + ".json") as f:
        record["meta"] = json.load(f)
    return record


class _Stopped(Exception):
    pass


def cli_repeat(module, argv: list[str], exp_root: str, epochs: int,
               stop_at: int, saver=None) -> dict[str, list[str]]:
    """The training CLI ``module`` (its ``main``, with ``argv`` and no
    ``--exp-dir`` or ``--epochs``) run for ``epochs`` epochs twice, each in
    its own exp dir under ``exp_root``, and once stopped right after its
    epoch-``stop_at`` checkpoint (as a killed job is; ``saver``: the module
    whose ``save_checkpoint`` the loop calls, by default ``module``) and
    resumed from it with ``--ckpt-epoch``.  Returns, for the second run and the resumed
    one, what differs from the first in the last checkpoint: tensor key
    paths (``ckpt.model.<name>``, ``ckpt.optimizer.state...``, the
    counters) and ``meta`` (the sidecar: epoch, logger lists, consistency
    history)."""
    saver = saver or module
    save = saver.save_checkpoint

    def stop_after(ckpt_dir, epoch, *a, **kw):
        path = save(ckpt_dir, epoch, *a, **kw)
        if epoch == stop_at:
            raise _Stopped
        return path

    records = {}
    for name in ("first", "second", "resumed"):
        exp = os.path.join(exp_root, name)
        run = argv + ["--exp-dir", exp, "--epochs", str(epochs)]
        if name == "resumed":
            with mock.patch.object(saver, "save_checkpoint", stop_after), \
                    contextlib.suppress(_Stopped):
                module.main(run)
            run += ["--ckpt-epoch", str(stop_at)]
        module.main(run)
        records[name] = _run_record(exp, epochs)
    first = records.pop("first")
    out = {}
    for name, rec in records.items():
        diff = differences({k: v for k, v in first.items() if k != "meta"},
                           {k: v for k, v in rec.items() if k != "meta"})
        out[name] = diff + ([] if rec["meta"] == first["meta"] else ["meta"])
    return out


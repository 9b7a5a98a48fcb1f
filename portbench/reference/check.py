"""The comparisons that decide ``correct``, and the reference runs they
compare with.

Training: the program's first three steps (taken in set-up through the
window's own step and batch stream) against the reference's three steps
from the same weights, rows and noise.  Norms are compared leaf by leaf
as the gap between the program's and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf.  The numbers:

* ``loss_gap``: the first step's loss, relative;
* ``grad_gap``: the worst leaf's first gradient (the program's read from
  Adam's first moment after one step);
* ``change_gap``: the worst leaf's change after three steps.  A leaf whose
  reference gradient is under a thousandth of the median leaf's moves by
  round-off alone and is left out;
* ``buffer_gap``: the worst BatchNorm running moment's change after the
  first step, as the training forward folds the batch's moments into it.

The first steps of training from random weights amplify rounding: Adam's
first updates are near +-lr per element whatever the gradient's size, and
the loss moves by whole multiples from step to step, so the second and
third steps' losses swing from seed to seed by a hundredfold at float32;
the first step's loss and running moments are steady (``train_detail``
reads the others; PERF.md gives the readings).

Propagation: the four moment fields of a call, each as the largest
absolute gap over the reference's largest absolute value.

The reference runs in float64 (``REFERENCE``); its control runs the same
code in float32 with TF32 on (``control``), the nearest precision below the
configurations' float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

from ..lib import weights
from .denseed import MOMENTS
from .optim import Adam, one_cycle_lr

REFERENCE = torch.float64
CHECKED_STEPS = 3
ROUND_OFF = 1e-3        # a leaf's gradient under this share of the median
MOMENTUM = 0.1          # BatchNorm's share of the batch in its running moments


@contextlib.contextmanager
def control():
    """float32 products in TF32, as the control computes them."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def train_readings(loss_fn, spec: list, seed: int, batches: list,
                   lr_fn, device, dtype=REFERENCE) -> dict:
    """Losses of ``len(batches)`` steps of Adam on ``loss_fn(weights,
    batch, step)`` from the benchmark's weights of ``seed``, the first
    gradient's norm and the change after the last step, per leaf, and the
    running moments' changes after the first and the last step."""
    w = weights.make(spec, seed, device, dtype)
    names, moments = weights.leaves(spec), weights.running(spec)
    params = {n: w[n].requires_grad_() for n in names}
    start = {n: w[n].detach().clone() for n in names + moments}
    adam = Adam(params)
    losses, grad, buffers = [], {}, {}
    for k, x in enumerate(batches):
        w[MOMENTS] = {}
        loss = loss_fn(w, x.to(device, dtype), k)
        grads = torch.autograd.grad(loss, list(params.values()))
        for bn, (mean, var) in w.pop(MOMENTS).items():
            for kind, batch in (("running_mean", mean), ("running_var", var)):
                run = w[f"{bn}.{kind}"]
                w[f"{bn}.{kind}"] = run + MOMENTUM * (batch - run)
        if k == 0:
            grad = {n: float(g.norm()) for n, g in zip(names, grads)}
            buffers = changes(w, start, moments)
        adam.step(dict(zip(names, grads)), lr_fn(k))
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad": grad, "change": changes(w, start, names),
            "buffers": buffers, "buffers_last": changes(w, start, moments)}


def changes(now: dict, start: dict, names: list) -> dict:
    """The norm of each named tensor's change from ``start``."""
    return {n: float((now[n].detach() - start[n]).norm()) for n in names}


def worst(values) -> float:
    """The largest of ``values``; NaN if any is NaN."""
    values = [float(v) for v in values]
    return float("nan") if any(v != v for v in values) else max(values)


def _leaf_gaps(prog: dict, ref: dict, names: list) -> list:
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names]


def _moved(ref: dict) -> list:
    med = statistics.median(ref["grad"].values())
    return [n for n in ref["grad"] if ref["grad"][n] >= ROUND_OFF * med]


def _median(values: list) -> float:
    return (float("nan") if any(v != v for v in values)
            else statistics.median(values))


def train_gaps(prog: dict, ref: dict) -> dict:
    """loss_gap, grad_gap, change_gap and buffer_gap of the program's
    readings."""
    return {"loss_gap": abs(prog["loss"][0] - ref["loss"][0])
            / abs(ref["loss"][0]),
            "grad_gap": worst(_leaf_gaps(prog["grad"], ref["grad"],
                                         list(ref["grad"]))),
            "change_gap": worst(_leaf_gaps(prog["change"], ref["change"],
                                           _moved(ref))),
            "buffer_gap": worst(_leaf_gaps(prog["buffers"], ref["buffers"],
                                           list(ref["buffers"])))}


def train_detail(prog: dict, ref: dict) -> dict:
    """The readings that are not compared: every step's loss gap, the
    worst leaves and the running moments after the last step."""
    names, moved = list(ref["grad"]), _moved(ref)
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    bufs = list(ref["buffers"])
    first = _leaf_gaps(prog["buffers"], ref["buffers"], bufs)
    last = _leaf_gaps(prog["buffers_last"], ref["buffers_last"], bufs)
    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(prog["loss"], ref["loss"])],
            "ref_losses": ref["loss"],
            "worst_grad_leaf": names[grad.index(max(grad))] if grad == grad
            else None,
            "median_change_gap": _median(change),
            "worst_change_leaf": moved[change.index(max(change))],
            "worst_buffer": bufs[first.index(max(first))] if first == first
            else None,
            "buffer_gap_last": worst(last),
            "leaves_moved": len(moved), "leaves": len(names)}


def one_cycle(recipe: dict, total_steps: int):
    """The reference's lr of update k for a configuration's recipe."""
    return lambda k: one_cycle_lr(k, recipe["lr"], total_steps,
                                  recipe["lr_div"], recipe["lr_pct"])


def moment_gap(prog: list, ref: list) -> float:
    """The largest of the four fields' max |program - reference| over
    max |reference| (or over 1 where the reference field is 0)."""
    gaps = []
    for p, r in zip(prog, ref):
        p, r = p.double().cpu(), r.double().cpu()
        gaps.append(float((p - r).abs().max()) / (float(r.abs().max()) or 1.0))
    return worst(gaps)

"""A model's weights and buffers made on the device from the run's seed, in
one draw: the same seed gives the same values to the program and to the
reference, which each receive them from here."""

from __future__ import annotations

import math

import torch

from ..reference.seeding import make_generator

WEIGHTS_STREAM = 2      # the seed's counter for weights (inputs use 1)
DRAWN = ("fan", "abs", "one", "sign")
RUNNING = ("running_mean", "running_var")


def make(spec: list, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for ``spec`` [(name, shape, init)]: init ``fan:a`` is
    U(+-a / sqrt(fan in)), fan in the product of the shape's trailing dims;
    ``abs:a`` U(+-a); ``one:a`` 1 + U(+-a); ``sign`` +-1; ``eye`` the
    identity; ``ones``, ``zeros``; ``count`` an int64 zero.  Every random
    value comes from one float32 draw of a generator on ``device`` seeded
    by (seed, 2), taken in ``spec`` order, and is cast to ``dtype``
    afterwards."""
    random = [(n, s, i) for n, s, i in spec if i.split(":")[0] in DRAWN]
    total = sum(math.prod(s) for _, s, _ in random)
    u = torch.rand(total, generator=make_generator(device, seed,
                                                   WEIGHTS_STREAM),
                   device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, init in spec:
        kind, _, arg = init.partition(":")
        if kind in DRAWN:
            n = math.prod(shape)
            v = u[at:at + n].view(shape)
            at += n
            if kind == "fan":
                v = v * (float(arg) / math.sqrt(math.prod(shape[1:])))
            elif kind == "abs":
                v = v * float(arg)
            elif kind == "one":
                v = 1.0 + v * float(arg)
            else:
                v = torch.where(v >= 0, 1.0, -1.0)
            out[name] = v.to(dtype)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "eye":
            out[name] = torch.eye(shape[0], dtype=dtype, device=device)
        elif kind in ("ones", "zeros"):
            fill = torch.ones if kind == "ones" else torch.zeros
            out[name] = fill(shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out


def leaves(spec: list) -> list:
    """The names of ``spec``'s trained leaves (not BatchNorm's running
    moments and counters, nor the fixed factors ``eye`` and ``sign``)."""
    fixed = RUNNING + ("num_batches_tracked",)
    return [n for n, _, i in spec
            if not n.endswith(fixed) and i.split(":")[0] not in ("eye", "sign")]


def running(spec: list) -> list:
    """The names of ``spec``'s BatchNorm running moments."""
    return [n for n, _, _ in spec if n.endswith(RUNNING)]

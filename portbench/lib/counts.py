"""The operations and bytes a cell's work needs, counted once from the
plain reference on the meta device at the cell's shapes, so that they count
the same work whatever implements it.

Operations are those of convolutions and matrix products, forward and
backward (``torch.utils.flop_counter``).  Bytes are what those products
must read and write: each operand once and each result once, at the width
of its dtype.  Elementwise work (normalisation, activations, the
optimizer) is left out of both: a fused implementation need not move its
intermediates through memory at all.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_PRODUCTS = ("convolution", "convolution_backward", "mm", "bmm", "addmm",
             "baddbmm")


class _ProductBytes(TorchDispatchMode):
    """Sums the operand and result bytes of every product dispatched."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _PRODUCTS:
            tensors = [a for a in (*args, *(kwargs or {}).values(), out)
                       for a in (a if isinstance(a, (tuple, list)) else (a,))
                       if isinstance(a, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in tensors)
        return out


def count(fn) -> tuple[int, int]:
    """(operations, bytes) of the products that ``fn()`` runs; ``fn``
    builds its own meta tensors."""
    with FlopCounterMode(display=False) as flops, _ProductBytes() as nbytes:
        fn()
    return int(flops.get_total_flops()), int(nbytes.bytes)


def meta_params(spec: list, dtype=torch.float32, trained=()) -> dict:
    """A dict of meta tensors for ``spec``; the names in ``trained``
    require grad."""
    out = {}
    for name, shape, init in spec:
        t = torch.empty(shape, dtype=torch.int64 if init == "count" else dtype,
                        device="meta")
        out[name] = t.requires_grad_(name in trained)
    return out

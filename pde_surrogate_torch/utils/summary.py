"""Model shape and parameter summaries.

Counterpart of pde_surrogate_tpu/utils/summary.py (flax ``nn.tabulate``):
forward hooks record the output shape of every module down to ``depth``
dotted levels, beside the module's parameter count.
"""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["summarize"]


def _shapes(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(tuple(out.shape))
    if isinstance(out, (tuple, list)):
        return ", ".join(_shapes(o) for o in out)
    return type(out).__name__


def summarize(model: nn.Module, *example_args, depth: int = 2,
              **example_kwargs) -> str:
    """Return (and print) a table of output shapes and parameter counts,
    one row per module called in the forward pass at most ``depth`` levels
    below ``model`` (the model's own row is named by its class), and the
    total."""
    rows: dict[str, tuple[str, int]] = {}
    handles = []
    for name, module in model.named_modules():
        if name.count(".") >= depth:
            continue
        name = name or type(model).__name__
        n_params = sum(p.numel() for p in module.parameters())

        def hook(mod, args, out, name=name, n_params=n_params):
            rows.setdefault(name, (_shapes(out), n_params))
        handles.append((name, module.register_forward_hook(hook)))
    try:
        with torch.no_grad():
            model(*example_args, **example_kwargs)
    finally:
        for _, h in handles:
            h.remove()
    order = [name for name, _ in handles if name in rows]
    width = max(len(k) for k in order) + 2
    lines = [f"{'module':<{width}}{'output shape':<24}params"]
    lines += [f"{k:<{width}}{rows[k][0]:<24}{rows[k][1]}" for k in order]
    lines.append(f"Total params: {sum(p.numel() for p in model.parameters())}")
    table = "\n".join(lines)
    print(table)
    return table

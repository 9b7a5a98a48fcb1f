"""Evaluation metrics — the reference's acceptance quantities (NCHW).

* relative L2 (NRMSE) per output channel:
  ``sqrt(sum_HW (out-tgt)^2 / sum_HW tgt^2)``, averaged over the test set
  (reference train_codec_mixed_residual.py:180-181,196).
* R^2 per channel: ``1 - SSE / y_variation`` with ``y_variation`` the test
  set's per-channel sum of squared deviations from its mean.

On a row block of a data x space mesh (``rows``, a
``parallel.halo.RowShard``) the sums over H and W are this block's,
summed over the space group before they are used: the rel-L2's numerator
and denominator each before the square root.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum

__all__ = ["field_sum", "relative_l2", "squared_error_sum", "r2_score"]


def field_sum(t: torch.Tensor, rows=None) -> torch.Tensor:
    """Per-sample sums of ``t`` over its last two axes (H, W): on a row
    block (``rows``) summed over the space group too."""
    s = torch.sum(t, dim=(-2, -1))
    return s if rows is None else all_reduce_sum(s, rows.group)


def relative_l2(output: torch.Tensor, target: torch.Tensor,
                rows=None) -> torch.Tensor:
    """Per-sample per-channel relative L2, (B, C)."""
    err2 = field_sum((output - target) ** 2, rows)
    ref2 = field_sum(target ** 2, rows)
    return torch.sqrt(err2 / ref2)


def squared_error_sum(output: torch.Tensor, target: torch.Tensor,
                      rows=None) -> torch.Tensor:
    """Per-sample per-channel SSE over H, W, (B, C)."""
    return field_sum((output - target) ** 2, rows)


def r2_score(sse_per_channel, y_variation):
    """R^2 = 1 - SSE / y_variation, per channel (tensors or arrays)."""
    return 1.0 - sse_per_channel / y_variation

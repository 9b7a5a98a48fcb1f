"""Evaluation metrics — the reference's acceptance quantities (NCHW).

* relative L2 (NRMSE) per output channel:
  ``sqrt(sum_HW (out-tgt)^2 / sum_HW tgt^2)``, averaged over the test set
  (reference train_codec_mixed_residual.py:180-181,196).
* R^2 per channel: ``1 - SSE / y_variation`` with ``y_variation`` the test
  set's per-channel sum of squared deviations from its mean.
"""

from __future__ import annotations

import torch

__all__ = ["relative_l2", "squared_error_sum", "r2_score"]


def relative_l2(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample per-channel relative L2, (B, C)."""
    err2 = torch.sum((output - target) ** 2, dim=(2, 3))
    ref2 = torch.sum(target ** 2, dim=(2, 3))
    return torch.sqrt(err2 / ref2)


def squared_error_sum(output: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
    """Per-sample per-channel SSE over H, W, (B, C)."""
    return torch.sum((output - target) ** 2, dim=(2, 3))


def r2_score(sse_per_channel, y_variation):
    """R^2 = 1 - SSE / y_variation, per channel (tensors or arrays)."""
    return 1.0 - sse_per_channel / y_variation

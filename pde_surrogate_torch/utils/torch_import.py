"""Load the reference's PyTorch checkpoints (.pth) into the port's models.

Counterpart of pde_surrogate_tpu/utils/torch_import.py.  The reference
workflow publishes trained checkpoints (scripts/download_checkpoints.sh)
and post-processes them (post_cglow.py:54-61); these functions map such a
``state_dict`` onto the port's models so those weights are served by
``predict_codec``, ``predict_cglow`` and ``post_cglow``.

* The DenseED and the Decoder carry the reference's module names, so a
  codec ``state_dict`` loads as it is; a strict load checks the topology.
* The conditional Glow carries the JAX package's flax names joined by dots.
  From a reference name, ``convert_glow_state_dict`` drops the ``flow.``
  Sequential and the ``revlayers.`` / ``reduce.`` container levels
  (reference models/glow_msc.py:672-748), flattens the (C,1,1) ActNorm
  tensors and the (1,C,1,1) Conv2dZeros ``scale`` to (C,), keeps
  ``p`` / ``sign_s``, and skips the LU masks and ``eye`` (the port derives
  them).  The model must use ``squeeze_order='reference'``: the reference's
  convs were trained on its quadrant-tile squeeze (glow_msc.py:415-421).
"""

from __future__ import annotations

import torch

__all__ = ["load_state_dict", "convert_glow_state_dict", "load_into"]

_CONTAINERS = ("flow", "revlayers", "reduce")
_SKIP = ("l_mask", "u_mask", "eye")


def load_state_dict(pth_path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` as a flat {name: tensor} dict on the CPU.

    Takes bare ``state_dict`` saves (the codec drivers) and training dicts
    with a ``model_state_dict`` or ``model`` entry (the cGlow driver saves
    ``{epoch, model, optimizer, logger}``, train_cglow_reverse_kl.py:281-289).
    Only tensors and plain containers are unpickled (``weights_only``).
    """
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and not any(
            isinstance(v, torch.Tensor) for v in obj.values()):
        for key in ("model_state_dict", "model"):
            if key in obj:
                obj = obj[key]
                break
    return dict(obj)


def convert_glow_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """Reference MultiScaleCondGlow ``state_dict`` -> the port's names and
    shapes."""
    out = {}
    for name, value in sd.items():
        *modules, leaf = [p for p in name.split(".") if p not in _CONTAINERS]
        if leaf in _SKIP:
            continue
        if leaf == "scale" or (leaf in ("weight", "bias") and value.ndim == 3):
            value = value.reshape(-1)    # Conv2dZeros scale, ActNorm
        out[".".join([*modules, leaf])] = value
    return out


def load_into(model: torch.nn.Module, sd: dict, flags: str) -> None:
    """Strict ``load_state_dict`` that names the topology flags to check
    when the names or shapes do not match."""
    own = model.state_dict()
    problems = [f"imported-only: {k} {tuple(sd[k].shape)}"
                for k in sorted(set(sd) - set(own))]
    problems += [f"missing: {k} {tuple(own[k].shape)}"
                 for k in sorted(set(own) - set(sd))]
    problems += [f"shape mismatch at {k}: {tuple(sd[k].shape)} vs "
                 f"{tuple(own[k].shape)}" for k in sorted(set(sd) & set(own))
                 if sd[k].shape != own[k].shape]
    if problems:
        raise ValueError("torch state_dict does not match the model "
                         "topology:\n  " + "\n  ".join(problems)
                         + f"\n(check {flags})")
    model.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})

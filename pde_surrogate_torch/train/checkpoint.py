"""Checkpoints with the reference's run-directory layout.

Counterpart of pde_surrogate_tpu/train/checkpoint.py.  A checkpoint is two
files per epoch in ``run_dir/checkpoints``:

  * ``model_epoch{N}.pt``   — ``{"model", "optimizer"}`` state dicts and
    the state's counters (``step``; a ``GlowState`` adds ``updates`` and
    ``notfinite_count``);
  * ``model_epoch{N}.json`` — metadata (epoch, logger metric lists,
    flux-pressure consistency history).

The single-instance solvers keep weights only: ``save_weights`` writes
``{"model"}`` to the same file name, which ``restore_weights`` reads.

Writes are atomic (tmp + rename), so a killed job never leaves a torn file.
A data-parallel state (``state.mesh``) is written by rank 0 alone, and
every rank waits until it is written; what is saved is the plain module's
state dict, so it loads in one process.  On resume every rank reads.
"""

from __future__ import annotations

import io
import json
import math
import os
import re

import torch

from ..parallel.mesh import barrier, is_main

__all__ = ["save_checkpoint", "save_weights", "restore_checkpoint",
           "restore_weights",
           "latest_epoch", "latest_meta_epoch", "select_consistency_epoch",
           "checkpoint_file"]


def checkpoint_file(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"model_epoch{epoch}.pt")


def _meta_file(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"model_epoch{epoch}.json")


def _atomic_write(path: str, data: bytes | str):
    mode = "wb" if isinstance(data, bytes) else "w"
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        f.write(data)
    os.replace(tmp, path)


def _counters(state) -> dict[str, int]:
    """The state's step counters: ``step``, plus a ``GlowState``'s
    ``COUNTERS`` (applied updates, consecutive non-finite steps)."""
    return {name: int(getattr(state, name))
            for name in getattr(state, "COUNTERS", ("step",))}


def save_checkpoint(ckpt_dir: str, epoch: int, state,
                    meta: dict | None = None) -> str:
    """Write ``state`` (a ``CodecState`` or ``GlowState``) and the JSON-able
    ``meta`` (on rank 0 of a data mesh; the ranks meet afterwards)."""
    path = checkpoint_file(ckpt_dir, epoch)
    mesh = getattr(state, "mesh", None)
    if is_main(mesh):
        os.makedirs(ckpt_dir, exist_ok=True)
        buf = io.BytesIO()
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    **_counters(state)}, buf)
        _atomic_write(path, buf.getvalue())
        if meta is not None:
            _atomic_write(_meta_file(ckpt_dir, epoch),
                          json.dumps(meta, indent=2))
    barrier(mesh)
    return path


def save_weights(ckpt_dir: str, epoch: int, model) -> str:
    """Write only ``model``'s state dict (weights and buffers)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    buf = io.BytesIO()
    torch.save({"model": model.state_dict()}, buf)
    path = checkpoint_file(ckpt_dir, epoch)
    _atomic_write(path, buf.getvalue())
    return path


def _load(ckpt_dir: str, epoch: int, model) -> dict:
    device = next(model.parameters()).device
    return torch.load(checkpoint_file(ckpt_dir, epoch), map_location=device,
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, epoch: int, state,
                       with_meta: bool = False):
    """Load the checkpoint of ``epoch`` into ``state`` in place.

    Returns ``state``, or ``(state, meta)`` with ``with_meta`` (meta ``{}``
    when the sidecar is absent).
    """
    ckpt = _load(ckpt_dir, epoch, state.model)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    for name in _counters(state):
        setattr(state, name, int(ckpt[name]))
    if not with_meta:
        return state
    meta = {}
    meta_path = _meta_file(ckpt_dir, epoch)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def restore_weights(ckpt_dir: str, epoch: int, model) -> None:
    """Load only the model's weights and BN running stats of ``epoch``
    (a warm start: the caller keeps its fresh optimizer and schedule)."""
    model.load_state_dict(_load(ckpt_dir, epoch, model)["model"])


def _epochs(ckpt_dir: str, ext: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for fn in os.listdir(ckpt_dir)
            if (m := re.fullmatch(rf"model_epoch(\d+)\.{ext}", fn))]


def latest_epoch(ckpt_dir: str) -> int | None:
    """Largest epoch with a checkpoint file, or None."""
    epochs = _epochs(ckpt_dir, "pt")
    return max(epochs) if epochs else None


def latest_meta_epoch(ckpt_dir: str, at_or_below: int | None = None
                      ) -> int | None:
    """Largest epoch with a meta sidecar (optionally capped), or None.

    A kill between the two atomic writes can leave the newest ``.pt``
    without its ``.json``; history readers fall back to the newest sidecar.
    """
    epochs = _epochs(ckpt_dir, "json")
    if at_or_below is not None:
        epochs = [e for e in epochs if e <= at_or_below]
    return max(epochs) if epochs else None


def select_consistency_epoch(history) -> tuple[int, float] | None:
    """Argmin over finite ``(epoch, consistency)`` records, or None: the
    label-free checkpoint-selection rule (lowest flux-pressure consistency).
    """
    finite = [(int(e), float(c)) for e, c in history if math.isfinite(c)]
    return min(finite, key=lambda t: t[1]) if finite else None

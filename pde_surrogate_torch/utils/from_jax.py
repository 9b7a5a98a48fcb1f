"""Move weights from the JAX package's flax trees into the port.

The codec (DenseED and the solver's Decoder) is the reverse of
``pde_surrogate_tpu/utils/torch_import.convert_codec_state_dict``: nested
dicts of numpy arrays (flax ``params`` and ``batch_stats``) become a torch
``state_dict`` with the reference module names.  The CPPNs keep the flax
layer names, and a Dense ``kernel`` (in, out) becomes a ``weight``
(out, in).  The conditional Glow keeps the flax module names too
(``glow_state_dict_from_jax``).  Imports nothing of the JAX package; the
parity tests use it to run both models on the same weights.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["codec_state_dict_from_jax", "cppn_state_dict_from_jax",
           "glow_state_dict_from_jax"]

# flax module names are the reference names lowercased
_TOP = [(re.compile(r"in_conv$"), lambda m: "In_conv"),
        (re.compile(r"conv0$"), lambda m: "Conv0"),
        (re.compile(r"encblock(\d+)$"), lambda m: f"EncBlock{m.group(1)}"),
        (re.compile(r"decblock(\d+)$"), lambda m: f"DecBlock{m.group(1)}"),
        (re.compile(r"transdown(\d+)$"), lambda m: f"TransDown{m.group(1)}"),
        (re.compile(r"transup(\d+)$"), lambda m: f"TransUp{m.group(1)}"),
        (re.compile(r"lasttransup$"), lambda m: "LastTransUp")]


def _torch_module_name(path: list[str]) -> str:
    top = path[0]
    for pat, fmt in _TOP:
        m = pat.match(top)
        if m:
            return ".".join(["features", fmt(m), *path[1:]])
    raise ValueError(f"unrecognized flax module: {'/'.join(path)}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield list(prefix), str(k), np.asarray(v)


def codec_state_dict_from_jax(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax (params, batch_stats) of a DenseED or Decoder -> torch
    state_dict.

    Conv kernels (kH, kW, I, O) -> weight (O, I, kH, kW); BN ``scale`` /
    ``bias`` -> ``weight`` / ``bias``; ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var`` (plus ``num_batches_tracked`` 0).
    """
    sd: dict[str, torch.Tensor] = {}
    for path, leaf, value in _flatten(params):
        name = _torch_module_name(path)
        if path[-1].startswith("convT"):
            raise ValueError(f"transposed convs are not ported: {name}")
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            sd[f"{name}.weight"] = torch.from_numpy(value.copy())
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(value.copy())
        else:
            raise ValueError(f"unrecognized flax param: {name}/{leaf}")
    for path, leaf, value in _flatten(batch_stats):
        name = _torch_module_name(path)
        key = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if key is None:
            raise ValueError(f"unrecognized flax batch stat: {name}/{leaf}")
        sd[f"{name}.{key}"] = torch.from_numpy(value.copy())
        sd.setdefault(f"{name}.num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    return sd


def glow_state_dict_from_jax(params, batch_stats,
                             constants) -> dict[str, torch.Tensor]:
    """flax (params, batch_stats, constants) of a MultiScaleCondGlow ->
    torch state_dict.  The port's glow modules carry the flax names joined
    by dots; conv kernels (kH, kW, I, O) -> weight (O, I, kH, kW); a
    BatchNorm's ``scale`` -> ``weight`` and its ``mean`` / ``var`` -> the
    running buffers; every other leaf (ActNorm ``weight`` / ``bias``,
    ``Conv2dZeros.scale``, the 1x1 convs' ``weight``, ``l``, ``u``,
    ``log_s``, and the constants ``p`` / ``sign_s``) keeps its name and
    shape."""
    sd: dict[str, torch.Tensor] = {}
    bn = {".".join(path) for path, _, _ in _flatten(batch_stats)}
    for path, leaf, value in _flatten(params):
        name = ".".join(path)
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale" and name in bn:
            leaf = "weight"
        sd[".".join([*path, leaf])] = torch.from_numpy(np.array(value))
    for path, leaf, value in _flatten(batch_stats):
        name = ".".join(path)
        key = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if key is None:
            raise ValueError(f"unrecognized flax batch stat: {name}/{leaf}")
        sd[f"{name}.{key}"] = torch.from_numpy(value.copy())
        sd.setdefault(f"{name}.num_batches_tracked",
                      torch.tensor(0, dtype=torch.long))
    for path, leaf, value in _flatten(constants):
        sd[".".join([*path, leaf])] = torch.from_numpy(value.copy())
    return sd


def cppn_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """flax params of a CPPN / ResCPPN -> torch state_dict: the same layer
    names joined by dots, Dense ``kernel`` (in, out) -> ``weight``
    (out, in), ``bias`` as is."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf, value in _flatten(params):
        name = ".".join(path)
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(value.T))
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(value.copy())
        else:
            raise ValueError(f"unrecognized flax param: {name}/{leaf}")
    return sd

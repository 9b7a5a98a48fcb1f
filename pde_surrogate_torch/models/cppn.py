"""Compositional pattern-producing networks (the PINN-style solver nets).

Counterpart of pde_surrogate_tpu/models/cppn.py (the reference's CPPN /
ResCPPN, models/cppn.py:11-106): an MLP from spatial coordinates (y, x) in
[0, 1]^2 to the solution fields (u, tau_ver, tau_hor).  The layer names are
the JAX package's (``fc0`` ... ``fc{L}``, ``reslayer{i}.fc1/fc2``,
``fc_last``), so ``utils/from_jax.cppn_state_dict_from_jax`` moves flax
weights in by name.  ``fc0`` has no bias.

Init as the JAX package's (flax ``xavier_normal``): weights from a normal
truncated at two standard deviations, scaled to the Glorot variance
2 / (fan_in + fan_out); biases zero.  ``nn.Linear``'s own init differs, so
every layer is re-initialised.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["CPPN", "ResCPPN", "ResLayer", "fc_model_size"]

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def fc_model_size(model: nn.Module) -> tuple[int, int]:
    """(n_params, n_fc_params): parameters whose name holds 'fc' are counted
    (reference models/cppn.py:45-51, the JAX package's count)."""
    n_params, n_fc = 0, 0
    for name, p in model.named_parameters():
        if "fc" in name.lower():
            n_fc += 1
        n_params += p.numel()
    return n_params, n_fc


def _dense(din: int, dout: int, bias: bool = True) -> nn.Linear:
    layer = nn.Linear(din, dout, bias=bias)
    std = math.sqrt(2.0 / (din + dout)) / _TRUNC_STD
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _act(name: str):
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation function: {name}")


class CPPN(nn.Module):
    """(N, dim_in) coordinates -> (N, dim_out) fields
    (reference models/cppn.py:11-51)."""

    def __init__(self, dim_in: int = 2, dim_out: int = 3,
                 dim_hidden: int = 512, layers_hidden: int = 8,
                 act: str = "tanh"):
        super().__init__()
        self.act = _act(act)
        self.layers_hidden = layers_hidden
        self.add_module("fc0", _dense(dim_in, dim_hidden, bias=False))
        for i in range(1, layers_hidden):
            self.add_module(f"fc{i}", _dense(dim_hidden, dim_hidden))
        self.add_module(f"fc{layers_hidden}", _dense(dim_hidden, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        x = torch.tanh(layers[0](x))
        for layer in layers[1:-1]:
            x = self.act(layer(x))
        return layers[-1](x)


class ResLayer(nn.Module):
    """Pre-activation residual FC block (reference models/cppn.py:70-85)."""

    def __init__(self, dim_hidden: int, act: str = "tanh"):
        super().__init__()
        self.act = _act(act)
        self.fc1 = _dense(dim_hidden, dim_hidden)
        self.fc2 = _dense(dim_hidden, dim_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(self.act(self.fc1(self.act(x))))


class ResCPPN(nn.Module):
    """Residual CPPN variant (reference models/cppn.py:87-106)."""

    def __init__(self, dim_in: int = 2, dim_out: int = 1,
                 dim_hidden: int = 64, res_layers: int = 3,
                 act: str = "tanh"):
        super().__init__()
        self.act = _act(act)
        self.fc0 = _dense(dim_in, dim_hidden, bias=False)
        for i in range(res_layers):
            self.add_module(f"reslayer{i + 1}", ResLayer(dim_hidden, act))
        self.fc_last = _dense(dim_hidden, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        for layer in layers[:-1]:
            x = layer(x)
        return self.fc_last(self.act(x))

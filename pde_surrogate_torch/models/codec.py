"""Dense convolutional encoder-decoder (DenseED) and the solver's Decoder,
NCHW.

Counterpart of pde_surrogate_tpu/models/codec.py (DenseED, Decoder and
their parts),
with the reference's torch module names (``features.In_conv``,
``features.EncBlock1.denselayer1.norm1``, ..., ``features.LastTransUp.conv3``)
so that reference ``.pth`` state dicts load by name.

* Channel bookkeeping: +num_layers*growth per dense block, //2 per
  transition; in-conv padding 3 for even imsize, 2 for odd.
* Conv weights use torch's default init, which is the JAX package's
  ``torch_conv_init`` (U(+-1/sqrt(fan_in))); convs have no bias.
* BatchNorm: eps 1e-5, momentum 0.1, and the running variance folds in the
  BIASED batch variance, as flax's BatchNorm does (``BatchNorm2d`` below).
* The JAX trainer's default ``shared_stats`` dense block computes the same
  batch statistics as plain BN, so the port implements the plain form.
  ``concat_free``, ``remat`` and ``bottleneck`` dense layers are not ported.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["DenseED", "Decoder", "BatchNorm2d", "module_size",
           "upsample_nearest", "upsample_bilinear"]


def module_size(model: nn.Module) -> tuple[int, int]:
    """(n_params, n_conv_layers): conv layers counted by 'conv' in the
    parameter name (reference models/codec.py:14-21)."""
    n_params, n_conv = 0, 0
    for name, p in model.named_parameters():
        if "conv" in name.lower():
            n_conv += 1
        n_params += p.numel()
    return n_params, n_conv


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) whose running variance
    folds in the biased batch variance, as flax does.

    torch folds the unbiased variance (m/(m-1) times the biased one, m =
    N*H*W).  Normalisation itself uses the biased variance in both.  This
    module keeps torch's fused batch norm and corrects the update of the
    (C,)-sized running buffer afterwards: of the momentum share torch
    added, (m-1)/m is kept.  The fused op updates copies of the buffers,
    because its backward holds on to the ones it was given.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        m = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(kept + (var - kept) * ((m - 1) / m))
            self.running_mean.copy_(mean)
            self.num_batches_tracked.add_(1)
        return y


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling (torch UpsamplingNearest2d)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear x2 upsampling with align_corners=True."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)


_UPSAMPLE = {"nearest": upsample_nearest, "bilinear": upsample_bilinear}


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class DenseLayer(nn.Module):
    """BN -> ReLU -> 3x3 conv; output is the input with the new growth
    channels concatenated (reference models/codec.py:43-75)."""

    def __init__(self, in_features: int, growth_rate: int,
                 drop_rate: float = 0.0):
        super().__init__()
        self.norm1 = BatchNorm2d(in_features)
        self.conv1 = _conv(in_features, growth_rate, 3, padding=1)
        self.drop_rate = drop_rate

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        if self.drop_rate > 0:
            y = F.dropout(y, self.drop_rate, self.training)
        return torch.cat([x, y], dim=1)


class DenseBlock(nn.Module):
    """Cascade of DenseLayers (reference models/codec.py:78-86)."""

    def __init__(self, num_layers: int, in_features: int, growth_rate: int,
                 drop_rate: float = 0.0):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                in_features + i * growth_rate, growth_rate, drop_rate))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class Transition(nn.Module):
    """Down (1x1 conv, strided 3x3 conv) or up (1x1 conv, upsample, 3x3
    conv) transition with the reference's bottleneck (models/codec.py:89-160).

    ``bottleneck=False`` (down only, the glow encoder's first transition):
    BN -> ReLU -> strided 3x3 ``conv1``.
    """

    def __init__(self, in_features: int, out_features: int, down: bool,
                 drop_rate: float = 0.0, upsample: str = "nearest",
                 bottleneck: bool = True):
        super().__init__()
        if not (bottleneck or down):
            raise ValueError("up transitions without the bottleneck (a "
                             "transposed conv) are not ported")
        self.down = down
        self.bottleneck = bottleneck
        self.drop_rate = drop_rate
        self.upsample = _UPSAMPLE[upsample]
        self.norm1 = BatchNorm2d(in_features)
        if not bottleneck:
            self.conv1 = _conv(in_features, out_features, 3, stride=2,
                               padding=1)
            return
        self.conv1 = _conv(in_features, out_features, 1)
        self.norm2 = BatchNorm2d(out_features)
        if down:
            self.conv2 = _conv(out_features, out_features, 3, stride=2,
                               padding=1)
        else:
            self.conv2 = _conv(out_features, out_features, 3, padding=1)

    def forward(self, x):
        x = self.conv1(F.relu(self.norm1(x)))
        if self.bottleneck:
            x = F.relu(self.norm2(x))
            if not self.down:
                x = self.upsample(x)
            x = self.conv2(x)
        if self.drop_rate > 0:
            x = F.dropout(x, self.drop_rate, self.training)
        return x


class LastDecoding(nn.Module):
    """Final up-transition emitting the predictions
    (reference models/codec.py:163-188)."""

    def __init__(self, in_features: int, out_channels: int,
                 drop_rate: float = 0.0, upsample: str = "nearest"):
        super().__init__()
        self.drop_rate = drop_rate
        self.upsample = _UPSAMPLE[upsample]
        self.norm1 = BatchNorm2d(in_features)
        self.conv1 = _conv(in_features, in_features // 2, 3, padding=1)
        self.norm2 = BatchNorm2d(in_features // 2)
        self.conv2 = _conv(in_features // 2, in_features // 4, 3, padding=1)
        self.norm3 = BatchNorm2d(in_features // 4)
        self.conv3 = _conv(in_features // 4, out_channels, 5, padding=2)

    def forward(self, x):
        x = self.conv1(F.relu(self.norm1(x)))
        if self.drop_rate > 0:
            x = F.dropout(x, self.drop_rate, self.training)
        x = self.upsample(F.relu(self.norm2(x)))
        x = self.conv2(x)
        return self.conv3(F.relu(self.norm3(x)))


def _add_decoder(mods: OrderedDict, nf: int, blocks: Sequence[int],
                 out_channels: int, growth_rate: int, drop_rate: float,
                 upsample: str) -> None:
    """Append the decoding half to ``mods``: dense blocks (``DecBlock{i}``)
    with an up transition between each pair (``TransUp{i}``), then the
    decoding head (``LastTransUp``); ``nf`` channels come in."""
    if upsample not in _UPSAMPLE:
        raise ValueError(f"unknown upsample mode: {upsample}")
    for i, num_layers in enumerate(blocks):
        mods[f"DecBlock{i + 1}"] = DenseBlock(num_layers, nf, growth_rate,
                                              drop_rate)
        nf += num_layers * growth_rate
        if i < len(blocks) - 1:
            mods[f"TransUp{i + 1}"] = Transition(
                nf, nf // 2, down=False, drop_rate=drop_rate,
                upsample=upsample)
            nf //= 2
    mods["LastTransUp"] = LastDecoding(nf, out_channels, drop_rate=drop_rate,
                                       upsample=upsample)


class DenseED(nn.Module):
    """Dense convolutional encoder-decoder (reference models/codec.py:210-318).

    ``blocks`` has odd length: the first half are encoder dense blocks (each
    followed by a down transition), the rest decoder blocks (each but the
    last followed by an up transition), then the decoding head.
    Input (B, in_channels, H, W) -> output (B, out_channels, H, W).
    """

    def __init__(self, in_channels: int, out_channels: int, imsize: int,
                 blocks: Sequence[int], growth_rate: int = 16,
                 init_features: int = 48, drop_rate: float = 0.0,
                 upsample: str = "nearest"):
        super().__init__()
        blocks = list(blocks)
        if len(blocks) > 1 and len(blocks) % 2 == 0:
            raise ValueError(
                f"length of blocks must be an odd number, but got {len(blocks)}")
        enc_blocks = blocks[: len(blocks) // 2]
        dec_blocks = blocks[len(blocks) // 2:]
        pad = 3 if imsize % 2 == 0 else 2
        mods = OrderedDict(In_conv=_conv(in_channels, init_features, 7,
                                         stride=2, padding=pad))
        nf = init_features
        for i, num_layers in enumerate(enc_blocks):
            mods[f"EncBlock{i + 1}"] = DenseBlock(num_layers, nf, growth_rate,
                                                  drop_rate)
            nf += num_layers * growth_rate
            mods[f"TransDown{i + 1}"] = Transition(nf, nf // 2, down=True,
                                                   drop_rate=drop_rate)
            nf //= 2
        _add_decoder(mods, nf, dec_blocks, out_channels, growth_rate,
                     drop_rate, upsample)
        self.features = nn.Sequential(mods)

    def forward(self, x):
        return self.features(x)


class Decoder(nn.Module):
    """Decoder-only generator for solving one instance (reference
    models/codec.py:321-370, JAX models/codec.py:589-629).

    A fixed latent (B, dim_latent, h, w) goes through a 3x3 conv
    (``features.Conv0``), dense blocks with an up transition between each
    pair (``DecBlock{i}``, ``TransUp{i}``) and the decoding head
    (``LastTransUp``) to (B, out_channels, 4h, 4w) for two blocks; only the
    weights are optimized.
    """

    def __init__(self, dim_latent: int, out_channels: int,
                 blocks: Sequence[int], growth_rate: int = 16,
                 init_features: int = 48, drop_rate: float = 0.0,
                 upsample: str = "nearest"):
        super().__init__()
        mods = OrderedDict(Conv0=_conv(dim_latent, init_features, 3,
                                       padding=1))
        _add_decoder(mods, init_features, list(blocks), out_channels,
                     growth_rate, drop_rate, upsample)
        self.features = nn.Sequential(mods)

    def forward(self, x):
        return self.features(x)

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
  batch statistics as plain BN, so the plain path keeps per-layer BN; the
  shared per-group moments live only on the ``concat_free`` path.
* DenseED's options, as the JAX DenseED's: ``dtype`` (torch.bfloat16:
  parameters stay f32, convolutions and BN outputs are bf16, BN statistics
  are reduced in f32, the output is f32), ``concat_free`` (per-group batch
  moments computed once, group-by-group norm, the 3x3 conv as a sum of
  sliced-kernel convs accumulated in f32; same state dict), ``remat``
  (activation checkpointing per dense block; the running statistics fold
  once per step) and ``bottleneck`` dense layers (BN-ReLU-1x1 conv to
  ``bn_size * growth``, then BN-ReLU-3x3, where the input is wider).
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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

    A bf16 input is normalised with f32 statistics and parameters and comes
    out bf16.  ``fold_stats`` False (a rematerialised forward) normalises
    with the batch statistics and leaves the running buffers alone.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.fold_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        m = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        if self.fold_stats:
            with torch.no_grad():
                kept = self.running_var * (1.0 - self.momentum)
                self.running_var.copy_(kept + (var - kept) * ((m - 1) / m))
                self.running_mean.copy_(mean)
                self.num_batches_tracked.add_(1)
        return y

    def fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold externally computed batch moments (the biased variance)
        into the running buffers, as ``forward`` folds its own."""
        if not self.fold_stats:
            return
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var
                                   + self.momentum * var)
            self.num_batches_tracked.add_(1)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling (torch UpsamplingNearest2d)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Bilinear x2 upsampling with align_corners=True."""
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=True)


_UPSAMPLE = {"nearest": upsample_nearest, "bilinear": upsample_bilinear}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: f32 weights are cast
    to bf16 for a bf16 input (flax's ``nn.Conv(dtype=bfloat16)``)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


def _batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) over (N, H, W), reduced in f32.

    The variance is centred (``torch.var_mean``), as the port's
    ``BatchNorm2d`` computes it.  The JAX package's E[x^2] - E[x]^2 (its
    ``_batch_moments``) cancels where the mean is large against the spread:
    in its place the concat-free gradient of DenseED [6,8,6]/16/48 lies
    7.2e-4 rel-L2 from the concat path's, against 1.3e-6 centred
    (tools/codec_bf16_probe.py)."""
    var, mu = torch.var_mean(x.to(torch.promote_types(x.dtype,
                                                      torch.float32)),
                             dim=(0, 2, 3), unbiased=False)
    return mu, var


class DenseLayer(nn.Module):
    """BN -> ReLU -> 3x3 conv; output is the input with the new growth
    channels concatenated (reference models/codec.py:43-75).

    ``bottleneck`` with more than ``bn_size * growth_rate`` input channels:
    BN -> ReLU -> 1x1 ``conv1`` to ``bn_size * growth_rate`` channels, then
    BN (``norm2``) -> ReLU -> 3x3 ``conv2``.
    """

    def __init__(self, in_features: int, growth_rate: int,
                 drop_rate: float = 0.0, bn_size: int = 8,
                 bottleneck: bool = False):
        super().__init__()
        self.norm1 = BatchNorm2d(in_features)
        self.drop_rate = drop_rate
        self.bottleneck = bottleneck and in_features > bn_size * growth_rate
        if self.bottleneck:
            self.conv1 = _conv(in_features, bn_size * growth_rate, 1)
            self.norm2 = BatchNorm2d(bn_size * growth_rate)
            self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3,
                               padding=1)
        else:
            self.conv1 = _conv(in_features, growth_rate, 3, padding=1)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        if self.bottleneck:
            y = self.conv2(F.relu(self.norm2(y)))
        if self.drop_rate > 0:
            y = F.dropout(y, self.drop_rate, self.training)
        return torch.cat([x, y], dim=1)

    def forward_groups(self, groups, moments):
        """The layer's new growth channels from a list of feature groups
        whose concatenation is its input, without forming it: ``norm1``
        normalises each group with its slice of the parameters and of the
        statistics (in training, the groups' batch ``moments``, folded into
        the running buffers here), and ``conv1`` is the sum over groups of
        convs with the matching kernel slices.  Each partial conv takes
        operands rounded to the groups' dtype but runs and accumulates in
        f32, and the sum is rounded once, as JAX's ``_conv3x3_f32acc``: a
        bf16 conv per group would round every partial."""
        norm = self.norm1
        if self.training:
            mean = torch.cat([m for m, _ in moments])
            var = torch.cat([v for _, v in moments])
            norm.fold(mean, var)
        else:
            mean, var = norm.running_mean, norm.running_var
        mul = torch.rsqrt(var + norm.eps) * norm.weight
        weight = self.conv1.weight
        acc = torch.promote_types(groups[0].dtype, torch.float32)
        out, start = None, 0
        for g in groups:
            end = start + g.shape[1]
            y = ((g.to(acc) - mean[start:end, None, None])
                 * mul[start:end, None, None] + norm.bias[start:end, None, None])
            y = F.relu(y.to(g.dtype)).to(acc)
            k = weight[:, start:end].to(g.dtype).to(acc)
            o = F.conv2d(y, k, padding=1)
            out = o if out is None else out + o
            start = end
        out = out.to(groups[0].dtype)
        if self.drop_rate > 0:
            out = F.dropout(out, self.drop_rate, self.training)
        return out


class DenseBlock(nn.Module):
    """Cascade of DenseLayers (reference models/codec.py:78-86).

    ``concat_free``: the layers take the list of groups produced so far
    (``DenseLayer.forward_groups``), each group's batch moments are reduced
    once, when it is produced, and only the block's output is concatenated
    (JAX ``DenseBlock._call_shared`` with ``DenseLayerConcatFree``).
    ``remat``: in training, the block's activations are recomputed in the
    backward pass (``torch.utils.checkpoint``, dropout's RNG replayed); the
    recomputation folds no running statistics, so they move once per step.
    """

    def __init__(self, num_layers: int, in_features: int, growth_rate: int,
                 drop_rate: float = 0.0, bn_size: int = 8,
                 bottleneck: bool = False, concat_free: bool = False,
                 remat: bool = False):
        super().__init__()
        if concat_free and bottleneck:
            raise ValueError("concat_free does not support bottleneck layers")
        self.concat_free = concat_free
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                in_features + i * growth_rate, growth_rate, drop_rate,
                bn_size, bottleneck))

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._forward, x, use_reentrant=False,
                              context_fn=self._remat_contexts)
        return self._forward(x)

    def _forward(self, x):
        if not self.concat_free:
            for layer in self.children():
                x = layer(x)
            return x
        groups = [x]
        moments = [_batch_moments(x)] if self.training else None
        for layer in self.children():
            g = layer.forward_groups(groups, moments)
            groups.append(g)
            if self.training:
                moments.append(_batch_moments(g))
        return torch.cat(groups, dim=1)

    def _remat_contexts(self):
        return contextlib.nullcontext(), self._stats_frozen()

    @contextlib.contextmanager
    def _stats_frozen(self):
        norms = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        for m in norms:
            m.fold_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.fold_stats = True


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
                 upsample: str, **block_kw) -> None:
    """Append the decoding half to ``mods``: dense blocks (``DecBlock{i}``,
    built with ``block_kw``) with an up transition between each pair
    (``TransUp{i}``), then the decoding head (``LastTransUp``); ``nf``
    channels come in."""
    if upsample not in _UPSAMPLE:
        raise ValueError(f"unknown upsample mode: {upsample}")
    for i, num_layers in enumerate(blocks):
        mods[f"DecBlock{i + 1}"] = DenseBlock(num_layers, nf, growth_rate,
                                              drop_rate, **block_kw)
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
    Input (B, in_channels, H, W) -> output (B, out_channels, H, W), f32.

    ``dtype`` (None or torch.bfloat16) is the compute dtype: the input is
    cast to it and every conv and BN output follows, while the parameters
    and BN statistics stay f32.  ``bn_size``/``bottleneck``,
    ``concat_free`` and ``remat`` go to the dense blocks (``DenseBlock``);
    none of them changes the state dict's names or shapes except
    ``bottleneck``, which adds the reference's ``norm2``/``conv2``.
    """

    def __init__(self, in_channels: int, out_channels: int, imsize: int,
                 blocks: Sequence[int], growth_rate: int = 16,
                 init_features: int = 48, drop_rate: float = 0.0,
                 upsample: str = "nearest", bn_size: int = 8,
                 bottleneck: bool = False, dtype: torch.dtype | None = None,
                 concat_free: bool = False, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        block_kw = dict(bn_size=bn_size, bottleneck=bottleneck,
                        concat_free=concat_free, remat=remat)
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
                                                  drop_rate, **block_kw)
            nf += num_layers * growth_rate
            mods[f"TransDown{i + 1}"] = Transition(nf, nf // 2, down=True,
                                                   drop_rate=drop_rate)
            nf //= 2
        _add_decoder(mods, nf, dec_blocks, out_channels, growth_rate,
                     drop_rate, upsample, **block_kw)
        self.features = nn.Sequential(mods)

    def forward(self, x):
        if self.dtype is None:
            return self.features(x)
        return self.features(x.to(self.dtype)).float()


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

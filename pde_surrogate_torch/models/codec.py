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
* On a row block (``parallel.mesh.replicate`` under a data x space mesh
  sets every ``Conv2d.rows``): each conv exchanges its halo rows with the
  neighbouring ranks and runs without H-padding (its bias, if any, added
  after), and an upsampling followed by a conv exchanges one
  low-resolution row a side (``parallel/halo.py``).  Without it every
  path is as before.
* Dropout in training draws its masks from the step's generator
  (``dropout_masks``, which the trainers wrap around the forward): the
  global batch's masks, of which each rank keeps its samples and rows,
  as the JAX package's ``fold_in(key(seed), step)``; remat draws them
  again in its recomputation.  A model called outside it drops with
  torch's global RNG, which a mesh refuses.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.halo import (RowShard, block_operator, conv_halo, conv_rows,
                             exchange_rows, upsample_conv_rows,
                             upsample_dtype, upsample_matrix,
                             upsample_operator)
from ..parallel.mesh import all_reduce_sum

__all__ = ["DenseED", "Decoder", "BatchNorm2d", "batch_moments",
           "Conv2d", "MaskSource", "dropout_masks",
           "module_size", "upsample_nearest", "upsample_bilinear"]


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

    With a ``stats_group`` (set by ``parallel.mesh.replicate``) the batch is
    the global one, sharded over the group's ranks, as flax's BatchNorm sees
    it under SPMD: the moments are those of every rank's rows
    (``batch_moments``), the normalisation is differentiated through the
    reduction, and the running buffers fold the global biased variance.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.fold_stats = True
        self.stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.stats_group is not None:
            mean, var = batch_moments(x, self.stats_group)
            self.fold(mean.detach(), var.detach())
            acc = torch.promote_types(x.dtype, torch.float32)
            scale = torch.rsqrt(var + self.eps) * self.weight
            y = ((x.to(acc) - mean[:, None, None]) * scale[:, None, None]
                 + self.bias[:, None, None])
            return y.to(x.dtype)
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
    """Bilinear x2 upsampling with align_corners=True, as a product with
    each axis's interpolation matrix (``upsample_operator``: deterministic
    on CUDA, where ``F.interpolate``'s backward is not), in f32 for a bf16
    input as the JAX package's f32 matrices promote it, returned in
    ``x``'s dtype."""
    h, w = (upsample_operator(n, "bilinear", x.device, x.dtype, scale)
            for n in x.shape[-2:])
    return (h @ x.to(h.dtype) @ w.T).to(x.dtype)


_UPSAMPLE = {"nearest": upsample_nearest, "bilinear": upsample_bilinear}


def _conv2d(x, weight, stride: int, padding: int, rows: RowShard | None,
            bias=None):
    """``F.conv2d`` with symmetric padding, on the whole field or, with
    ``rows``, on this rank's row block (halo rows exchanged; a 1x1 conv
    reads no other rows; the bias added after the block conv)."""
    if rows is None or weight.shape[-2] == 1:
        return F.conv2d(x, weight, bias, stride, padding)
    a, b = conv_halo(weight.shape[-2], stride, padding)
    return conv_rows(x, *exchange_rows(x, a, b, rows), weight, stride,
                     padding, bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: f32 weights are
    cast to bf16 for a bf16 input (flax's ``nn.Conv(dtype=bfloat16)``).
    With ``rows`` set its input is a row block (``parallel/halo.py``);
    ``parallel.mesh.replicate`` sets it on a conv of one group, without
    dilation, with a square stride and padding (the DenseED's and the
    cGlow's)."""

    rows: RowShard | None = None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.rows is None:
            return self._conv_forward(x, w, b)
        return _conv2d(x, w, self.stride[0], self.padding[0], self.rows, b)

    def upsampled(self, x, mode: str):
        """This conv of ``x`` upsampled x2 (``mode``); on a row block one
        low-resolution halo row is exchanged a side and upsampled into the
        rows the conv reads, with the block operators kept per input."""
        if self.rows is None:
            return self(_UPSAMPLE[mode](x))
        p = self.padding[0]
        key = (mode, x.shape[-2], self.rows.index, self.rows.size, x.device,
               x.dtype)
        cache = self.__dict__.setdefault("_row_ops", {})
        if key not in cache:
            op, a, b = block_operator(
                upsample_matrix(x.shape[-2] * self.rows.size, mode),
                self.rows.index, self.rows.size, extra=p)
            cache[key] = (torch.from_numpy(op).to(
                x.device, upsample_dtype(x.dtype)), a, b)
        op, a, b = cache[key]
        y = upsample_conv_rows(x, *exchange_rows(x, a, b, self.rows), op,
                               self.weight.to(x.dtype), mode)
        return y if self.bias is None else y + self.bias.to(x.dtype)[
            :, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class MaskSource:
    """The dropout masks of one training step, drawn from ``generator``
    (``utils/config.make_generator(device, seed, step)``, the JAX
    package's ``fold_in(key(seed), step)``): each dropout call draws a
    uniform mask for the whole fields of the global batch, ``n_data``
    times this rank's samples and ``rows.size`` times its rows, in float32
    whatever the compute dtype, and keeps this rank's samples
    (``data_index``) and rows.  One process, the data mesh and the data x
    space mesh thus drop the same elements of the global batch.  With
    ``record`` the masks handed out are kept in ``drawn``, in call order
    (a rematerialised forward's again), to be checked."""

    def __init__(self, generator: torch.Generator, n_data: int = 1,
                 data_index: int = 0, rows: RowShard | None = None,
                 record: bool = False):
        self.generator = generator
        self.n_data, self.data_index = n_data, data_index
        self.rows = rows
        self.drawn: list[torch.Tensor] | None = [] if record else None

    def keep(self, shape, p: float) -> torch.Tensor:
        """This rank's bool mask of kept elements for an input of
        ``shape`` (N, C, H, W) at drop rate ``p``."""
        n, c, h, w = shape
        s, size = ((0, 1) if self.rows is None
                   else (self.rows.index, self.rows.size))
        u = torch.rand((n * self.n_data, c, h * size, w),
                       generator=self.generator,
                       device=self.generator.device)
        d = self.data_index
        keep = u[d * n:(d + 1) * n, :, s * h:(s + 1) * h] >= p
        if self.drawn is not None:
            self.drawn.append(keep)
        return keep

    @contextlib.contextmanager
    def replay(self, state: torch.Tensor):
        """Draw again from the generator's ``state`` (a rematerialised
        forward), then go on from where the generator was."""
        now = self.generator.get_state()
        self.generator.set_state(state)
        try:
            yield
        finally:
            self.generator.set_state(now)


def _dropout(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s dropout of ``x`` in training: with the step's masks
    (``module.masks``, a ``MaskSource`` set by ``dropout_masks``), else
    ``F.dropout`` from torch's global RNG, which a mesh refuses (its ranks
    would draw the same masks for different samples)."""
    p = module.drop_rate
    if not (p > 0 and module.training):
        return x
    if module.masks is None:
        if module.norm1.stats_group is not None:
            raise ValueError("dropout under a mesh draws its masks from "
                             "the step's generator: wrap the forward in "
                             "models.codec.dropout_masks")
        return F.dropout(x, p, True)
    keep = module.masks.keep(x.shape, p)
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


@contextlib.contextmanager
def dropout_masks(model: nn.Module, seed: int, step: int, mesh=None,
                  record: bool = False):
    """Within the block, every dropout of ``model`` draws its masks from
    one ``MaskSource`` of (``seed``, ``step``), this rank's part of the
    global batch's under ``mesh`` (a data or data x space mesh); yields
    it (None when ``model`` has no dropout)."""
    layers = [m for m in model.modules() if getattr(m, "drop_rate", 0) > 0]
    if not layers:
        yield None
        return
    from ..parallel.mesh import DataSpaceMesh, row_shard
    from ..utils.config import make_generator
    device = next(model.parameters()).device
    if mesh is None:
        n_data, index = 1, 0
    elif isinstance(mesh, DataSpaceMesh):
        n_data, index = mesh.shape[0], mesh.coords[0]
    else:
        n_data, index = mesh.world_size, mesh.rank
    src = MaskSource(make_generator(device, seed, step), n_data, index,
                     row_shard(mesh), record)
    for m in layers:
        m.masks = src
    try:
        yield src
    finally:
        for m in layers:
            m.masks = None


def batch_moments(x: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) over (N, H, W), reduced in f32.

    The variance is centred (``torch.var_mean``), as the port's
    ``BatchNorm2d`` computes it.  The JAX package's E[x^2] - E[x]^2 (its
    ``_batch_moments``) cancels where the mean is large against the spread:
    in its place the concat-free gradient of DenseED [6,8,6]/16/48 lies
    7.2e-4 rel-L2 from the concat path's, against 1.3e-6 centred
    (tools/codec_bf16_probe.py).

    With a process ``group``, the moments of the rows of every rank: each
    rank's (count, mean, centred M2) are gathered by one differentiable
    all-reduce and combined by Chan's parallel formula, so the variance
    stays centred."""
    var, mu = torch.var_mean(x.to(torch.promote_types(x.dtype,
                                                      torch.float32)),
                             dim=(0, 2, 3), unbiased=False)
    if group is None:
        return mu, var
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    count = x.numel() // x.shape[1]
    row = torch.cat([mu.new_full((1,), float(count)), mu, var * count])
    rows = all_reduce_sum(torch.stack(
        [row if r == rank else torch.zeros_like(row) for r in range(world)]),
        group)
    counts, means, m2 = rows[:, :1], rows[:, 1:1 + mu.numel()], \
        rows[:, 1 + mu.numel():]
    total = counts.sum()
    mean = (counts * means).sum(0) / total
    m2 = m2.sum(0) + (counts * (means - mean) ** 2).sum(0)
    return mean, m2 / total


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
        self.masks: MaskSource | None = None
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
        return torch.cat([x, _dropout(self, y)], dim=1)

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
            o = _conv2d(y, k, 1, 1, self.conv1.rows)
            out = o if out is None else out + o
            start = end
        return _dropout(self, out.to(groups[0].dtype))


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
        self.stats_group = None     # the groups' moments over a mesh
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                in_features + i * growth_rate, growth_rate, drop_rate,
                bn_size, bottleneck))

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            masks = next((m.masks for m in self.children()
                          if m.masks is not None), None)
            state = None if masks is None else masks.generator.get_state()
            return checkpoint(self._forward, x, use_reentrant=False,
                              context_fn=lambda: self._remat_contexts(
                                  masks, state))
        return self._forward(x)

    def _forward(self, x):
        if not self.concat_free:
            for layer in self.children():
                x = layer(x)
            return x
        groups = [x]
        moments = ([batch_moments(x, self.stats_group)] if self.training
                   else None)
        for layer in self.children():
            g = layer.forward_groups(groups, moments)
            groups.append(g)
            if self.training:
                moments.append(batch_moments(g, self.stats_group))
        return torch.cat(groups, dim=1)

    def _remat_contexts(self, masks, state):
        return contextlib.nullcontext(), self._recomputing(masks, state)

    @contextlib.contextmanager
    def _recomputing(self, masks, state):
        """The recomputation (in the backward pass, after the step's
        ``dropout_masks`` block may have ended) folds no running
        statistics and, with the step's masks, draws the forward's masks
        again."""
        norms = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        layers = list(self.children())
        before = [m.masks for m in layers]
        for m in norms:
            m.fold_stats = False
        for m in layers:
            m.masks = masks
        try:
            with (contextlib.nullcontext() if masks is None
                  else masks.replay(state)):
                yield
        finally:
            for m in norms:
                m.fold_stats = True
            for m, b in zip(layers, before):
                m.masks = b


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
        self.masks: MaskSource | None = None
        self.upsample = upsample
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
            x = self.conv2(x) if self.down else self.conv2.upsampled(
                x, self.upsample)
        return _dropout(self, x)


class LastDecoding(nn.Module):
    """Final up-transition emitting the predictions
    (reference models/codec.py:163-188)."""

    def __init__(self, in_features: int, out_channels: int,
                 drop_rate: float = 0.0, upsample: str = "nearest"):
        super().__init__()
        self.drop_rate = drop_rate
        self.masks: MaskSource | None = None
        self.upsample = upsample
        self.norm1 = BatchNorm2d(in_features)
        self.conv1 = _conv(in_features, in_features // 2, 3, padding=1)
        self.norm2 = BatchNorm2d(in_features // 2)
        self.conv2 = _conv(in_features // 2, in_features // 4, 3, padding=1)
        self.norm3 = BatchNorm2d(in_features // 4)
        self.conv3 = _conv(in_features // 4, out_channels, 5, padding=2)

    def forward(self, x):
        x = _dropout(self, self.conv1(F.relu(self.norm1(x))))
        x = self.conv2.upsampled(F.relu(self.norm2(x)), self.upsample)
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

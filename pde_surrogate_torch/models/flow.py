"""Normalizing-flow building blocks of the conditional Glow, NCHW.

Counterpart of pde_surrogate_tpu/models/flow.py: one ``nn.Module`` per JAX
class with the same name, and submodules named after the flax variable tree
(``coupling.coupling_nn.denselayer1.norm1``, ``conv1x1.log_s``,
``split.latent_encoder.conv2d.conv``, ...), so that
``utils/from_jax.glow_state_dict_from_jax`` moves weights by name.

* On a row block of a data x space mesh (``parallel.mesh.replicate``)
  the convs are codec ``Conv2d``s with their row form, ``Squeeze`` routes
  rows between the space ranks, ActNorm's data init reads the group's
  moments, and every logdet and log-density is this block's partial sum
  (ActNorm's and the 1x1 convs' count the block's h w pixels).
* Logdets are returned values.  The invertible 1x1 convs return
  +log|det(applied)| forward and -log|det(applied)| in reverse; the affine
  coupling returns +sum(log scale) in both directions; ``Split`` adds the
  prior's log-density in both directions.
* Channel halves follow torch ``chunk(2, dim=1)``: the first half gets the
  extra channel when the count is odd.
* ActNorm's data-dependent init is ``actnorm_init_from_input`` applied in
  ``actnorm_module_paths`` order (glow_trainer.data_init_actnorm).
* Init follows the JAX package: conv kernels U(+-1/sqrt(fan_in)) (torch's
  default, the JAX ``torch_conv_init``), zero biases, zero
  ``Conv2dZeros``, LU factors from the QR of a Gaussian; ``reset_flow_``
  draws them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
import re

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.halo import RowShard
from .codec import BatchNorm2d, Conv2d, DenseLayer, batch_moments

__all__ = ["ActNorm", "InvConv1x1", "InvConv1x1LU", "Conv2dZeros",
           "DenseCoupling", "WideCoupling", "AffineCouplingLayer",
           "RevLayer", "FirstRevLayer", "Squeeze", "GaussianDiag",
           "gaussian_diag", "LatentEncoder", "Split", "RevBlock",
           "squeeze_routes", "squeeze_rows_chunks", "squeeze_rows_assemble",
           "FirstRevBlock", "straight_through_clamp",
           "actnorm_init_from_input", "actnorm_module_paths", "reset_flow_"]

LOG2PI = math.log(2 * math.pi)
_LOGSTD_MIN, _LOGSTD_MAX = -10.0, math.log(5.0)


def straight_through_clamp(x: torch.Tensor, lo: float = _LOGSTD_MIN,
                           hi: float = _LOGSTD_MAX) -> torch.Tensor:
    """Clamped values with the identity gradient."""
    return x + (x.clamp(lo, hi) - x).detach()


def _chunk2(x: torch.Tensor):
    """torch.chunk(2, dim=1) that also splits a single channel as (1, 0)."""
    first = -(-x.shape[1] // 2)
    return x[:, :first], x[:, first:]


def _half_up(n: int) -> int:
    return -(-n // 2)


class ActNorm(nn.Module):
    """Per-channel affine normalization (JAX flow.py:59-85); identity init,
    data init by ``actnorm_init_from_input``."""

    def __init__(self, in_features: int, return_logdet: bool = True):
        super().__init__()
        self.return_logdet = return_logdet
        self.weight = nn.Parameter(torch.ones(in_features))
        self.bias = nn.Parameter(torch.zeros(in_features))
        self.stats_group = None     # the data init's moments over a mesh

    def forward(self, x, reverse: bool = False):
        w, b = self.weight[:, None, None], self.bias[:, None, None]
        y = (x - b) / w if reverse else w * x + b
        if not self.return_logdet:
            return y
        logdet = torch.sum(torch.log(torch.abs(self.weight))) * (
            x.shape[-2] * x.shape[-1])
        return y, logdet


@torch.no_grad()
def actnorm_init_from_input(norm: ActNorm, x: torch.Tensor) -> None:
    """weight = 1/std, bias = -mean/std of the recorded input per channel
    (JAX flow.py:88-121): std Bessel-corrected, plus 1e-6.  With the
    norm's ``stats_group`` (a replica, ``parallel.mesh.replicate``) ``x``
    is this rank's part of the batch, equal in size on every rank, and
    the moments are the whole group's (``codec.batch_moments``)."""
    if norm.stats_group is None:
        mean = x.mean(dim=(0, 2, 3))
        std = x.std(dim=(0, 2, 3), unbiased=True) + 1e-6
    else:
        mean, var = batch_moments(x, norm.stats_group)
        count = x.numel() // x.shape[1] * dist.get_world_size(
            norm.stats_group)
        std = torch.sqrt(var * (count / (count - 1))) + 1e-6
    norm.weight.copy_(1.0 / std)
    norm.bias.copy_(-(mean / std))


def actnorm_module_paths(model: nn.Module) -> list[str]:
    """The ActNorm modules of ``model`` in density-execution order: the
    numeric sort of the (block, layer, ...) indices in their names, as JAX
    flow.py:124-148 sorts its tree keys."""
    names = [n for n, m in model.named_modules() if isinstance(m, ActNorm)]

    def order(name):
        return tuple(int(d) for part in name.split(".")
                     for d in re.findall(r"(\d+)", part))
    return sorted(names, key=order)


def _conv1x1(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """out[o] = sum_c kernel[o, c] x[c] (a 1x1 conv)."""
    return F.conv2d(x, kernel[:, :, None, None])


def _qr_of_gaussian(c: int, generator: torch.Generator | None):
    w = torch.randn(c, c, generator=generator)
    return torch.linalg.qr(w)[0]


class InvConv1x1(nn.Module):
    """Invertible 1x1 conv with a dense weight (JAX flow.py:151-182).

    ``train_sampling=True``: reverse applies the weight, forward its
    inverse.  Init: a random rotation (QR of a Gaussian)."""

    def __init__(self, in_channels: int, train_sampling: bool = True):
        super().__init__()
        self.train_sampling = train_sampling
        self.weight = nn.Parameter(_qr_of_gaussian(in_channels, None))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.weight.copy_(_qr_of_gaussian(self.weight.shape[0], generator))

    def forward(self, x, reverse: bool = False):
        logabsdet = torch.linalg.slogdet(self.weight)[1]
        use_inverse = reverse != self.train_sampling
        kernel = torch.linalg.inv(self.weight) if use_inverse else self.weight
        hw = x.shape[-2] * x.shape[-1]
        log_applied = hw * (-logabsdet if use_inverse else logabsdet)
        logdet = -log_applied if reverse else log_applied
        return _conv1x1(x, kernel), logdet


class InvConv1x1LU(nn.Module):
    """LU-parametrized invertible 1x1 conv (JAX flow.py:185-251).

    W = P L U with L unit-lower-triangular and U = strict upper part +
    diag(sign_s * exp(log_s)); logdet = sum(log_s) * H * W.  ``p`` and
    ``sign_s`` are buffers; ``l``, ``u`` and ``log_s`` are trained.  The
    inverse is two triangular solves."""

    def __init__(self, in_channels: int, train_sampling: bool = True):
        super().__init__()
        self.train_sampling = train_sampling
        p, l, u, sign_s, log_s = self._factor(in_channels, None)
        self.register_buffer("p", p)
        self.l = nn.Parameter(l)
        self.u = nn.Parameter(u)
        self.register_buffer("sign_s", sign_s)
        self.log_s = nn.Parameter(log_s)

    @staticmethod
    def _factor(c: int, generator: torch.Generator | None):
        q = _qr_of_gaussian(c, generator)
        p, l, u = torch.linalg.lu(q)              # q = p @ l @ u
        s = torch.diagonal(u)
        return p, l, torch.triu(u, 1), torch.sign(s), torch.log(torch.abs(s))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for t, v in zip((self.p, self.l, self.u, self.sign_s, self.log_s),
                        self._factor(self.l.shape[0], generator)):
            t.copy_(v)

    def _factors(self):
        eye = torch.eye(self.l.shape[0], dtype=self.l.dtype,
                        device=self.l.device)
        l = torch.tril(self.l, -1) + eye
        u = torch.triu(self.u, 1) + torch.diag(torch.exp(self.log_s)
                                               * self.sign_s)
        return l, u, eye

    def forward(self, x, reverse: bool = False):
        ld0 = torch.sum(self.log_s) * (x.shape[-2] * x.shape[-1])
        use_inverse = reverse != self.train_sampling
        l, u, eye = self._factors()
        if use_inverse:
            # (P L U)^-1 = U^-1 L^-1 P^T
            linv = torch.linalg.solve_triangular(l, eye, upper=False,
                                                 unitriangular=True)
            uinv = torch.linalg.solve_triangular(u, eye, upper=True)
            kernel = uinv @ linv @ self.p.T
        else:
            kernel = self.p @ l @ u
        log_applied = -ld0 if use_inverse else ld0
        logdet = -log_applied if reverse else log_applied
        return _conv1x1(x, kernel), logdet


class Conv2dZeros(nn.Module):
    """Zero-init 3x3 conv scaled by exp(3 * scale) (JAX flow.py:254-265)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1)
        self.scale = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.conv.weight.zero_()
        self.conv.bias.zero_()
        self.scale.zero_()

    def forward(self, x):
        return self.conv(x) * torch.exp(self.scale * 3.0)[:, None, None]


class DenseCoupling(nn.Module):
    """Dense-block coupling net (JAX flow.py:268-286): ``num_layers``
    DenseLayers (growth 16), then BN-ReLU-Conv2dZeros."""

    def __init__(self, in_features: int, out_features: int,
                 num_layers: int = 3, growth_rate: int = 16,
                 drop_rate: float = 0.0):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(
                in_features + i * growth_rate, growth_rate, drop_rate))
        nf = in_features + num_layers * growth_rate
        self.norm1 = BatchNorm2d(nf)
        self.conv_zero = Conv2dZeros(nf, out_features)
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"denselayer{i + 1}")(x)
        return self.conv_zero(F.relu(self.norm1(x)))


class WideCoupling(nn.Module):
    """Width-128 conv coupling net with ActNorms (JAX flow.py:289-306)."""

    def __init__(self, in_features: int, out_features: int, width: int = 128):
        super().__init__()
        self.conv1 = Conv2d(in_features, width, 3, padding=1, bias=False)
        self.norm1 = ActNorm(width, return_logdet=False)
        self.conv2 = Conv2d(width, width, 1, bias=False)
        self.norm2 = ActNorm(width, return_logdet=False)
        self.conv3 = Conv2dZeros(width, out_features)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = F.relu(self.norm2(self.conv2(x)))
        return self.conv3(x)


class AffineCouplingLayer(nn.Module):
    """Conditional affine coupling (JAX flow.py:309-334): x1 passes, x2 is
    shifted and scaled by h = net(cat(x1, cond)), shift = h[0::2],
    scale = sigmoid(h[1::2] + 2); logdet = sum(log scale) both ways."""

    def __init__(self, in_features: int, cond_features: int,
                 coupling_net: str = "dense"):
        super().__init__()
        if coupling_net not in ("dense", "wide"):
            raise ValueError(f"unknown coupling net: {coupling_net}")
        out_channels = in_features if in_features % 2 == 0 \
            else in_features - 1
        net_cls = DenseCoupling if coupling_net == "dense" else WideCoupling
        self.coupling_nn = net_cls(_half_up(in_features) + cond_features,
                                   out_channels)

    def forward(self, x, cond, reverse: bool = False):
        x1, x2 = _chunk2(x)
        h = self.coupling_nn(torch.cat([x1, cond], dim=1))
        shift = h[:, 0::2]
        scale = torch.sigmoid(h[:, 1::2] + 2.0)
        x2 = x2 / scale - shift if reverse else (x2 + shift) * scale
        logdet = torch.log(scale).reshape(x.shape[0], -1).sum(dim=1)
        return torch.cat([x1, x2], dim=1), logdet


class RevLayer(nn.Module):
    """ActNorm -> invertible 1x1 conv -> coupling (JAX flow.py:337-359)."""

    def __init__(self, in_features: int, cond_features: int,
                 LU_decompose: bool = True, train_sampling: bool = True,
                 coupling_net: str = "dense"):
        super().__init__()
        self.norm = ActNorm(in_features)
        conv_cls = InvConv1x1LU if LU_decompose else InvConv1x1
        self.conv1x1 = conv_cls(in_features, train_sampling)
        self.coupling = AffineCouplingLayer(in_features, cond_features,
                                            coupling_net)

    def forward(self, x, cond, reverse: bool = False):
        if reverse:
            x, ld1 = self.coupling(x, cond, reverse=True)
            x, ld2 = self.conv1x1(x, reverse=True)
            x, ld3 = self.norm(x, reverse=True)
        else:
            x, ld1 = self.norm(x)
            x, ld2 = self.conv1x1(x)
            x, ld3 = self.coupling(x, cond)
        return x, ld1 + ld2 + ld3


class FirstRevLayer(nn.Module):
    """Coupling only, the flow's entry layer (JAX flow.py:362-371)."""

    def __init__(self, in_features: int, cond_features: int,
                 coupling_net: str = "dense"):
        super().__init__()
        self.coupling = AffineCouplingLayer(in_features, cond_features,
                                            coupling_net)

    def forward(self, x, cond, reverse: bool = False):
        return self.coupling(x, cond, reverse=reverse)


def squeeze_routes(f: int, size: int, index: int, reverse: bool = False):
    """Where the reference-order squeeze sends and finds the row chunks of
    block ``index`` of ``size`` (a field split along H), by ``factor`` f.

    The reference squeeze gathers the f coarse tiles of H/f rows into
    channels.  Forward: block r cuts its h rows into f chunks of h/f
    rows, chunk k being the (f r + k)-th of the field's f P; chunk m is
    row block m mod P of tile m // P, so it goes to block m mod P as that
    tile, and block q takes tile s1 from chunk s1 P + q.  ``reverse`` goes
    back.  Returns ``(sends, takes)``: ``sends[k] = (block, slot)``, where
    this block's chunk k goes and in which slot there; ``takes[j] =
    (block, chunk)``, whose chunk fills this block's slot j."""
    if reverse:
        sends = [((s1 * size + index) // f, (s1 * size + index) % f)
                 for s1 in range(f)]
        takes = [((f * index + k) % size, (f * index + k) // size)
                 for k in range(f)]
    else:
        sends = [((f * index + k) % size, (f * index + k) // size)
                 for k in range(f)]
        takes = [((s1 * size + index) // f, (s1 * size + index) % f)
                 for s1 in range(f)]
    return sends, takes


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` along dim 0, ``in_splits`` rows to each
    rank and ``out_splits`` from each; backward sends the gradient the
    way back (a permutation's inverse)."""

    @staticmethod
    def forward(ctx, x, in_splits, out_splits, group):
        ctx.splits, ctx.group = (in_splits, out_splits), group
        out = x.new_empty((sum(out_splits),) + x.shape[1:])
        dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits,
                               group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        grad = g.new_empty((sum(in_splits),) + g.shape[1:])
        dist.all_to_all_single(grad, g.contiguous(), in_splits, out_splits,
                               group=ctx.group)
        return grad, None, None, None


def _route_chunks(chunks: torch.Tensor, rows: RowShard, f: int,
                  reverse: bool) -> torch.Tensor:
    """Send chunk k of ``chunks`` (f, ...) where ``squeeze_routes`` says,
    in one all-to-all over the space group; returns the chunks this block
    takes, (f, ...) in slot order.  The all-to-all orders what a rank
    sends by destination and what it receives by source; one peer's
    chunks keep their order, which is that of their slots."""
    sends, takes = squeeze_routes(f, rows.size, rows.index, reverse)
    order = sorted(range(f), key=lambda k: sends[k][0])
    got = sorted(range(f), key=lambda j: takes[j][0])
    peers = range(rows.size)
    out = _AllToAll.apply(chunks[order],
                          [sum(d == r for d, _ in sends) for r in peers],
                          [sum(s == r for s, _ in takes) for r in peers],
                          rows.group)
    return out[[got.index(j) for j in range(f)]]


def squeeze_rows_chunks(x: torch.Tensor, f: int, reverse: bool
                        ) -> torch.Tensor:
    """The f chunks (f, B, C', h', W') that a row block of the
    reference-order squeeze's input sends: forward, its h rows cut into f
    row chunks; ``reverse``, the f coarse tiles of its channels."""
    b, c, h, w = x.shape
    if reverse:
        cf = c // (f * f)
        return (x.reshape(b, cf, f, f, h, w).permute(2, 0, 1, 4, 3, 5)
                .reshape(f, b, cf, h, f * w))
    if h % f or w % f:
        raise ValueError(f"squeeze needs a block's H and W divisible by {f}")
    return x.reshape(b, c, f, h // f, w).movedim(2, 0)


def squeeze_rows_assemble(chunks: torch.Tensor, f: int, reverse: bool
                          ) -> torch.Tensor:
    """This block's output from the f chunks it takes, in slot order:
    forward, the tiles s1 (f, B, C, h/f, W) stacked into channels;
    ``reverse``, the row chunks k (f, B, C, h', W) stacked along H."""
    _, b, c, h, w = chunks.shape
    if reverse:
        return chunks.movedim(0, 2).reshape(b, c, f * h, w)
    return (chunks.reshape(f, b, c, h, f, w // f).permute(1, 2, 0, 4, 3, 5)
            .reshape(b, c * f * f, h, w // f))


class Squeeze(nn.Module):
    """Space-to-depth by ``factor`` (JAX flow.py:374-420), NCHW.

    ``order='subpixel'``: channel c*f^2 + fy*f + fx holds the local
    subpixel (fy, fx) — ``F.pixel_unshuffle``.  ``order='reference'``: the
    reference's layout, whose channel c*f^2 + s1*f + s2 holds the coarse
    tile (s1, s2) of the H/f x W/f grid.

    On a row block (``rows``, set by ``parallel.mesh.replicate``) the
    subpixel order is row-local (each block's rows a multiple of f); the
    reference order is a fixed permutation of row chunks among the space
    ranks (``squeeze_routes``): each rank sends and receives one block's
    worth, in one all-to-all whose backward is the inverse permutation.
    """

    def __init__(self, factor: int = 2, order: str = "subpixel"):
        super().__init__()
        if order not in ("subpixel", "reference"):
            raise ValueError(f"Squeeze order must be 'subpixel' or "
                             f"'reference', got {order!r}")
        self.factor = factor
        self.order = order
        self.rows: RowShard | None = None

    def forward(self, x, reverse: bool = False):
        f = self.factor
        if f == 1:
            return x
        b, c, h, w = x.shape
        if self.order == "subpixel":
            return F.pixel_shuffle(x, f) if reverse else F.pixel_unshuffle(x, f)
        if self.rows is not None:
            chunks = _route_chunks(squeeze_rows_chunks(x, f, reverse),
                                   self.rows, f, reverse)
            return squeeze_rows_assemble(chunks, f, reverse)
        if reverse:
            cf = c // (f * f)
            x = x.reshape(b, cf, f, f, h, w).permute(0, 1, 2, 4, 3, 5)
            return x.reshape(b, cf, h * f, w * f)
        if h % f or w % f:
            raise ValueError(f"squeeze needs H, W divisible by {f}")
        x = x.reshape(b, c, f, h // f, f, w // f).permute(0, 1, 2, 4, 3, 5)
        return x.reshape(b, c * f * f, h // f, w // f)


class GaussianDiag:
    """Diagonal Gaussian with the log-stddev clamped straight-through to
    [-10, log 5] (JAX flow.py:423-451)."""

    def __init__(self, mean: torch.Tensor, log_stddev: torch.Tensor):
        self.mean = mean
        self.log_stddev = straight_through_clamp(log_stddev)

    def likelihood(self, x):
        return -0.5 * (LOG2PI + 2.0 * self.log_stddev
                       + (x - self.mean) ** 2 * torch.exp(-2.0 *
                                                          self.log_stddev))

    def log_prob(self, x):
        return self.likelihood(x).reshape(x.shape[0], -1).sum(dim=1)

    def sample(self, eps=None, generator: torch.Generator | None = None):
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_stddev) * eps


def gaussian_diag(mean, log_stddev) -> GaussianDiag:
    return GaussianDiag(mean, log_stddev)


class LatentEncoder(nn.Module):
    """z1 -> (mean, log_stddev) of the split prior (JAX flow.py:454-462):
    a Conv2dZeros from ``input_channels`` to 2 * ``in_channels``."""

    def __init__(self, in_channels: int, input_channels: int | None = None):
        super().__init__()
        self.conv2d = Conv2dZeros(input_channels or in_channels,
                                  in_channels * 2)

    def forward(self, x) -> GaussianDiag:
        return gaussian_diag(*_chunk2(self.conv2d(x)))


class Split(nn.Module):
    """Factor out half the channels under a learned prior (JAX
    flow.py:465-484).  Forward returns (z1, log p(z2), eps or None);
    reverse returns (cat(z, z2), log p(z2)) with z2 drawn from ``eps``."""

    def __init__(self, in_features: int):
        super().__init__()
        self.latent_encoder = LatentEncoder(in_features // 2,
                                            _half_up(in_features))

    def forward(self, z, reverse: bool = False, eps=None,
                generator: torch.Generator | None = None,
                return_eps: bool = False):
        if reverse:
            prior = self.latent_encoder(z)
            z2 = prior.sample(eps=eps, generator=generator)
            return torch.cat([z, z2], dim=1), prior.log_prob(z2)
        z1, z2 = _chunk2(z)
        prior = self.latent_encoder(z1)
        eps_out = None
        if return_eps:
            eps_out = (z2 - prior.mean) * torch.exp(-prior.log_stddev)
        return z1, prior.log_prob(z2), eps_out


class RevBlock(nn.Module):
    """Squeeze -> RevLayers -> Split (JAX flow.py:487-528)."""

    def __init__(self, in_features: int, cond_features: int, n_layers: int,
                 coupling_net: str = "dense", factor: int = 2,
                 LU_decompose: bool = True, train_sampling: bool = True,
                 do_split: bool = True, squeeze_order: str = "subpixel"):
        super().__init__()
        feats = in_features * factor ** 2
        self.squeeze = Squeeze(factor, order=squeeze_order)
        self.revlayers = []
        for i in range(n_layers):
            layer = RevLayer(feats, cond_features, LU_decompose,
                             train_sampling, coupling_net)
            self.add_module(f"revlayer{i + 1}", layer)
            self.revlayers.append(layer)
        self.do_split = do_split
        if do_split:
            self.split = Split(feats)

    def forward(self, x, cond, reverse: bool = False, eps=None,
                generator: torch.Generator | None = None,
                return_eps: bool = False):
        if reverse:
            logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
            y = x
            if self.do_split:
                y, lp = self.split(y, reverse=True, eps=eps,
                                   generator=generator)
                logdet = logdet + lp
            for layer in reversed(self.revlayers):
                y, ld = layer(y, cond, reverse=True)
                logdet = logdet + ld
            return self.squeeze(y, reverse=True), logdet
        x = self.squeeze(x)
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for layer in self.revlayers:
            x, ld = layer(x, cond)
            logdet = logdet + ld
        if self.do_split:
            x, lp, eps_out = self.split(x, return_eps=return_eps)
            return x, logdet + lp, eps_out
        return x, logdet, None


class FirstRevBlock(nn.Module):
    """RevLayers behind a coupling-only first layer (JAX flow.py:531-554)."""

    def __init__(self, in_features: int, cond_features: int, n_layers: int,
                 coupling_net: str = "dense", LU_decompose: bool = True,
                 train_sampling: bool = True):
        super().__init__()
        self.revlayers = [FirstRevLayer(in_features, cond_features,
                                        coupling_net)]
        for i in range(1, n_layers):
            self.revlayers.append(RevLayer(in_features, cond_features,
                                           LU_decompose, train_sampling,
                                           coupling_net))
        for i, layer in enumerate(self.revlayers):
            self.add_module(f"revlayer{i + 1}", layer)

    def forward(self, x, cond, reverse: bool = False):
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        layers = reversed(self.revlayers) if reverse else self.revlayers
        for layer in layers:
            x, ld = layer(x, cond, reverse=reverse)
            logdet = logdet + ld
        return x, logdet


@torch.no_grad()
def reset_flow_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``model`` as the JAX package initialises it,
    from ``generator``: conv kernels U(+-1/sqrt(fan_in)) with zero biases,
    zero ``Conv2dZeros``, QR rotations for the 1x1 convs (LU-factored for
    ``InvConv1x1LU``), BatchNorm and ActNorm at identity."""
    zeros = {id(m.conv) for m in model.modules()
             if isinstance(m, Conv2dZeros)}
    for m in model.modules():
        if isinstance(m, (Conv2dZeros, InvConv1x1, InvConv1x1LU)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Conv2d) and id(m) not in zeros:
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()

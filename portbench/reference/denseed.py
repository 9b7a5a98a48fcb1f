"""The dense convolutional encoder-decoder (DenseED) of Zhu, Zabaras,
Koutsourelakis & Perdikaris (JCP 394, 2019; the source repository's
``models/codec.py``), written as a plain function of a dict of tensors.

Parameter names are the source repository's module paths
(``features.EncBlock1.denselayer1.norm1.weight``, ...), so one dict of
weights made by the benchmark loads into the program by name and feeds this
function.  Convolutions have no bias; BatchNorm normalises with the batch's
biased moments in training and the running moments in evaluation.  A
training forward whose weights hold a dict under ``MOMENTS`` leaves there
each BatchNorm's batch moments, which ``check`` folds into the running
moments (momentum 0.1, the biased variance, as the JAX package's flax
BatchNorm folds them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import darcy

EPS = 1e-5
MOMENTS = "moments"     # the key of the batch moments a training forward leaves


def _bn(name: int | str, c: int) -> list:
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.running_mean", (c,), "zeros"),
            (f"{name}.running_var", (c,), "ones"),
            (f"{name}.num_batches_tracked", (), "count")]


def _conv(name: str, cout: int, cin: int, k: int) -> list:
    return [(f"{name}.weight", (cout, cin, k, k), "fan:1")]


def _layout(cfg: dict):
    """Yield (kind, module path, sizes) in forward order."""
    blocks, g = cfg["blocks"], cfg["growth_rate"]
    enc, dec = blocks[:len(blocks) // 2], blocks[len(blocks) // 2:]
    nf = cfg["init_features"]
    yield "in_conv", "features.In_conv", (cfg["in_channels"], nf)
    for i, n in enumerate(enc):
        yield "dense", f"features.EncBlock{i + 1}", (nf, n, g)
        nf += n * g
        yield "down", f"features.TransDown{i + 1}", (nf, nf // 2)
        nf //= 2
    for i, n in enumerate(dec):
        yield "dense", f"features.DecBlock{i + 1}", (nf, n, g)
        nf += n * g
        if i < len(dec) - 1:
            yield "up", f"features.TransUp{i + 1}", (nf, nf // 2)
            nf //= 2
    yield "last", "features.LastTransUp", (nf, cfg["out_channels"])


def spec(cfg: dict) -> list:
    """[(name, shape, init)] of every parameter and buffer; init is one of
    ``lib.weights.make``'s inits."""
    out = []
    for kind, path, sz in _layout(cfg):
        if kind == "in_conv":
            out += _conv(path, sz[1], sz[0], 7)
        elif kind == "dense":
            nf, n, g = sz
            for j in range(n):
                p = f"{path}.denselayer{j + 1}"
                out += _bn(f"{p}.norm1", nf + j * g)
                out += _conv(f"{p}.conv1", g, nf + j * g, 3)
        elif kind in ("down", "up"):
            cin, cout = sz
            out += _bn(f"{path}.norm1", cin) + _conv(f"{path}.conv1", cout,
                                                     cin, 1)
            out += _bn(f"{path}.norm2", cout) + _conv(f"{path}.conv2", cout,
                                                      cout, 3)
        else:
            nf, c = sz
            out += _bn(f"{path}.norm1", nf)
            out += _conv(f"{path}.conv1", nf // 2, nf, 3)
            out += _bn(f"{path}.norm2", nf // 2)
            out += _conv(f"{path}.conv2", nf // 4, nf // 2, 3)
            out += _bn(f"{path}.norm3", nf // 4)
            out += _conv(f"{path}.conv3", c, nf // 4, 5)
    return out


def bn_relu(x: torch.Tensor, p: dict, name: str, train: bool):
    """ReLU of the batch-normalised ``x``."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if MOMENTS in p:
            p[MOMENTS][name] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    y = ((x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + EPS)
         * p[f"{name}.weight"][:, None, None] + p[f"{name}.bias"][:, None, None])
    return F.relu(y)


def dense_block(x: torch.Tensor, p: dict, path: str, n: int, train: bool):
    """n layers of BN-ReLU-3x3 conv, each concatenating its growth."""
    for j in range(n):
        q = f"{path}.denselayer{j + 1}"
        y = F.conv2d(bn_relu(x, p, f"{q}.norm1", train), p[f"{q}.conv1.weight"],
                     padding=1)
        x = torch.cat([x, y], dim=1)
    return x


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling (a broadcast, whose backward is a
    sum and deterministic on the card)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def forward(p: dict, x: torch.Tensor, cfg: dict, train: bool = True):
    """(B, in, n, n) -> (B, out, n, n)."""
    for kind, path, sz in _layout(cfg):
        if kind == "in_conv":
            pad = 3 if cfg["imsize"] % 2 == 0 else 2
            x = F.conv2d(x, p[f"{path}.weight"], stride=2, padding=pad)
        elif kind == "dense":
            x = dense_block(x, p, path, sz[1], train)
        elif kind in ("down", "up"):
            x = F.conv2d(bn_relu(x, p, f"{path}.norm1", train),
                         p[f"{path}.conv1.weight"])
            x = bn_relu(x, p, f"{path}.norm2", train)
            if kind == "down":
                x = F.conv2d(x, p[f"{path}.conv2.weight"], stride=2, padding=1)
            else:
                x = F.conv2d(_up(x), p[f"{path}.conv2.weight"], padding=1)
        else:
            x = F.conv2d(bn_relu(x, p, f"{path}.norm1", train),
                         p[f"{path}.conv1.weight"], padding=1)
            x = F.conv2d(_up(bn_relu(x, p, f"{path}.norm2", train)),
                         p[f"{path}.conv2.weight"], padding=1)
            x = F.conv2d(bn_relu(x, p, f"{path}.norm3", train),
                         p[f"{path}.conv3.weight"], padding=2)
    return x


def train_loss(cfg: dict, seed: int, device):
    """loss(weights, K batch, step index): the Sobel mixed residual of the
    training-mode forward."""
    def loss(w, x, k):
        return darcy.mixed_residual_loss(x, forward(w, x, cfg, True),
                                         cfg["weight_bound"])

    return loss


def count_train(cfg: dict, traffic: dict):
    """One training step's forward and backward on meta tensors, for
    ``lib.counts``."""
    from ..lib.counts import meta_params
    from ..lib.weights import leaves

    def run():
        sp = spec(cfg)
        p = meta_params(sp, trained=set(leaves(sp)))
        x = torch.empty(traffic["batch"], cfg["in_channels"], cfg["imsize"],
                        cfg["imsize"], device="meta")
        train_loss(cfg, 0, "meta")(p, x, 0).backward()

    return run

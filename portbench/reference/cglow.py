"""The multiscale conditional Glow p(y | K) of Zhu, Zabaras, Koutsourelakis
& Perdikaris (JCP 394, 2019; the source repository's ``models/glow_msc.py``),
written as plain functions of a dict of tensors: the DenseNet encoder of K,
and the reverse flow z -> y with its log-density, which reverse-KL
training and uncertainty propagation both run.

Parameter names are the program's module paths, so one dict of weights
made by the benchmark feeds both.  Layout (NCHW): the encoder's blocks
give one condition per scale and the top latent's prior; the flow's first
block is coupling layers on the full field, each later block a subpixel
squeeze (2x2 pixels into channels), ActNorm -> LU 1x1 conv -> affine
coupling layers and, except the last, a split whose second half has a
learned Gaussian prior.  Coupling: x1 passes, x2 -> (x2 + shift) * scale
with shift, scale from a dense-block net of (x1, condition), scale =
sigmoid(h + 2); logdets are sum(log scale), sum(log|w|) H W and sum(log_s)
H W.  Gaussian log-stddevs are clamped straight-through to [-10, log 5].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .darcy import mixed_residual_loss
from .denseed import _conv, bn_relu, dense_block
from .seeding import make_generator

LOG2PI = math.log(2 * math.pi)
LOGSTD_MIN, LOGSTD_MAX = -10.0, math.log(5.0)
GROWTH, INIT_FEATURES = 16, 48
COUPLING_LAYERS = 3


def z_shapes(cfg: dict) -> list:
    """(C, H, W) of each latent: the splits bottom-up, then the top."""
    n, c, out = cfg["imsize"], cfg["y_channels"], []
    for _ in range(len(cfg["flow_blocks"]) - 2):
        n, c = n // 2, c * 2
        out.append((c, n, n))
    return out + [(c * 4, n // 2, n // 2)]


def cond_sizes(cfg: dict) -> list:
    """Channels of the encoder's condition at each scale."""
    sizes, nf = [], 0
    for i, n in enumerate(cfg["enc_blocks"]):
        nf = (cfg["x_channels"] + INIT_FEATURES - 1 + (n - 1) * GROWTH
              if i == 0 else nf + n * GROWTH)
        sizes.append(nf)
        nf //= 2
    return sizes


def _half_up(n: int) -> int:
    return -(-n // 2)


def _bn(name: str, c: int) -> list:
    # drawn, not at the identity, so that each affine and eval mode's
    # running moments change what the layer computes
    return [(f"{name}.weight", (c,), "one:0.1"),
            (f"{name}.bias", (c,), "abs:0.1"),
            (f"{name}.running_mean", (c,), "abs:0.1"),
            (f"{name}.running_var", (c,), "one:0.5"),
            (f"{name}.num_batches_tracked", (), "count")]


def _conv_zeros(name: str, cout: int, cin: int) -> list:
    # the source starts these at zero; the benchmark draws them small, so
    # that every layer has a gradient from the first step and its output
    # scaling is not the identity
    return [(f"{name}.scale", (cout,), "abs:0.1"),
            (f"{name}.conv.weight", (cout, cin, 3, 3), "fan:0.1"),
            (f"{name}.conv.bias", (cout,), "abs:0.05")]


def _dense(path: str, nf: int, n: int) -> list:
    out = []
    for j in range(n):
        out += _bn(f"{path}.denselayer{j + 1}.norm1", nf + j * GROWTH)
        out += _conv(f"{path}.denselayer{j + 1}.conv1", GROWTH,
                     nf + j * GROWTH, 3)
    return out


def _coupling(path: str, feats: int, cond: int) -> list:
    nf = _half_up(feats) + cond
    out = _dense(f"{path}.coupling.coupling_nn", nf, COUPLING_LAYERS)
    nf += COUPLING_LAYERS * GROWTH
    out += _bn(f"{path}.coupling.coupling_nn.norm1", nf)
    return out + _conv_zeros(f"{path}.coupling.coupling_nn.conv_zero",
                             feats - feats % 2, nf)


def _rev_layer(path: str, feats: int, cond: int) -> list:
    return [(f"{path}.norm.weight", (feats,), "one:0.1"),
            (f"{path}.norm.bias", (feats,), "abs:0.1"),
            (f"{path}.conv1x1.l", (feats, feats), "fan:0.5"),
            (f"{path}.conv1x1.u", (feats, feats), "fan:0.5"),
            (f"{path}.conv1x1.log_s", (feats,), "abs:0.1"),
            (f"{path}.conv1x1.p", (feats, feats), "eye"),
            (f"{path}.conv1x1.sign_s", (feats,), "sign")] + _coupling(
                path, feats, cond)


def spec(cfg: dict) -> list:
    """[(name, shape, init)] of every parameter and buffer
    (``lib.weights.make``'s inits)."""
    enc, flow = cfg["enc_blocks"], cfg["flow_blocks"]
    conds = cond_sizes(cfg)
    x_c = cfg["x_channels"]
    out = [("encoder.dense_block1.in_conv.weight",
            (INIT_FEATURES - 1, x_c, 3, 3), "fan:1"),
           ("encoder.dense_block1.in_conv.bias", (INIT_FEATURES - 1,),
            "abs:0.1")]
    out += _dense("encoder.dense_block1", x_c + INIT_FEATURES - 1, enc[0] - 1)
    for i in range(1, len(enc)):
        nf = conds[i - 1]
        t = f"encoder.trans_down{i}"
        if i == 1:
            out += _bn(f"{t}.norm1", nf) + _conv(f"{t}.conv1", nf // 2, nf, 3)
        else:
            out += _bn(f"{t}.norm1", nf) + _conv(f"{t}.conv1", nf // 2, nf, 1)
            out += _bn(f"{t}.norm2", nf // 2) + _conv(f"{t}.conv2", nf // 2,
                                                      nf // 2, 3)
        out += _dense(f"encoder.dense_block{i + 1}", nf // 2, enc[i])
    out += _conv_zeros("encoder.top_latent", 2 * z_shapes(cfg)[-1][0],
                       conds[-1])
    feats = cfg["y_channels"]
    for i, n in enumerate(flow):
        blk = f"revblock{i + 1}"
        if i > 0:
            feats *= 4
        for j in range(n):
            path = f"{blk}.revlayer{j + 1}"
            out += (_coupling(path, feats, conds[i]) if i == 0 and j == 0
                    else _rev_layer(path, feats, conds[i]))
        if 0 < i < len(flow) - 1:
            out += _conv_zeros(f"{blk}.split.latent_encoder.conv2d",
                               2 * (feats // 2), _half_up(feats))
            feats //= 2
    return out


def _clamp_st(x: torch.Tensor) -> torch.Tensor:
    return x + (x.clamp(LOGSTD_MIN, LOGSTD_MAX) - x).detach()


def _conv_zeros_apply(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    y = F.conv2d(x, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"],
                 padding=1)
    return y * torch.exp(p[f"{name}.scale"] * 3.0)[:, None, None]


def _halves(x: torch.Tensor):
    first = _half_up(x.shape[1])
    return x[:, :first], x[:, first:]


def _log_prob(x, mean, log_std) -> torch.Tensor:
    lp = -0.5 * (LOG2PI + 2.0 * log_std
                 + (x - mean) ** 2 * torch.exp(-2.0 * log_std))
    return lp.reshape(x.shape[0], -1).sum(dim=1)


def encode(p: dict, x: torch.Tensor, cfg: dict, train: bool):
    """The conditions at each scale and the top prior's (mean, log std)."""
    enc = cfg["enc_blocks"]
    h = torch.cat([x, F.conv2d(x, p["encoder.dense_block1.in_conv.weight"],
                               p["encoder.dense_block1.in_conv.bias"],
                               padding=1)], dim=1)
    h = dense_block(h, p, "encoder.dense_block1", enc[0] - 1, train)
    conds = [h]
    for i in range(1, len(enc)):
        t = f"encoder.trans_down{i}"
        if i == 1:
            h = F.conv2d(bn_relu(h, p, f"{t}.norm1", train),
                         p[f"{t}.conv1.weight"], stride=2, padding=1)
        else:
            h = F.conv2d(bn_relu(h, p, f"{t}.norm1", train),
                         p[f"{t}.conv1.weight"])
            h = F.conv2d(bn_relu(h, p, f"{t}.norm2", train),
                         p[f"{t}.conv2.weight"], stride=2, padding=1)
        h = dense_block(h, p, f"encoder.dense_block{i + 1}", enc[i], train)
        conds.append(h)
    mean, log_std = torch.chunk(_conv_zeros_apply(h, p, "encoder.top_latent"),
                                2, dim=1)
    return conds, mean, _clamp_st(log_std)


def _coupling_reverse(z, cond, p, path, train):
    x1, x2 = _halves(z)
    net = f"{path}.coupling.coupling_nn"
    h = dense_block(torch.cat([x1, cond], dim=1), p, net, COUPLING_LAYERS,
                    train)
    h = _conv_zeros_apply(bn_relu(h, p, f"{net}.norm1", train), p,
                          f"{net}.conv_zero")
    shift, scale = h[:, 0::2], torch.sigmoid(h[:, 1::2] + 2.0)
    ld = torch.log(scale).reshape(z.shape[0], -1).sum(dim=1)
    return torch.cat([x1, x2 / scale - shift], dim=1), ld


def _rev_layer_reverse(z, cond, p, path, train):
    z, ld = _coupling_reverse(z, cond, p, path, train)
    c, hw = z.shape[1], z.shape[-2] * z.shape[-1]
    q = f"{path}.conv1x1"
    eye = torch.eye(c, dtype=z.dtype, device=z.device)
    lower = torch.tril(p[f"{q}.l"], -1) + eye
    upper = torch.triu(p[f"{q}.u"], 1) + torch.diag(
        torch.exp(p[f"{q}.log_s"]) * p[f"{q}.sign_s"])
    z = F.conv2d(z, (p[f"{q}.p"] @ lower @ upper)[:, :, None, None])
    ld = ld - torch.sum(p[f"{q}.log_s"]) * hw
    w, b = p[f"{path}.norm.weight"], p[f"{path}.norm.bias"]
    z = (z - b[:, None, None]) / w[:, None, None]
    return z, ld + torch.sum(torch.log(torch.abs(w))) * hw


def reverse_flow(conds, mean, log_std, eps: list, p: dict, cfg: dict,
                 train: bool):
    """y and log p(y | K) from the latents' standard normals ``eps``
    (``z_shapes`` order), temperature 1."""
    flow = cfg["flow_blocks"]
    z = mean + torch.exp(log_std) * eps[-1]
    logp = _log_prob(z, mean, log_std)
    for i in reversed(range(len(flow))):
        blk = f"revblock{i + 1}"
        if 0 < i < len(flow) - 1:
            s = f"{blk}.split.latent_encoder.conv2d"
            m, ls = _halves(_conv_zeros_apply(z, p, s))
            ls = _clamp_st(ls)
            z2 = m + torch.exp(ls) * eps[i - 1]
            logp = logp + _log_prob(z2, m, ls)
            z = torch.cat([z, z2], dim=1)
        for j in reversed(range(flow[i])):
            path = f"{blk}.revlayer{j + 1}"
            if i == 0 and j == 0:
                z, ld = _coupling_reverse(z, conds[i], p, path, train)
            else:
                z, ld = _rev_layer_reverse(z, conds[i], p, path, train)
            logp = logp + ld
        if i > 0:
            z = F.pixel_shuffle(z, 2)
    return z, logp


def reverse_kl_loss(p: dict, k: torch.Tensor, eps: list, cfg: dict):
    """beta * (mixed residual + weight_bound * boundary) of one generated
    field per input, plus its mean log-likelihood in bits per pixel."""
    conds, mean, log_std = encode(p, k, cfg, True)
    y, logp = reverse_flow(conds, mean, log_std, eps, p, cfg, True)
    pixels = y[0].numel()
    return (cfg["beta"] * mixed_residual_loss(k, y, cfg["weight_bound"])
            + logp.mean() / math.log(2.0) / pixels)


def noise(cfg: dict, generator: torch.Generator, samples: int, batch: int,
          dtype) -> list:
    """The latents' standard normals as the program draws them from
    ``generator``: one (samples, batch, C, H, W) float32 draw per latent
    in ``z_shapes`` order, then cast to ``dtype``."""
    return [torch.randn((samples, batch) + s, generator=generator,
                        device=generator.device).to(dtype)
            for s in z_shapes(cfg)]


def train_loss(cfg: dict, seed: int, device):
    """loss(weights, K batch, step index): step k's noise comes from the
    generator of (seed, k), as the program's step draws it."""
    def loss(w, x, k):
        eps = [e[0] for e in noise(cfg, make_generator(device, seed, k), 1,
                                   x.shape[0], x.dtype)]
        return reverse_kl_loss(w, x, eps, cfg)

    return loss


def chunk_size(n: int, batch_size: int) -> int:
    """The largest divisor of ``n`` up to ``batch_size``: the UQ suite's
    chunks of MC inputs."""
    return max(d for d in range(1, min(batch_size, n) + 1) if n % d == 0)


@torch.no_grad()
def propagate(cfg: dict, traffic: dict, w: dict, x: torch.Tensor, seed: int,
              fold: int) -> list:
    """(EE, VE, EV, VV) of the MC fields ``x``: for each repeat v and chunk
    t, ``draws`` fields per input from the generator of (seed, v, t); E
    and Var over inputs and draws, repeated ``var_samples`` times.  The
    reverse flow runs ``fold`` draws at a time."""
    n, s = len(x), traffic["draws"]
    b = chunk_size(n, traffic["chunk"])
    eys, vys = [], []
    for v in range(traffic["var_samples"]):
        ey = eyy = 0.0
        for t in range(n // b):
            xb = x[t * b:(t + 1) * b]
            conds, mean, log_std = encode(w, xb, cfg, False)
            eps = noise(cfg, make_generator(x.device, seed, v, t), s, b,
                        x.dtype)
            y_sum = y2_sum = 0.0
            for a in range(0, s, fold):
                m = min(fold, s - a)
                rep = lambda c: c.repeat(m, 1, 1, 1)  # noqa: E731
                y, _ = reverse_flow(
                    [rep(c) for c in conds], rep(mean), rep(log_std),
                    [e[a:a + m].reshape(-1, *e.shape[2:]) for e in eps],
                    w, cfg, False)
                y_sum = y_sum + y.sum(dim=0)
                y2_sum = y2_sum + (y * y).sum(dim=0)
            ey = ey + y_sum / (s * b)
            eyy = eyy + y2_sum / (s * b)
        ey, eyy = ey / (n // b), eyy / (n // b)
        eys.append(ey)
        vys.append(eyy - ey ** 2)
    ey, vy = torch.stack(eys), torch.stack(vys)
    return [ey.mean(0), ey.var(0, unbiased=False), vy.mean(0),
            vy.var(0, unbiased=False)]


def count_train(cfg: dict, traffic: dict):
    """One reverse-KL step's forward and backward on meta tensors, for
    ``lib.counts``."""
    from ..lib.counts import meta_params
    from ..lib.weights import leaves

    def run():
        sp = spec(cfg)
        p = meta_params(sp, trained=set(leaves(sp)))
        b, n = traffic["batch"], cfg["imsize"]
        x = torch.empty(b, cfg["x_channels"], n, n, device="meta")
        eps = [torch.empty((b,) + z, device="meta") for z in z_shapes(cfg)]
        reverse_kl_loss(p, x, eps, cfg).backward()

    return run


def count_propagate(cfg: dict, traffic: dict):
    """One call of the propagation on meta tensors, for ``lib.counts``:
    per chunk and repeat, the encoder of the chunk's inputs and the reverse
    flow of ``draws`` fields per input."""
    from ..lib.counts import meta_params

    def run():
        p = meta_params(spec(cfg))
        size, n, s = traffic["slice"], cfg["imsize"], traffic["draws"]
        b = chunk_size(size, traffic["chunk"])
        rep = lambda c: c.repeat(s, 1, 1, 1)  # noqa: E731
        with torch.no_grad():
            for _ in range(traffic["var_samples"] * (size // b)):
                x = torch.empty(b, cfg["x_channels"], n, n, device="meta")
                conds, mean, log_std = encode(p, x, cfg, False)
                eps = [torch.empty((s * b,) + z, device="meta")
                       for z in z_shapes(cfg)]
                reverse_flow([rep(c) for c in conds], rep(mean),
                             rep(log_std), eps, p, cfg, False)

    return run

"""Multiscale conditional Glow p(y|x), NCHW.

Counterpart of pde_surrogate_tpu/models/glow.py: a conditional normalizing
flow over the 3-channel solution fields, conditioned on a DenseNet feature
pyramid of the permeability x.  Submodules are named after the flax tree
(``encoder.dense_block1.in_conv``, ``revblock2.revlayer3.coupling...``).

* The BatchNorm mode is the module's (``model.train()`` / ``model.eval()``):
  the reverse-KL step runs ``generate`` in train mode; eval, sampling, UQ
  and ActNorm data-init run in eval mode.
* Noise comes from an explicit ``torch.Generator`` (``create_noise``) or is
  passed as ``eps_list``: one (B, C, H, W) standard normal per latent,
  splits bottom-up, top latent last (``glow_z_shapes`` order).
* On a data x space mesh (``parallel.mesh.replicate``) every conv of the
  encoder and the flow (codec ``Conv2d``s, the biased ``in_conv`` and
  ``Conv2dZeros`` among them) runs on this rank's row block at every
  scale, the squeezes take the rows (``flow.Squeeze``), and every
  log-density and logdet is this rank's partial sum over its rows.
* ``sample`` runs the encoder once.  In eval mode it folds up to
  ``max_fold`` fields of the sample axis into the batch (exact: eval-mode
  BatchNorm is per sample); in train mode it loops over the samples, as the
  JAX package's vmap does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .codec import Conv2d, DenseBlock, DenseLayer, Transition
from .flow import (Conv2dZeros, FirstRevBlock, GaussianDiag, RevBlock,
                   reset_flow_)

__all__ = ["DenseBlockInput", "InputEncoder", "MultiScaleCondGlow",
           "encoder_feature_sizes", "glow_z_shapes"]


def glow_z_shapes(img_size, y_channels: int, flow_blocks: Sequence[int],
                  factor: int = 2) -> list[tuple[int, int, int]]:
    """(C, H, W) of each latent: one per split, then the top latent (JAX
    glow.py:38-53, whose shapes are NHWC)."""
    if isinstance(img_size, int):
        img_size = [img_size, img_size]
    feature_size = list(img_size)
    n_features = y_channels
    z_shapes = []
    for _ in range(len(flow_blocks) - 2):
        feature_size = [fs // factor for fs in feature_size]
        n_features = n_features * factor ** 2 // 2
        z_shapes.append((n_features, feature_size[0], feature_size[1]))
    feature_size = [fs // factor for fs in feature_size]
    z_shapes.append((n_features * factor ** 2, feature_size[0],
                     feature_size[1]))
    return z_shapes


def encoder_feature_sizes(in_channels: int, blocks: Sequence[int],
                          growth_rate: int = 16, init_features: int = 48):
    """Conditioning channels per scale (JAX glow.py:56-75)."""
    sizes = []
    for i, num_layers in enumerate(blocks):
        if i == 0:
            num_features = (in_channels + init_features - 1
                            + (num_layers - 1) * growth_rate)
        else:
            num_features = num_features + num_layers * growth_rate
        sizes.append(num_features)
        if i < len(blocks) - 1:
            num_features //= 2
    return sizes


class DenseBlockInput(nn.Module):
    """Full-resolution input block (JAX glow.py:78-99): a biased 3x3
    ``in_conv`` to (init_features - 1) maps, concatenated with the input,
    then (num_layers - 1) DenseLayers."""

    def __init__(self, in_channels: int, num_layers: int, init_features: int,
                 growth_rate: int, drop_rate: float = 0.0):
        super().__init__()
        self.in_conv = Conv2d(in_channels, init_features - 1, 3, padding=1)
        nf = in_channels + init_features - 1
        self.layers = []
        for i in range(num_layers - 1):
            layer = DenseLayer(nf + i * growth_rate, growth_rate, drop_rate)
            self.add_module(f"denselayer{i + 1}", layer)
            self.layers.append(layer)

    def forward(self, x):
        out = torch.cat([x, self.in_conv(x)], dim=1)
        for layer in self.layers:
            out = layer(out)
        return out


class InputEncoder(nn.Module):
    """DenseNet feature pyramid over x: the conditions of each flow block
    and the top latent's prior (JAX glow.py:102-144)."""

    def __init__(self, in_channels: int, latent_features: int,
                 blocks: Sequence[int], growth_rate: int = 16,
                 init_features: int = 48, drop_rate: float = 0.0):
        super().__init__()
        self.stages = []
        num_features = 0
        for i, num_layers in enumerate(blocks):
            if i == 0:
                block = DenseBlockInput(in_channels, num_layers,
                                        init_features, growth_rate,
                                        drop_rate)
                num_features = (in_channels + init_features - 1
                                + (num_layers - 1) * growth_rate)
            else:
                block = DenseBlock(num_layers, num_features, growth_rate,
                                   drop_rate)
                num_features += num_layers * growth_rate
            self.add_module(f"dense_block{i + 1}", block)
            trans = None
            if i < len(blocks) - 1:
                trans = Transition(num_features, num_features // 2,
                                   down=True, drop_rate=drop_rate,
                                   bottleneck=i > 0)
                self.add_module(f"trans_down{i + 1}", trans)
                num_features //= 2
            self.stages.append((block, trans))
        self.top_latent = Conv2dZeros(num_features, latent_features * 2)

    def forward(self, x):
        conditions = []
        for block, trans in self.stages:
            x = block(x)
            conditions.append(x)
            if trans is not None:
                x = trans(x)
        mean, log_stddev = torch.chunk(self.top_latent(x), 2, dim=1)
        return conditions, GaussianDiag(mean, log_stddev)


class MultiScaleCondGlow(nn.Module):
    """Conditional Glow p(y|x) (JAX glow.py:147-328).

    forward(y, x):  density y -> z, returns (z, log p(y|x), eps_list|None)
    generate(x):    one y per x with its log p (the training path)
    sample(x, n):   (n, B, C, H, W) samples

    ``seed`` draws the initial weights (``flow.reset_flow_``).
    """

    def __init__(self, img_size, x_channels: int, y_channels: int,
                 enc_blocks: Sequence[int], flow_blocks: Sequence[int],
                 flow_coupling: str = "dense", squeeze_factor: int = 2,
                 LU_decompose: bool = True, train_sampling: bool = True,
                 squeeze_order: str = "subpixel", seed: int = 0):
        super().__init__()
        enc_blocks, flow_blocks = list(enc_blocks), list(flow_blocks)
        if len(enc_blocks) != len(flow_blocks):
            raise ValueError(
                f"enc_blocks and flow_blocks must have equal length "
                f"(train_cglow_reverse_kl.py:72), got "
                f"{len(enc_blocks)} vs {len(flow_blocks)}")
        if squeeze_factor != 2:
            raise ValueError(
                f"squeeze_factor must be 2 (got {squeeze_factor}): "
                f"the conditioning pyramid halves resolution per scale")
        dims = ([img_size] * 2 if isinstance(img_size, int)
                else list(img_size))
        scales = squeeze_factor ** (len(flow_blocks) - 1)
        if any(d % scales for d in dims):
            raise ValueError(
                f"img_size {img_size} must be divisible by "
                f"squeeze_factor^(n_blocks-1) = {scales} in BOTH dims "
                f"(models/glow_msc.py:415)")
        self.img_size = img_size
        self.x_channels, self.y_channels = x_channels, y_channels
        self.flow_blocks = flow_blocks
        self.z_shapes = glow_z_shapes(img_size, y_channels, flow_blocks,
                                      squeeze_factor)
        self.encoder = InputEncoder(x_channels, self.z_shapes[-1][0],
                                    enc_blocks, growth_rate=16,
                                    init_features=48)
        cond = encoder_feature_sizes(x_channels, enc_blocks, 16, 48)
        self.flow = []
        n_features = y_channels
        for i, n_layers in enumerate(flow_blocks):
            if i == 0:
                block = FirstRevBlock(n_features, cond[i], n_layers,
                                      flow_coupling, LU_decompose,
                                      train_sampling)
            else:
                block = RevBlock(n_features, cond[i], n_layers, flow_coupling,
                                 squeeze_factor, LU_decompose, train_sampling,
                                 do_split=i != len(flow_blocks) - 1,
                                 squeeze_order=squeeze_order)
                n_features = n_features * squeeze_factor ** 2 // 2
            self.add_module(f"revblock{i + 1}", block)
            self.flow.append(block)
        reset_flow_(self, torch.Generator().manual_seed(seed))

    # --- density evaluation: y -> z ---------------------------------------

    def forward(self, y, x, return_eps: bool = False):
        conditions, cond_prior = self.encoder(x)
        logdet = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        eps_list = []
        n = len(self.flow)
        for i, block in enumerate(self.flow):
            if i == 0:
                y, ld = block(y, conditions[i])
            elif i == n - 1:
                y, ld, _ = block(y, conditions[i])
                logdet = logdet + cond_prior.log_prob(y)
                if return_eps:
                    eps_list.append((y - cond_prior.mean)
                                    * torch.exp(-cond_prior.log_stddev))
            else:
                y, ld, eps = block(y, conditions[i], return_eps=return_eps)
                if return_eps:
                    eps_list.append(eps)
            logdet = logdet + ld
        return y, logdet, (eps_list if return_eps else None)

    # --- generation: z -> y -----------------------------------------------

    def _generate_from(self, conditions, cond_prior: GaussianDiag, eps_list,
                       temperature: float):
        """Reverse flow z -> y; ``temperature`` scales the split eps only,
        never the top latent's."""
        n = len(self.flow)
        z = cond_prior.sample(eps=eps_list[-1])
        logp = cond_prior.log_prob(z)
        for i in reversed(range(n)):
            block, cond = self.flow[i], conditions[i]
            if i == 0:
                z, ld = block(z, cond, reverse=True)
            else:
                eps = eps_list[i - 1] * temperature if i != n - 1 else None
                z, ld = block(z, cond, reverse=True, eps=eps)
            logp = logp + ld
        return z, logp

    def _check_eps(self, eps_list):
        want = len(self.flow_blocks) - 1
        if len(eps_list) != want:
            raise ValueError(
                f"eps_list must have {want} entries (len(flow_blocks)-1: "
                f"splits bottom-up, top latent last), got {len(eps_list)}")

    def generate(self, x, eps_list=None,
                 generator: torch.Generator | None = None,
                 temperature: float = 1.0):
        """One sample y ~ p(y|x) per input with its log-likelihood; noise
        from ``eps_list`` or drawn from ``generator``."""
        if eps_list is None:
            if generator is None:
                raise ValueError("generate() needs generator or eps_list")
            eps_list = [e[0] for e in self.create_noise(generator, 1,
                                                        x.shape[0])]
        else:
            self._check_eps(eps_list)
        conditions, cond_prior = self.encoder(x)
        return self._generate_from(conditions, cond_prior, eps_list,
                                   temperature)

    def sample(self, x, n_samples: int,
               generator: torch.Generator | None = None, eps_list=None,
               temperature: float | None = None, max_fold: int = 512):
        """(n_samples, B, C, H, W) samples; default temperature 0.7 (the
        CLIs pass 1.0).  ``eps_list`` entries are (n_samples, B, C, H,
        W)."""
        if temperature is None:
            temperature = 0.7
        if eps_list is None:
            if generator is None:
                raise ValueError("sample() needs generator or eps_list")
            eps_list = self.create_noise(generator, n_samples, x.shape[0])
        else:
            self._check_eps(eps_list)
        conditions, prior = self.encoder(x)
        bsz = x.shape[0]
        k = 1 if self.training else max(1, min(n_samples, max_fold // bsz))
        out = []
        for s in range(0, n_samples, k):
            eps = [e[s:s + k].reshape(-1, *e.shape[2:]) for e in eps_list]
            m = eps[0].shape[0] // bsz
            conds = [c.repeat(m, 1, 1, 1) for c in conditions]
            rep = GaussianDiag(prior.mean.repeat(m, 1, 1, 1),
                               prior.log_stddev.repeat(m, 1, 1, 1))
            y, _ = self._generate_from(conds, rep, eps, temperature)
            out.append(y.reshape(m, bsz, *y.shape[1:]))
        return torch.cat(out, dim=0)

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def create_noise(self, generator: torch.Generator, n_samples: int,
                     batch_size: int) -> list[torch.Tensor]:
        """Standard normals (n_samples, B, C, H, W) for every latent, drawn
        on the generator's device."""
        return [torch.randn((n_samples, batch_size) + s, generator=generator,
                            device=generator.device)
                for s in self.z_shapes]

    def create_zero_noise(self, batch_size: int) -> list[torch.Tensor]:
        """Zero eps for the cheap predictive mean."""
        return [torch.zeros((batch_size,) + s, device=self._device())
                for s in self.z_shapes]

    def approx_pred_mean(self, x):
        """All Gaussians at their means (JAX glow.py:325-328)."""
        return self.generate(x, eps_list=self.create_zero_noise(x.shape[0]))

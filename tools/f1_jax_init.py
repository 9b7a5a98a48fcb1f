"""Write the JAX package's initial conv-solver Decoder and latent as .npz.

ROADMAP F1: the port's conv solver misses u's bar on the canonical recipe
(kle1024 test field 8) from every seed tried.  One untested cause is the
starting point, since the two frameworks draw different initial weights
from the same seed.  This script builds the JAX package's Decoder as
``pde_surrogate_tpu/cli/solve_conv_mixed_residual.py`` does (``--nz 1
--blocks 8,6``, growth 16, 48 init features, imsize 64): the latent
``0.5 N(0, 1)`` of shape (1, 16, 16, 1) from ``np.random.default_rng(seed)``
and ``model.init(jax.random.key(seed), latent)``.  It writes the weights
under the port's names (``utils/from_jax.codec_state_dict_from_jax``) and
the latent in NCHW, as float32, to one .npz that the port's
``solve_conv_mixed_residual --init-weights`` reads (the card has no JAX).

    JAX_PLATFORMS=cpu python tools/f1_jax_init.py --seed 1 \\
        --out pde_surrogate_torch/tools/f1_jax_init_seed1.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pde_surrogate_torch.utils.from_jax import \
    codec_state_dict_from_jax  # noqa: E402
from pde_surrogate_tpu.models.codec import Decoder  # noqa: E402


def jax_decoder_init(seed: int, nz: int = 1, blocks=(8, 6),
                     imsize: int = 64, **decoder_kw) -> dict:
    """The JAX conv solver's initial Decoder state dict (port names) and
    ``latent`` (NCHW), as float32 numpy arrays."""
    sz = imsize // 4
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((1, sz, sz, nz)).astype(np.float32) * 0.5
    model = Decoder(nz, out_channels=3, blocks=list(blocks), **decoder_kw)
    # jitted: the same arrays, bit for bit, in a fraction of the time
    variables = jax.jit(lambda key, z: model.init(key, z, train=False))(
        jax.random.key(seed), latent)
    sd = codec_state_dict_from_jax(jax.device_get(variables["params"]),
                                   jax.device_get(variables["batch_stats"]))
    out = {k: v.numpy() for k, v in sd.items()}
    out["latent"] = np.ascontiguousarray(np.moveaxis(latent, -1, 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="pde_surrogate_torch/tools/"
                                    "f1_jax_init_seed1.npz")
    args = p.parse_args(argv)
    arrays = jax_decoder_init(args.seed)
    n = sum(v.size for k, v in arrays.items()
            if k != "latent" and not k.endswith(("running_mean",
                                                 "running_var",
                                                 "num_batches_tracked")))
    np.savez(args.out, **arrays)
    print(f"{args.out}: {n} parameters, latent "
          f"{arrays['latent'].shape}, {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Do the two packages' zoom L-BFGS runs track each other in float32?

The conv solver's loss (Decoder, 5x5 Sobel mixed residual, weight 10) on
one kle128 field, from the same weights in both packages: the JAX
package's Decoder is initialised, warmed up by its Adam warmup, and its
weights are moved into the port's Decoder (``utils/from_jax``).  Then each
package runs its own zoom L-BFGS epochs (20 steps each) in float32 on the
CPU (optax computes the linesearch's scalars in float32, the port on the
host in float64) and the script prints both losses after every epoch.

    python tools/solver_lbfgs_f32_probe.py [imsize 16] [adam steps 300]
        [epochs 15]

imsize 16 uses blocks 2,2; any other size the default [8, 6].
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")

from pde_surrogate_torch.data.grf import sample_kle  # noqa: E402
from pde_surrogate_torch.models.codec import Decoder as TDecoder  # noqa: E402
from pde_surrogate_torch.ops import darcy as td  # noqa: E402
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel  # noqa: E402
from pde_surrogate_torch.train import lbfgs as tlb  # noqa: E402
from pde_surrogate_torch.utils.from_jax import \
    codec_state_dict_from_jax  # noqa: E402
from pde_surrogate_tpu.models.codec import Decoder as JDecoder  # noqa: E402
from pde_surrogate_tpu.ops import darcy as jd  # noqa: E402
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel  # noqa: E402
from pde_surrogate_tpu.train import lbfgs as jlb  # noqa: E402


def main(n: int = 16, adam_steps: int = 300, epochs: int = 15):
    blocks = [2, 2] if n == 16 else [8, 6]
    K = sample_kle(1, n, 128, rng=1)[0].astype(np.float32)
    latent = (np.random.default_rng(1).standard_normal(
        (1, n // 4, n // 4, 1)).astype(np.float32) * 0.5)

    jm = JDecoder(1, 3, blocks)
    variables = jm.init(jax.random.key(1), jnp.asarray(latent), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    Kj, sj = jnp.asarray(K)[None, :, :, None], JSobel(n, filter_size=5)

    def j_loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(latent), train=True,
                          mutable=["batch_stats"])
        energy = (jd.conv_constitutive_constraint(Kj, out, sj)
                  + jd.conv_continuity_constraint(out, sj))
        diri, neum = jd.conv_boundary_condition(out)
        return energy + (diri + neum) * 10.0

    tm = TDecoder(1, 3, blocks).train()
    flat = tlb.FlatParams(tm)
    Kt, st = torch.from_numpy(K)[None, None], TSobel(n, filter_size=5)
    latent_t = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(latent, -1, 1)))

    def t_loss(v):
        out = torch.func.functional_call(tm, flat.unflatten(v), (latent_t,))
        energy = (td.conv_constitutive_constraint(Kt, out, st)
                  + td.conv_continuity_constraint(out, st))
        diri, neum = td.conv_boundary_condition(out)
        return energy + (diri + neum) * 10.0

    params, warm = jlb.run_adam_warmup(j_loss, params, adam_steps, 2e-3)
    tm.load_state_dict(codec_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), stats))
    v = flat.vector()
    print(f"imsize {n}, blocks {blocks}, {adam_steps} Adam steps: loss "
          f"{warm:.6e} (JAX), {float(t_loss(v)):.6e} (port, same weights)")
    j_opt = jlb.lbfgs_optimizer(learning_rate=None)
    j_state = j_opt.init(params)
    j_epoch = jlb.make_lbfgs_epoch(j_loss, j_opt, 20)
    t_opt = tlb.lbfgs_optimizer(learning_rate=None)
    t_state = t_opt.init(v)
    t_epoch = tlb.make_lbfgs_epoch(t_loss, t_opt, 20)
    for epoch in range(1, epochs + 1):
        params, j_state, j_l = j_epoch(params, j_state)
        v, t_state, t_l = t_epoch(v, t_state)
        print(f"epoch {epoch}: JAX {float(j_l):.6e}, port {float(t_l):.6e} "
              f"({t_state.evals} port loss evaluations)", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))

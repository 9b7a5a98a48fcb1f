"""How far do three float32 DenseED steps move under a 1e-7 perturbation?

The JAX package's data-parallel test (tests/test_training.py
``test_data_parallel_step_on_fake_mesh``) holds every parameter after three
Adam steps to 2e-5.  This probe takes its model and batch (DenseED
[2,3,2]/8/16 at 32^2, batch 8, the JAX init moved into the port by
``utils/from_jax``), runs the port's plain one-process Sobel step three
times in float64, then in float32 from the same batch and from copies of it
multiplied by (1 + 1e-7 N(0, 1)) (four seeds), and prints the step-3 loss
and the largest parameter distance from float64 of each.  A spread above
2e-5 says that three float32 steps are too ill-conditioned to tell a
data-parallel step from a plain one, whatever the implementation.

    JAX_PLATFORMS=cpu python tools/dp_f32_sensitivity_probe.py
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pde_surrogate_torch.data.grf import sample_kle  # noqa: E402
from pde_surrogate_torch.models.codec import DenseED  # noqa: E402
from pde_surrogate_torch.ops.filters import SobelFilter  # noqa: E402
from pde_surrogate_torch.train.codec_trainer import (  # noqa: E402
    create_state, make_mixed_residual_step)
from pde_surrogate_torch.utils.from_jax import (  # noqa: E402
    codec_state_dict_from_jax)
from pde_surrogate_tpu.models.codec import DenseED as JDenseED  # noqa: E402
from pde_surrogate_tpu.train import codec_trainer as jtr  # noqa: E402

KW = dict(in_channels=1, out_channels=3, imsize=32, blocks=[2, 3, 2],
          growth_rate=8, init_features=16)


def three_steps(sd, x, dtype):
    model = DenseED(**KW).to(dtype)
    model.load_state_dict(sd)
    step = make_mixed_residual_step(create_state(model, 1e-3, 10),
                                    SobelFilter(32), 10.0)
    losses = [float(step(x.to(dtype))["loss"]) for _ in range(3)]
    return losses, {k: v.double() for k, v in model.state_dict().items()
                    if not k.endswith("num_batches_tracked")}


def main():
    torch.set_num_threads(1)
    x = sample_kle(8, 32, 32, rng=0)[:, None]
    jm = JDenseED(1, 3, imsize=32, blocks=[2, 3, 2], growth_rate=8,
                  init_features=16, shared_stats=True)
    js, _ = jtr.create_state(jm, jax.random.key(0),
                             jnp.asarray(np.moveaxis(x, 1, -1)), lr_max=1e-3,
                             total_steps=10)
    sd = codec_state_dict_from_jax(jax.device_get(js.params),
                                   jax.device_get(js.batch_stats))
    x = torch.from_numpy(x)
    losses64, ref = three_steps(sd, x, torch.float64)
    print(f"float64: step-3 loss {losses64[-1]:.7f}")
    runs = [("float32", x)]
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        noise = torch.randn(x.shape, generator=g, dtype=torch.float64)
        runs.append((f"float32, input x (1 + 1e-7 N), seed {seed}",
                     (x.double() * (1 + 1e-7 * noise)).float()))
    for label, xi in runs:
        losses, state = three_steps(sd, xi, torch.float32)
        dist = max(float((state[k] - ref[k]).abs().max()) for k in ref)
        print(f"{label}: step-3 loss {losses[-1]:.7f}, largest parameter "
              f"distance from float64 {dist:.3e}")


if __name__ == "__main__":
    main()

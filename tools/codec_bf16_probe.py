"""Gradient noise of the DenseED's bf16 and concat-free paths at full width
(CPU, JAX package and PyTorch port side by side).

DenseED [6,8,6]/16/48 at 32^2 on 2 kle512 fields, the JAX model's init
weights moved into the port's model; one train-mode gradient of mean(y^2)
per variant.  Prints the rel-L2 of the concatenated parameter gradients
between pairs of variants: bf16 against f32 and concat-free against concat
in each package, each port variant against its JAX twin, and the port's
concat-free path with the JAX package's E[x^2]-E[x]^2 batch moments in
place of its centred ones.

    JAX_PLATFORMS=cpu python tools/codec_bf16_probe.py     (~2 min)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pde_surrogate_torch.data.grf import sample_kle  # noqa: E402
from pde_surrogate_torch.models import codec as tcodec  # noqa: E402
from pde_surrogate_torch.utils.from_jax import \
    codec_state_dict_from_jax  # noqa: E402
from pde_surrogate_tpu.models.codec import DenseED as JDenseED  # noqa: E402

KW = dict(in_channels=1, out_channels=3, imsize=32, blocks=[6, 8, 6],
          growth_rate=16, init_features=48)


def fast_moments(x):
    """The JAX package's moments: E[x^2] - E[x]^2 clipped at zero."""
    x = x.float()
    mu = x.mean(dim=(0, 2, 3))
    return mu, torch.clamp((x * x).mean(dim=(0, 2, 3)) - mu * mu, min=0.0)


def main():
    torch.set_num_threads(4)
    x = sample_kle(2, 32, 512, rng=3)[:, None].astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1)
    variables = None
    grads = {}
    for name, kw in (("f32", {}), ("bf16", dict(dtype=jnp.bfloat16)),
                     ("f32 cf", dict(shared_stats=True, concat_free=True)),
                     ("bf16 cf", dict(dtype=jnp.bfloat16, shared_stats=True,
                                      concat_free=True))):
        jm = JDenseED(**KW, **kw)
        if variables is None:
            variables = jax.jit(lambda k, x, m=jm: m.init(k, x, train=False))(
                jax.random.key(0), x_nhwc)

        def loss(p, m=jm):
            y, _ = m.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           x_nhwc, train=True, mutable=["batch_stats"])
            return jnp.mean(y.astype(jnp.float32) ** 2)
        grads[f"JAX {name}"] = codec_state_dict_from_jax(
            jax.device_get(jax.jit(jax.grad(loss))(variables["params"])), {})
    sd = codec_state_dict_from_jax(jax.device_get(variables["params"]),
                                   jax.device_get(variables["batch_stats"]))

    def port(**kw):
        m = tcodec.DenseED(**KW, **kw)
        m.load_state_dict(sd)
        y = m.train()(torch.from_numpy(x))
        (y ** 2).mean().backward()
        return {k: p.grad for k, p in m.named_parameters()}
    grads["port f32"] = port()
    grads["port bf16"] = port(dtype=torch.bfloat16)
    grads["port f32 cf"] = port(concat_free=True)
    grads["port bf16 cf"] = port(dtype=torch.bfloat16, concat_free=True)
    centred, tcodec._batch_moments = tcodec._batch_moments, fast_moments
    try:
        grads["port f32 cf, E[x^2]-E[x]^2"] = port(concat_free=True)
    finally:
        tcodec._batch_moments = centred

    def rel(a, b):
        a, b = (np.concatenate([np.asarray(g[k], np.float64).ravel()
                                for k in sorted(g)]) for g in (a, b))
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    for a, b in (("JAX bf16", "JAX f32"), ("JAX bf16 cf", "JAX bf16"),
                 ("JAX f32 cf", "JAX f32"), ("port f32", "JAX f32"),
                 ("port f32 cf", "JAX f32 cf"), ("port bf16", "JAX bf16"),
                 ("port bf16 cf", "JAX bf16 cf"), ("port bf16", "port f32"),
                 ("port bf16 cf", "port bf16"), ("port f32 cf", "port f32"),
                 ("port f32 cf, E[x^2]-E[x]^2", "port f32")):
        print(f"gradient rel-L2, {a} vs {b}: {rel(grads[a], grads[b]):.3e}")


if __name__ == "__main__":
    main()

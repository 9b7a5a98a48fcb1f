"""Port parity: DenseED with weights moved from the JAX model.

A JAX DenseED (shared_stats on and off) is initialized, its BN parameters
and running statistics are randomized, and the same weights go into the
port's DenseED through ``utils/from_jax.codec_state_dict_from_jax``.  Both
run on the same NCHW/NHWC-transposed inputs.  Tolerances are f32 convolution
sum-order noise: relative 1e-4 of the output scale.
"""

import jax
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.models.codec import module_size as t_module_size
from pde_surrogate_torch.ops.darcy import mixed_residual_loss as t_loss
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.models.codec import module_size as j_module_size
from pde_surrogate_tpu.ops.darcy import mixed_residual_loss as j_loss
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel

torch.set_num_threads(1)

IMSIZE, BLOCKS, GROWTH, INIT = 16, [1, 2, 1], 4, 8


def _nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _randomize_bn(params, rng):
    """BN scale and bias (the 1-D leaves) ~ N(1, 0.3); conv kernels kept."""
    return jax.tree_util.tree_map(
        lambda a: (1.0 + rng.normal(0, 0.3, a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), params)


def _models(shared_stats, upsample="nearest"):
    rng = np.random.default_rng(0)
    jm = JDenseED(1, 3, imsize=IMSIZE, blocks=BLOCKS, growth_rate=GROWTH,
                  init_features=INIT, shared_stats=shared_stats,
                  upsample=upsample)
    x = rng.random((2, 1, IMSIZE, IMSIZE)).astype(np.float32) + 0.5
    v = jm.init(jax.random.key(0), _nhwc(x), train=False)
    params = _randomize_bn(v["params"], rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.2, a.shape)).astype(np.float32),
        jax.device_get(v["batch_stats"]))
    tm = TDenseED(1, 3, IMSIZE, BLOCKS, growth_rate=GROWTH,
                  init_features=INIT, upsample=upsample)
    tm.load_state_dict(codec_state_dict_from_jax(params, stats))
    return jm, params, stats, tm, x


@pytest.mark.parametrize("shared_stats,upsample", [
    (True, "nearest"), (False, "nearest"), (True, "bilinear")])
def test_eval_forward(shared_stats, upsample):
    jm, params, stats, tm, x = _models(shared_stats, upsample)
    y_j = _nchw(jm.apply({"params": params, "batch_stats": stats},
                         _nhwc(x), train=False))
    with torch.no_grad():
        y_t = tm.eval()(torch.from_numpy(x)).numpy()
    assert y_t.shape == (2, 3, IMSIZE, IMSIZE)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4,
                               atol=1e-4 * np.abs(y_j).max())
    assert t_module_size(tm) == j_module_size(params)


@pytest.mark.parametrize("shared_stats", [True, False])
def test_train_forward_stats_and_grads(shared_stats):
    """Train-mode output, the running stats after one forward, and the
    parameter gradients of the mixed-residual loss.

    At batch 2 the deepest BN sees m = 2*4*4 = 32 values per channel, so
    the unbiased running-var update would differ from flax's biased one by
    0.1*var/31 (~3e-3 relative): far outside the 2e-5 tolerance here."""
    jm, params, stats, tm, x = _models(shared_stats)
    sobel_j = JSobel(IMSIZE, correct=True)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, _nhwc(x),
                            train=True, mutable=["batch_stats"])
        loss, _ = j_loss(_nhwc(x), out, sobel_j, 10.0)
        return loss, (out, mut["batch_stats"])

    (loss_j, (out_j, stats_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    tm.train()
    xt = torch.from_numpy(x)
    out_t = tm(xt)
    loss_t, _ = t_loss(xt, out_t, TSobel(IMSIZE, correct=True), 10.0)
    loss_t.backward()

    out_j = _nchw(out_j)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=1e-4,
                               atol=1e-4 * np.abs(out_j).max())
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)

    want = codec_state_dict_from_jax(params, jax.device_get(stats_j))
    got = tm.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-5,
                                       atol=2e-5, err_msg=k)

    g_want = codec_state_dict_from_jax(jax.device_get(grads_j), {})
    named = dict(tm.named_parameters())
    assert set(g_want) == set(named)
    for k, g in g_want.items():
        g = g.numpy()
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max(), err_msg=k)

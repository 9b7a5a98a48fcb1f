"""Port parity: the DenseED's options (concat_free, bottleneck, remat, bf16).

A JAX DenseED is initialized, its BN parameters and running statistics are
randomized, and the same weights go into the port's DenseED through
``utils/from_jax.codec_state_dict_from_jax`` (the reverse of the JAX
package's ``convert_codec_state_dict``).  Both take one train-mode forward
of the same input and the gradient of mean(y^2), as the JAX package's own
tests of these options do (tests/test_codec.py:160-298).  Sizes: blocks
[2, 3, 2], growth 4, 8 initial features, 16^2, batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED

torch.set_num_threads(1)

KW = dict(in_channels=1, out_channels=3, imsize=16, blocks=[2, 3, 2],
          growth_rate=4, init_features=8)


def _nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def _nchw(a):
    return np.moveaxis(np.asarray(a, np.float32), -1, 1)


def _weights(jm, seed=0):
    """JAX variables with BN scales, biases and running statistics drawn
    from a seed (conv kernels keep their init), and an NCHW input."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 1, 16, 16)).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(seed), _nhwc(x))
    params = jax.tree_util.tree_map(
        lambda a: (1.0 + rng.normal(0, 0.3, a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), jax.device_get(v["params"]))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.2, a.shape)).astype(np.float32),
        jax.device_get(v["batch_stats"]))
    return params, stats, x


def _jax_step(jm, params, stats, x):
    """Train-mode output (NCHW), the updated running statistics and the
    parameter gradients of mean(y^2), as port state dicts."""
    def loss_fn(p):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, _nhwc(x),
                          train=True, mutable=["batch_stats"])
        return jnp.mean(y.astype(jnp.float32) ** 2), (y, mut["batch_stats"])

    (_, (y, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert y.dtype == jnp.float32
    return (_nchw(y), codec_state_dict_from_jax(params,
                                                jax.device_get(new_stats)),
            codec_state_dict_from_jax(jax.device_get(grads), {}))


def _port_step(tm, x):
    tm.train()
    tm.zero_grad()
    y = tm(torch.from_numpy(x))
    assert y.dtype == torch.float32
    (y ** 2).mean().backward()
    return (y.detach().numpy(), tm.state_dict(),
            {k: p.grad.clone() for k, p in tm.named_parameters()})


def _port(params, stats, **kw):
    tm = TDenseED(**KW, **kw)
    tm.load_state_dict(codec_state_dict_from_jax(params, stats))
    return tm


def _close(got, want, rtol, what):
    """Each tensor within rtol of the largest magnitude of its reference."""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(),
                                   err_msg=f"{what} {k}")


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _flat(grads):
    return np.concatenate([np.asarray(grads[k]).ravel()
                           for k in sorted(grads)])


@pytest.mark.parametrize("variant", ["concat_free", "bottleneck"])
def test_against_jax_f32(variant):
    """concat_free against JAX DenseED(shared_stats=True, concat_free=True),
    bottleneck (bn_size 2, so that the wider layers take the 1x1 conv)
    against JAX DenseED(bottleneck=True): the train-mode output, the updated
    running statistics and every parameter gradient within 1e-5 of their
    largest magnitude, and the eval-mode output after the update."""
    jkw = (dict(shared_stats=True, concat_free=True) if variant == "concat_free"
           else dict(bottleneck=True, bn_size=2))
    tkw = (dict(concat_free=True) if variant == "concat_free"
           else dict(bottleneck=True, bn_size=2))
    jm = JDenseED(**KW, **jkw)
    params, stats, x = _weights(jm)
    y_j, sd_j, g_j = _jax_step(jm, params, stats, x)
    tm = _port(params, stats, **tkw)
    if variant == "bottleneck":
        assert "features.DecBlock1.denselayer3.conv2.weight" in dict(
            tm.named_parameters())
    y_t, sd_t, g_t = _port_step(tm, x)
    _close({"y": y_t}, {"y": y_j}, 1e-5, "train output")
    _close(sd_t, _stats(sd_j), 1e-5, "running stats")
    assert set(g_t) == set(g_j)
    _close(g_t, g_j, 1e-5, "gradient")

    new_stats = jax.device_get(jm.apply(
        {"params": params, "batch_stats": stats}, _nhwc(x), train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    y_eval_j = _nchw(jm.apply({"params": params, "batch_stats": new_stats},
                              _nhwc(x), train=False))
    with torch.no_grad():
        y_eval_t = tm.eval()(torch.from_numpy(x)).numpy()
    _close({"y": y_eval_t}, {"y": y_eval_j}, 1e-5, "eval output")


def test_concat_free_matches_concat_path_and_swaps_state_dicts():
    """The port's concat-free and concat paths on the same weights, at the
    JAX package's bounds for the two (tests/test_codec.py:173-190): outputs
    rtol/atol 2e-5, running statistics rtol 1e-5 atol 1e-6, gradients rtol
    5e-4 atol 5e-6.  The state dicts load into each other strictly."""
    params, stats, x = _weights(JDenseED(**KW))
    plain = _port(params, stats)
    free = _port(params, stats, concat_free=True)
    y_p, sd_p, g_p = _port_step(plain, x)
    y_f, sd_f, g_f = _port_step(free, x)
    np.testing.assert_allclose(y_f, y_p, rtol=2e-5, atol=2e-5)
    for k, v in _stats(sd_p).items():
        np.testing.assert_allclose(sd_f[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert sd_f["features.EncBlock1.denselayer1.norm1.num_batches_tracked"] \
        == sd_p["features.EncBlock1.denselayer1.norm1.num_batches_tracked"]
    for k, v in g_p.items():
        np.testing.assert_allclose(g_f[k].numpy(), v.numpy(), rtol=5e-4,
                                   atol=5e-6, err_msg=k)

    fresh_free, fresh_plain = (TDenseED(**KW, concat_free=True),
                               TDenseED(**KW))
    fresh_free.load_state_dict(plain.state_dict(), strict=True)
    fresh_plain.load_state_dict(free.state_dict(), strict=True)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(fresh_free.eval()(xt).numpy(),
                                   plain.eval()(xt).numpy(), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(fresh_plain.eval()(xt).numpy(),
                                   free.eval()(xt).numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_concat_free_refuses_bottleneck():
    with pytest.raises(ValueError, match="bottleneck"):
        TDenseED(**KW, concat_free=True, bottleneck=True)


@pytest.mark.parametrize("concat_free", [False, True])
def test_remat_matches_plain(concat_free):
    """remat recomputes each dense block in the backward pass: with dropout
    on and one seed, the output and the running buffers after the step are
    identical to the plain model's (the recomputation folds nothing), and
    every gradient is within 1e-6 of its largest magnitude."""
    params, stats, x = _weights(JDenseED(**KW))
    runs = []
    for remat in (False, True):
        tm = _port(params, stats, drop_rate=0.2, concat_free=concat_free,
                   remat=remat)
        torch.manual_seed(3)
        runs.append(_port_step(tm, x))
    (y0, sd0, g0), (y1, sd1, g1) = runs
    np.testing.assert_array_equal(y1, y0)
    for k, v in sd0.items():
        assert torch.equal(sd1[k], v), k
    _close(g1, g0, 1e-6, "remat gradient")


def test_bf16_against_jax():
    """dtype=bfloat16 against JAX DenseED(dtype=jnp.bfloat16): f32 output
    within rtol/atol 2e-2 and the gradient within rel-L2 0.05, the bounds
    of tests/test_codec.py:192-229; the conv outputs inside are bf16."""
    jm = JDenseED(**KW, dtype=jnp.bfloat16)
    params, stats, x = _weights(jm)
    y_j, _, g_j = _jax_step(jm, params, stats, x)
    tm = _port(params, stats, dtype=torch.bfloat16)
    seen = []
    tm.features.In_conv.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    y_t, sd_t, g_t = _port_step(tm, x)
    assert seen == [torch.bfloat16]
    assert all(v.dtype == torch.float32 for k, v in sd_t.items()
               if k.endswith(("weight", "running_var")))
    np.testing.assert_allclose(y_t, y_j, rtol=2e-2, atol=2e-2)
    a, b = _flat(g_j), _flat(g_t)
    assert np.isfinite(b).all()
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel < 0.05, f"bf16 gradient rel-L2 {rel:.4f}"


def test_bf16_concat_free_close_to_concat():
    """The port's bf16 concat-free path against its bf16 concat path at the
    same bounds (2e-2; gradient rel-L2 < 0.05).  Each partial conv runs in
    f32 on bf16-rounded operands and the sum is rounded once; a bf16 conv
    per group, rounding every partial, misses this bound: the JAX package
    measured that variant at 0.103 rel-L2 against 0.005
    (tests/test_codec.py:225-229)."""
    params, stats, x = _weights(JDenseED(**KW))
    y_p, _, g_p = _port_step(_port(params, stats, dtype=torch.bfloat16), x)
    y_f, _, g_f = _port_step(_port(params, stats, dtype=torch.bfloat16,
                                   concat_free=True), x)
    np.testing.assert_allclose(y_f, y_p, rtol=2e-2, atol=2e-2)
    a, b = _flat(g_p), _flat(g_f)
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert np.isfinite(b).all() and rel < 0.05, f"rel-L2 {rel:.4f}"

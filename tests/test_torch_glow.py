"""Port parity: the conditional Glow's flow layers and the model, against
the JAX package (models/flow.py, models/glow.py).

Weights move from the flax trees by ``glow_state_dict_from_jax``; the
zero-initialised leaves (Conv2dZeros, biases) are perturbed with seeded
noise first so that every layer acts.  Inputs come from numpy seeds, NHWC
for JAX and NCHW for the port.  Coupling nets run with eval-mode BatchNorm
here (the train-mode step is in test_torch_glow_trainer.py).

Tolerances (f32 on both sides): layer outputs 1e-5 of their scale plus
1e-4 relative; logdets and log-densities 1e-5 relative (they are sums of
~1e3 terms); the squeezes are permutations and agree exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models import flow as tf
from pde_surrogate_torch.models import glow as tg
from pde_surrogate_torch.utils.from_jax import glow_state_dict_from_jax
from pde_surrogate_tpu.models import flow as jf
from pde_surrogate_tpu.models import glow as jg

torch.set_num_threads(1)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _perturb(params, seed=0, scale=0.05):
    """Add seeded noise to every leaf (ActNorm weights stay near 1, the LU
    factors near the rotation they encode)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(l) + scale * rng.standard_normal(l.shape).astype(
            np.float32) for l in leaves])


def _transfer(vs, module):
    module.load_state_dict(glow_state_dict_from_jax(
        vs["params"], vs.get("batch_stats", {}), vs.get("constants", {})))
    return module.eval()


def _close(got, want, rtol=1e-4, atol_scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * max(np.abs(want).max(), 1e-6))


def _init(jmod, *args, seed=0, **kw):
    vs = jax.device_get(jax.jit(functools.partial(jmod.init, **kw))(
        jax.random.key(seed), *args))
    vs = dict(vs)
    vs.pop("actnorm_stats", None)
    vs["params"] = _perturb(vs["params"], seed)
    return vs


# --- flow layers ----------------------------------------------------------

X = _np((2, 8, 8, 4), 0)


def test_actnorm_matches_jax():
    vs = _init(jf.ActNorm(4), X)
    tm = _transfer(vs, tf.ActNorm(4))
    for reverse in (False, True):
        y, ld = jf.ActNorm(4).apply(vs, X, reverse=reverse)
        with torch.no_grad():
            ty, tld = tm(nchw(X), reverse=reverse)
        _close(nhwc(ty), y)
        np.testing.assert_allclose(float(tld), float(ld), rtol=1e-5)


@pytest.mark.parametrize("lu", [False, True], ids=["dense", "lu"])
@pytest.mark.parametrize("train_sampling", [True, False])
def test_invconv_matches_jax(lu, train_sampling):
    """Forward and reverse with their logdets: +log|det(applied)| forward,
    -log|det(applied)| in reverse, whichever matrix is applied."""
    c = 8
    x = _np((2, 4, 4, c), 1)
    jcls = jf.InvConv1x1LU if lu else jf.InvConv1x1
    tcls = tf.InvConv1x1LU if lu else tf.InvConv1x1
    vs = _init(jcls(c, train_sampling=train_sampling), x, seed=2)
    tm = _transfer(vs, tcls(c, train_sampling))
    for reverse in (False, True):
        y, ld = jcls(c, train_sampling=train_sampling).apply(
            vs, x, reverse=reverse)
        with torch.no_grad():
            ty, tld = tm(nchw(x), reverse=reverse)
        _close(nhwc(ty), y)
        np.testing.assert_allclose(float(tld), float(ld), rtol=1e-5,
                                   atol=1e-5)
    with torch.no_grad():
        y, ld_f = tm(nchw(x))
        x2, ld_r = tm(y, reverse=True)
    _close(nhwc(x2), x)
    # both directions report log|det dz/dy| of the density direction
    np.testing.assert_allclose(float(ld_r), float(ld_f), rtol=1e-5, atol=1e-5)


def test_invconv_lu_init_is_a_rotation():
    """The port's own init: P L U of the QR of a Gaussian, |det| = 1."""
    m = tf.InvConv1x1LU(6)
    m.reset_parameters(torch.Generator().manual_seed(0))
    l, u, eye = m._factors()
    w = m.p @ l @ u
    torch.testing.assert_close(w @ w.T, eye, atol=1e-5, rtol=0)
    assert abs(float(m.log_s.sum())) < 1e-5


def test_conv2dzeros_and_gaussian_diag_match_jax():
    """Conv2dZeros' exp(3 scale) and the straight-through clamp of the log
    stddev: log_prob and its gradient with respect to the log stddev,
    half of whose entries lie outside [-10, log 5]."""
    x = _np((2, 6, 6, 5), 3)
    vs = _init(jf.Conv2dZeros(4), x)
    tm = _transfer(vs, tf.Conv2dZeros(5, 4))
    _close(nhwc(tm(nchw(x))), jf.Conv2dZeros(4).apply(vs, x))

    mean, z = _np((2, 3, 3, 2), 4), _np((2, 3, 3, 2), 5)
    log_std = _np((2, 3, 3, 2), 6, scale=12.0)

    def jlp(ls):
        return jf.gaussian_diag(jnp.asarray(mean), ls).log_prob(
            jnp.asarray(z)).sum()
    jval, jgrad = jax.value_and_grad(jlp)(jnp.asarray(log_std))
    tls = nchw(log_std).requires_grad_(True)
    tval = tf.gaussian_diag(nchw(mean), tls).log_prob(nchw(z)).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    _close(nhwc(tls.grad), jgrad)


@pytest.mark.parametrize("features,coupling", [(6, "dense"), (3, "dense"),
                                               (6, "wide")])
def test_coupling_and_revlayer_match_jax(features, coupling):
    """AffineCouplingLayer (odd channel counts keep the extra channel in
    x1) and RevLayer, forward and reverse: +sum(log scale) both ways."""
    x = _np((2, 8, 8, features), 7)
    cond = _np((2, 8, 8, 5), 8)
    for jmod, tmod in (
            (jf.AffineCouplingLayer(features, coupling),
             tf.AffineCouplingLayer(features, 5, coupling)),
            (jf.RevLayer(features, coupling_net=coupling),
             tf.RevLayer(features, 5, coupling_net=coupling))):
        vs = _init(jmod, x, cond, train=False)
        tm = _transfer(vs, tmod)
        for reverse in (False, True):
            y, ld = jax.jit(functools.partial(
                jmod.apply, reverse=reverse, train=False))(vs, x, cond)
            with torch.no_grad():
                ty, tld = tm(nchw(x), nchw(cond), reverse=reverse)
            _close(nhwc(ty), y)
            np.testing.assert_allclose(tld.numpy(), np.asarray(ld),
                                       rtol=1e-5)


def test_split_matches_jax():
    """Split: forward (z1, log p(z2), eps) and reverse from that eps; the
    prior's log-density enters in both directions."""
    z = _np((2, 4, 4, 8), 9)
    vs = _init(jf.Split(8), z)
    tm = _transfer(vs, tf.Split(8))
    z1, lp, eps = jf.Split(8).apply(vs, z, return_eps=True)
    with torch.no_grad():
        tz1, tlp, teps = tm(nchw(z), return_eps=True)
        tz, tlp_r = tm(tz1, reverse=True, eps=teps)
    _close(nhwc(tz1), z1)
    _close(nhwc(teps), eps)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(lp), rtol=1e-5)
    z_rec, lp_rec = jf.Split(8).apply(vs, z1, reverse=True, eps=eps)
    _close(nhwc(tz), z_rec)
    np.testing.assert_allclose(tlp_r.numpy(), np.asarray(lp_rec), rtol=1e-5)


@pytest.mark.parametrize("order", ["subpixel", "reference"])
def test_squeeze_matches_jax_channel_for_channel(order):
    x = _np((2, 8, 12, 3), 10)
    y = jf.Squeeze(2, order=order)(jnp.asarray(x))
    sq = tf.Squeeze(2, order)
    ty = sq(nchw(x))
    np.testing.assert_array_equal(nhwc(ty), np.asarray(y))
    np.testing.assert_array_equal(
        nhwc(sq(ty, reverse=True)),
        np.asarray(jf.Squeeze(2, order=order)(y, reverse=True)))
    np.testing.assert_array_equal(nhwc(sq(ty, reverse=True)), x)
    if order == "subpixel":
        assert torch.equal(ty, torch.nn.functional.pixel_unshuffle(nchw(x),
                                                                   2))


# --- the model ------------------------------------------------------------

def test_z_shapes_and_encoder_sizes_match_jax():
    for args in ((32, 3, [6, 6, 6]), (64, 3, [6, 6, 6]), (16, 3, [2, 2, 2]),
                 ([16, 32], 2, [2, 2, 2, 2])):
        want = jg.glow_z_shapes(*args)
        assert tg.glow_z_shapes(*args) == [(c, h, w) for h, w, c in want]
    for args in ((1, [3, 4, 4]), (2, [2, 2, 2]), (1, [6, 8, 6], 12, 24)):
        assert tg.encoder_feature_sizes(*args) == \
            jg.encoder_feature_sizes(*args)


def test_glow_config_checks():
    with pytest.raises(ValueError, match="equal length"):
        tg.MultiScaleCondGlow(12, 1, 3, [2, 2, 2], [2, 2])
    with pytest.raises(ValueError, match="divisible"):
        tg.MultiScaleCondGlow(12, 1, 3, [2, 2, 2, 2], [2, 2, 2, 2])
    with pytest.raises(ValueError, match="BOTH"):
        tg.MultiScaleCondGlow([16, 24], 1, 3, [2] * 5, [2] * 5)
    with pytest.raises(ValueError, match="squeeze_factor"):
        tg.MultiScaleCondGlow(16, 1, 3, [2, 2], [2, 2], squeeze_factor=4)
    m = tg.MultiScaleCondGlow(16, 1, 3, [2, 2, 2], [2, 2, 2]).eval()
    x = torch.ones(2, 1, 16, 16)
    with pytest.raises(ValueError, match="eps_list"):
        m.generate(x, eps_list=m.create_zero_noise(2)[:1])
    with pytest.raises(ValueError, match="needs generator"):
        m.sample(x, 3)


@functools.lru_cache(maxsize=None)
def _glow_pair(coupling="dense", order="subpixel"):
    """The JAX model with perturbed weights, the port's with the same
    weights, x, y, and the ActNorm paths of the JAX init."""
    jm = jg.MultiScaleCondGlow(img_size=16, x_channels=1, y_channels=3,
                               enc_blocks=[2, 2, 2], flow_blocks=[2, 2, 2],
                               flow_coupling=coupling, squeeze_order=order)
    x = np.exp(_np((2, 16, 16, 1), 11))
    y = _np((2, 16, 16, 3), 12, scale=0.3)
    # compiled as one program: op by op, the glow's init takes ~20 s
    vs = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(y), jnp.asarray(x)))
    paths = [".".join(p) for p in jf.actnorm_module_paths(
        dict(vs["actnorm_stats"]))]
    vs = {"params": _perturb(vs["params"], scale=0.01),
          "batch_stats": vs["batch_stats"], "constants": vs["constants"]}
    tm = tg.MultiScaleCondGlow(16, 1, 3, [2, 2, 2], [2, 2, 2],
                               flow_coupling=coupling, squeeze_order=order)
    return jm, vs, _transfer(vs, tm), x, y, paths


def test_actnorm_paths_follow_jax_order():
    """The data-init order: the JAX package's numeric sort of the tree keys
    (revblock, revlayer, coupling norm) equals the port's module order,
    wide coupling's inner ActNorms included."""
    *_, tm, _, _, want = _glow_pair("wide", "reference")
    assert tf.actnorm_module_paths(tm) == want
    assert want[:3] == ["revblock1.revlayer1.coupling.coupling_nn.norm1",
                        "revblock1.revlayer1.coupling.coupling_nn.norm2",
                        "revblock1.revlayer2.norm"]


@pytest.mark.parametrize("coupling,order", [("dense", "subpixel"),
                                            ("wide", "reference")])
def test_glow_density_generate_sample_match_jax(coupling, order):
    """Density (z, log p, the eps of every latent), generate from those eps
    (which reconstructs y), and sample with a given (3, B, ...) eps_list at
    temperature 0.8, all in eval mode, against the JAX model."""
    jm, vs, tm, x, y, _ = _glow_pair(coupling, order)
    tx, ty = nchw(x), nchw(y)
    z, logp, eps = jax.jit(functools.partial(
        jm.apply, return_eps=True, train=False))(vs, jnp.asarray(y),
                                                 jnp.asarray(x))
    with torch.no_grad():
        tz, tlogp, teps = tm(ty, tx, return_eps=True)
    _close(nhwc(tz), z)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(logp), rtol=1e-5)
    for a, b in zip(teps, eps):
        _close(nhwc(a), b)

    yg, lg = jax.jit(functools.partial(jm.apply, method=jm.generate,
                                       train=False))(vs, jnp.asarray(x), eps)
    with torch.no_grad():
        tyg, tlg = tm.generate(tx, eps_list=[nchw(e) for e in eps])
    _close(nhwc(tyg), yg)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), rtol=1e-5)
    # reconstructing y: within three times the JAX package's own f32 error
    assert np.abs(nhwc(tyg) - y).max() <= 3 * np.abs(np.asarray(yg) - y).max()

    seps = [_np((3, 2) + tuple(s), 13 + i)
            for i, s in enumerate(jg.glow_z_shapes(16, 3, [2, 2, 2]))]
    samples = jax.jit(functools.partial(
        jm.apply, method=jm.sample, n_samples=3, temperature=0.8,
        train=False))(vs, jnp.asarray(x), eps_list=[jnp.asarray(e)
                                                   for e in seps])
    with torch.no_grad():
        ts = tm.sample(tx, 3, eps_list=[torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(e, -1, 2))) for e in seps], temperature=0.8,
            max_fold=4)
    assert ts.shape == (3, 2, 3, 16, 16)
    _close(np.moveaxis(ts.numpy(), 2, -1), samples)


def test_generate_log_p_agrees_with_density_port_only():
    """The strongest check of the logdet signs: log p(y|x) of generate
    equals the density path's on the generated y, for fresh noise from a
    generator; the approximate predictive mean is finite."""
    m = tg.MultiScaleCondGlow(16, 2, 3, [2, 2, 2], [2, 2, 2], seed=3)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    m.eval()
    x = torch.from_numpy(np.exp(_np((2, 2, 16, 16), 14)))
    with torch.no_grad():
        y, logp_gen = m.generate(x, generator=torch.Generator()
                                 .manual_seed(5))
        _, logp_fwd, _ = m(y, x)
        mean, _ = m.approx_pred_mean(x)
    torch.testing.assert_close(logp_gen, logp_fwd, rtol=1e-5, atol=0)
    assert y.shape == (2, 3, 16, 16) and torch.isfinite(mean).all()

"""Port parity: the cGlow trainer (train/glow_trainer.py) against the JAX
package — the reverse-KL loss and its parameter gradient under each
physics, one Adam step, optax's ``apply_if_finite`` NaN guard, the
forward-KL step, the eval step in both forms, the sequential ActNorm
data-init under dense and wide coupling, and the checkpointed counters.

A 16^2 model with enc/flow blocks [2, 2, 2] (one Split), batch 4, weights
perturbed from the JAX init by N(0, 0.01^2) and moved by
``glow_state_dict_from_jax``.  The noise of a JAX step is recomputed with
the model's ``create_noise`` from the step's key and handed to the port as
``eps_list``.  The JAX gradient is read through an optax transformation
that returns it as its state.

Tolerances: losses and their parts 1e-5 relative; gradients 1e-4 of the
largest |g| (f32 through ~40 layers forward and back, both ways of
summing); BN running stats 2e-5; ActNorm data-init 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.models.flow import actnorm_module_paths
from pde_surrogate_torch.models.glow import MultiScaleCondGlow as TGlow
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.train import checkpoint as tck
from pde_surrogate_torch.train import glow_trainer as ttr
from pde_surrogate_torch.utils.from_jax import glow_state_dict_from_jax
from pde_surrogate_tpu.models.glow import MultiScaleCondGlow as JGlow
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import glow_trainer as jtr

torch.set_num_threads(1)

N, B, BLOCKS = 16, 4, [2, 2, 2]
NPIX = 3 * N * N
KW = dict(beta=150.0, weight_bound=50.0, n_out_pixels=NPIX)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _perturb(params, scale=0.01):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(np.asarray(l) + scale * rng.standard_normal(l.shape)
                    .astype(np.float32)) for l in leaves])


def _data():
    x = sample_kle(B, N, 16, rng=0)[..., None]
    y = (np.random.default_rng(1).standard_normal((B, N, N, 3))
         * 0.1).astype(np.float32)
    return x, y


class _Compiled:
    """The JAX model with ``init`` and ``apply`` each compiled as one
    program (run op by op, the glow's first init takes about a minute on
    one CPU core); every other attribute is the model's."""

    def __init__(self, model):
        self.model = model
        self._fns = {}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _jit(self, fn, **kw):
        key = (fn.__name__, repr(sorted(kw.items())))
        if key not in self._fns:
            self._fns[key] = jax.jit(functools.partial(fn, **kw))
        return self._fns[key]

    def init(self, key, *args, **kw):
        return self._jit(self.model.init, **kw)(key, *args)

    def apply(self, variables, *args, **kw):
        return self._jit(self.model.apply, **kw)(variables, *args)


@functools.lru_cache(maxsize=None)
def _jax_setup(coupling="dense", train_sampling=True):
    """JAX model (compiled init/apply), state with perturbed weights, tx."""
    x, y = _data()
    jm = _Compiled(JGlow(img_size=N, x_channels=1, y_channels=3,
                         enc_blocks=BLOCKS, flow_blocks=BLOCKS,
                         flow_coupling=coupling,
                         train_sampling=train_sampling))
    js, tx = jtr.create_glow_state(jm, jax.random.key(0), jnp.asarray(y),
                                   jnp.asarray(x), lr_max=1e-3,
                                   total_steps=20)
    return jm, js._replace(params=_perturb(js.params)), tx


def _setup(coupling="dense", train_sampling=True):
    """JAX model, state and tx; the port's model and state on the same
    weights (Adam + OneCycle over 20 steps, lr 1e-3)."""
    x, y = _data()
    jm, js, tx = _jax_setup(coupling, train_sampling)
    tm = TGlow(N, 1, 3, BLOCKS, BLOCKS, flow_coupling=coupling,
               train_sampling=train_sampling)
    tm.load_state_dict(_torch_sd(js.params, js))
    ts = ttr.create_glow_state(tm, lr_max=1e-3, total_steps=20)
    return jm.model, _copy(js), tx, tm, ts, x, y


def _torch_sd(params, js):
    return glow_state_dict_from_jax(jax.device_get(params),
                                    jax.device_get(js.batch_stats),
                                    jax.device_get(js.constants))


def _copy(state):
    return jax.tree.map(jnp.copy, state)   # the JAX steps donate their state


def _capture():
    """An optax transformation whose state is the latest gradient and whose
    update is zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _step_eps(jm, js, n_samples=None, key=None):
    """The eps a JAX step draws from ``key`` (default: the train step's
    fold_in(state.key, state.step)), NCHW for the port."""
    key = jax.random.fold_in(js.key, js.step) if key is None else key
    noise = jm.apply(jtr._variables(js), key, n_samples or 1, B,
                     method=jm.create_noise)
    if n_samples is None:
        return [nchw(e[0]) for e in noise]
    return [torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(e), -1, 2))) for e in noise]


def _grads(tm):
    return {k: p.grad for k, p in tm.named_parameters() if p.grad is not None}


def _assert_grads(tm, jgrads, js, tol=1e-4):
    want = _torch_sd(jgrads, js)
    got = _grads(tm)
    gmax = max(float(np.abs(v.numpy()).max()) for k, v in want.items()
               if k in got)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=0,
                                   atol=tol * gmax, err_msg=k)
    params = dict(tm.named_parameters())
    zero = [k for k in want if k in params and k not in got
            and float(np.abs(want[k].numpy()).max()) > 0]
    assert not zero, zero


def _assert_running_stats(tm, js):
    want = _torch_sd(js.params, js)
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-5, err_msg=k)


@pytest.mark.parametrize("physics", ["sobel", "sobel_fvcg", "fvcg"])
def test_reverse_kl_loss_and_grads_match_jax(physics):
    """The train-mode generate with the step's noise, the objective (fvcg
    at 8 CG iterations, flux weight 1 in the hybrid) and its gradient with
    respect to every parameter; the BN running stats after the step."""
    jm, js, _, tm, ts, x, _ = _setup()
    kw = dict(KW, physics=physics, fvcg_flux_weight=1.0, fvcg_iters=8)
    cap = _capture()
    jstep = jtr.make_reverse_kl_step(jm, cap, JSobel(N), **kw)
    eps = _step_eps(jm, js)
    jnew, jmet = jstep(_copy(js)._replace(opt_state=cap.init(js.params)),
                       jnp.asarray(x))
    tmet = ttr.make_reverse_kl_step(ts, TSobel(N), **kw)(nchw(x),
                                                         eps_list=eps)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    _assert_grads(tm, jnew.opt_state, js)
    _assert_running_stats(tm, jnew)


def test_adam_step_and_nan_guard_match_optax():
    """One Adam step (OneCycle lr), then a step whose gradient is NaN: as
    optax.apply_if_finite(tx, 100) the port takes no update (parameters,
    Adam's moments and count, the lr position unchanged) while the noise
    counter advances and the BN running stats update; the next finite step
    is Adam's second update at the lr of the second update; after more
    than 100 consecutive non-finite steps the update is applied."""
    jm, js, tx, tm, ts, x, _ = _setup()
    jstep = jtr.make_reverse_kl_step(jm, tx, JSobel(N), **KW)
    tstep = ttr.make_reverse_kl_step(ts, TSobel(N), **KW)
    before = _torch_sd(js.params, js)
    eps = _step_eps(jm, js)
    j1, _ = jstep(_copy(js), jnp.asarray(x))
    tstep(nchw(x), eps_list=eps)
    # the first Adam update is lr * g / (|g| + 1e-8), +-lr wherever |g|
    # lies above the f32 noise of the gradient (1e-4 of max|g|, the bound
    # of the gradient parity); some gradients are zero up to that noise
    # (e.g. a conv bias ahead of a train-mode BatchNorm)
    want = _torch_sd(j1.params, j1)
    gmax = max(float(p.grad.abs().max()) for p in tm.parameters())
    n_cmp = n_all = 0
    for k, p in tm.named_parameters():
        step_j = want[k].numpy() - before[k].numpy()
        step_t = p.detach().numpy() - before[k].numpy()
        sure = np.abs(p.grad.numpy()) > 1e-4 * gmax
        np.testing.assert_allclose(step_t[sure], step_j[sure], rtol=0,
                                   atol=1e-6, err_msg=k)
        n_cmp, n_all = n_cmp + sure.sum(), n_all + sure.size
    print(f"Adam step compared on {n_cmp} of {n_all} entries")
    assert n_cmp > 0.5 * n_all
    assert ts.updates == ts.step == 1
    np.testing.assert_allclose(ttr.glow_lr(ts), jtr.glow_lr(j1), rtol=1e-6)

    x_nan = x.copy()
    x_nan[0, 3, 3, 0] = np.nan
    params = {k: v.detach().clone() for k, v in tm.named_parameters()}
    adam = {k: v.clone() for k, v in ts.optimizer.state_dict()["state"][0]
            .items()}
    stats = tm.revblock1.revlayer1.coupling.coupling_nn.norm1 \
        .running_mean.clone()
    eps = _step_eps(jm, j1)          # before the step donates j1's key
    j2, _ = jstep(_copy(j1), jnp.asarray(x_nan))
    tstep(nchw(x_nan), eps_list=eps)
    for a, b in zip(jax.tree.leaves(j2.params), jax.tree.leaves(j1.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(j2.opt_state.inner_state),
                    jax.tree.leaves(j1.opt_state.inner_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k, v in tm.named_parameters():
        assert torch.equal(v, params[k]), k
    for k, v in ts.optimizer.state_dict()["state"][0].items():
        assert torch.equal(v, adam[k]), k
    assert (ts.step, ts.updates) == (int(j2.step), 1) == (2, 1)
    assert ts.notfinite_count == int(j2.opt_state.notfinite_count) == 1
    assert np.isclose(ttr.glow_lr(ts), jtr.glow_lr(j2), rtol=1e-6)
    assert not torch.equal(
        tm.revblock1.revlayer1.coupling.coupling_nn.norm1.running_mean,
        stats)

    # the next finite step takes Adam's second update at the lr of one
    # applied update (not of two steps taken); its size follows the
    # gradient's f32 noise, so 2e-5 (2 % of the lr) where |g| is sure
    eps = _step_eps(jm, j2)
    j3, _ = jstep(_copy(j2), jnp.asarray(x))
    tstep(nchw(x), eps_list=eps)
    want = _torch_sd(j3.params, j3)
    gmax = max(float(p.grad.abs().max()) for p in tm.parameters())
    for k, p in tm.named_parameters():
        sure = np.abs(p.grad.numpy()) > 1e-4 * gmax
        np.testing.assert_allclose(
            (p.detach() - params[k]).numpy()[sure],
            (want[k] - params[k]).numpy()[sure], rtol=0, atol=2e-5,
            err_msg=k)
    assert (ts.step, ts.updates, ts.notfinite_count) == (3, 2, 0)

    j4 = j3._replace(opt_state=j3.opt_state._replace(
        notfinite_count=jnp.asarray(100, jnp.int32)))
    ts.notfinite_count = 100
    eps = _step_eps(jm, j3)
    j4, _ = jstep(j4, jnp.asarray(x_nan))
    tstep(nchw(x_nan), eps_list=eps)
    assert not all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree.leaves(j4.params))
    assert not all(torch.isfinite(p).all() for p in tm.parameters())
    assert ts.updates == 3 and ts.notfinite_count == 101


def test_forward_kl_step_matches_jax():
    """Bits per pixel of labelled (x, y) through the train-mode density
    path, and its gradient."""
    jm, js, _, tm, ts, x, y = _setup()
    cap = _capture()
    jnew, jmet = jtr.make_forward_kl_step(jm, cap, NPIX)(
        _copy(js)._replace(opt_state=cap.init(js.params)), jnp.asarray(x),
        jnp.asarray(y))
    tmet = ttr.make_forward_kl_step(ts, NPIX)(nchw(x), nchw(y))
    np.testing.assert_allclose(float(tmet["bits_per_pixel"]),
                               float(jmet["bits_per_pixel"]), rtol=1e-5)
    _assert_grads(tm, jnew.opt_state, js)


@pytest.mark.parametrize("n_samples", [0, 3])
def test_eval_step_matches_jax(n_samples):
    """The eval step in eval mode: one generated sample, or the mean of
    ``n_samples`` with the entropy of one more generate; loss, residual,
    boundary, entropy (1e-5 relative), rel-L2 and SSE (1e-4 relative) and
    the output."""
    jm, js, _, tm, ts, x, y = _setup()
    key = jax.random.key(5)
    jout = jtr.make_glow_eval_step(jm, JSobel(N), n_samples=n_samples, **KW)(
        js, jnp.asarray(x), jnp.asarray(y), key)
    one = _step_eps(jm, js, key=key)
    eps = (_step_eps(jm, js, n_samples, key), one) if n_samples else one
    tout = ttr.make_glow_eval_step(ts, TSobel(N), n_samples=n_samples,
                                   **KW)(nchw(x), nchw(y), eps=eps)
    for k in ("loss", "residual", "boundary", "neg_entropy"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ("rel_l2", "sse"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-4, err_msg=k)
    want = np.moveaxis(np.asarray(jout["output"]), -1, 1)
    np.testing.assert_allclose(tout["output"].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("coupling", ["dense", "wide"])
def test_data_init_is_sequential_like_jax(coupling):
    """ActNorm data-init, one forward per ActNorm in density order under
    eval-mode BN: every ActNorm's (weight, bias) equals the JAX package's
    (wide coupling's inner ActNorms included); the weights stay O(1)."""
    jm, js, _, tm, ts, x, y = _setup(coupling)
    jnew = jtr.data_init_actnorm(_Compiled(jm), js, jnp.asarray(y),
                                 jnp.asarray(x))
    ttr.data_init_actnorm(ts, nchw(y), nchw(x))
    want = _torch_sd(jnew.params, jnew)
    names = [f"{n}.{p}" for n in actnorm_module_paths(tm)
             for p in ("weight", "bias")]
    assert len(names) == (34 if coupling == "wide" else 10)
    got = tm.state_dict()
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        if k.endswith("weight"):
            assert 1e-2 < float(got[k].abs().min()) < float(
                got[k].abs().max()) < 1e2


def test_checkpoint_keeps_glow_counters(tmp_path):
    """The noise counter, the applied-update counter and the non-finite
    streak survive a checkpoint, with Adam's state and the weights."""
    ts = ttr.create_glow_state(TGlow(N, 1, 3, BLOCKS, BLOCKS), 1e-3, 20)
    x, _ = _data()
    step = ttr.make_reverse_kl_step(ts, TSobel(N), **KW)
    step(nchw(x))
    ts.step, ts.notfinite_count = 7, 3
    tck.save_checkpoint(str(tmp_path), 1, ts, meta={"epoch": 1})
    other = ttr.create_glow_state(TGlow(N, 1, 3, BLOCKS, BLOCKS, seed=1),
                                  1e-3, 20)
    tck.restore_checkpoint(str(tmp_path), 1, other)
    assert (other.step, other.updates, other.notfinite_count) == (7, 1, 3)
    for k, v in ts.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.optimizer.state_dict()["state"].keys() == \
        ts.optimizer.state_dict()["state"].keys()


def test_step_noise_is_a_function_of_seed_and_step():
    """A step's eps depend on (seed, step) only: two states at the same
    step draw the same sample, another step another one."""
    from pde_surrogate_torch.utils.config import make_generator
    m = TGlow(N, 1, 3, BLOCKS, BLOCKS)
    a = m.create_noise(make_generator("cpu", 1, 5), 1, B)
    b = m.create_noise(make_generator("cpu", 1, 5), 1, B)
    c = m.create_noise(make_generator("cpu", 1, 6), 1, B)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="physics"):
        ttr.make_reverse_kl_step(ttr.create_glow_state(m, 1e-3, 2),
                                 TSobel(N), physics="bogus", **KW)

"""Port parity: the single-instance solvers' parts against the JAX package.

The sampler, the CPPNs (weights moved from flax), the FC losses with their
parameter gradients, the Decoder in train mode, L-BFGS against optax and
the Adam warmup.  The same numpy inputs go through both packages.

Tolerances: FC losses and gradients in float32 within 1e-5 relative (of
the value; of max|g| for gradients), or three times JAX's own float32 error
where that is larger, JAX's own error being the distance of its float32
result from the same JAX function under ``jax.enable_x64``; in float64
within 1e-10.  The optimizers run in float64 on both sides: fixed-step
L-BFGS iterates within 1e-10, zoom L-BFGS iterates and accepted steps
within 1e-8, Adam within 1e-12 (float32: 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pde_surrogate_torch.models import codec as tcodec
from pde_surrogate_torch.models import cppn as tcppn
from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops.sampling import SampleSpatial2d as TSampler
from pde_surrogate_torch.train import lbfgs as tlb
from pde_surrogate_torch.utils.from_jax import (codec_state_dict_from_jax,
                                                cppn_state_dict_from_jax)
from pde_surrogate_tpu.models import codec as jcodec
from pde_surrogate_tpu.models import cppn as jcppn
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.ops.sampling import SampleSpatial2d as JSampler
from pde_surrogate_tpu.train import lbfgs as jlb

torch.set_num_threads(1)


def test_sampler_points_bit_equal():
    """Every sampler method, on and off the grid, from the same seed: the
    same float32 bytes, drawn in the same order."""
    t, j = TSampler(12, 9, rng=3), JSampler(12, 9, rng=3)
    calls = [("colloc", dict(on_grid=True)),
             ("colloc", dict(on_grid=True, n_samples=50)),
             ("colloc", dict(on_grid=True, n_samples=50, no_boundary=True)),
             ("colloc", dict(on_grid=False, n_samples=33)),
             ("left", dict(on_grid=True)), ("right", dict(on_grid=False,
                                                           n_samples=7)),
             ("top", dict(on_grid=True, n_samples=4)),
             ("bottom", dict(on_grid=False, n_samples=5))]
    for name, kw in calls:
        a, b = getattr(t, name)(**kw), getattr(j, name)(**kw)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), (name, kw)


def _jax_cppn(kind, **kw):
    cls = jcppn.CPPN if kind == "cppn" else jcppn.ResCPPN
    model = cls(**kw)
    params = model.init(jax.random.key(0), jnp.zeros((1, 2)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _torch_cppn(kind, params, dtype=torch.float32, **kw):
    cls = tcppn.CPPN if kind == "cppn" else tcppn.ResCPPN
    model = cls(**kw)
    model.load_state_dict(cppn_state_dict_from_jax(params))
    return model.to(dtype)


CPPN_KW = {"cppn": dict(dim_in=2, dim_out=3, dim_hidden=16, layers_hidden=3),
           "rescppn": dict(dim_in=2, dim_out=3, dim_hidden=8, res_layers=2)}


@pytest.mark.parametrize("kind", ["cppn", "rescppn"])
def test_cppn_forward_matches_flax(kind):
    """Layer names, parameter count and forward (rtol 1e-5) with the flax
    weights; fc0 has no bias; a fresh port model has zero biases and
    weights of the Glorot scale."""
    jm, params = _jax_cppn(kind, **CPPN_KW[kind])
    tm = _torch_cppn(kind, params, **CPPN_KW[kind])
    assert tcppn.fc_model_size(tm) == jcppn.fc_model_size(params)
    assert tm.fc0.bias is None
    x = np.random.default_rng(1).random((40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    torch.manual_seed(0)
    fresh = tcppn.CPPN(2, 3, 256, 2)
    assert float(fresh.fc1.bias.detach().abs().max()) == 0.0
    std = float(fresh.fc1.weight.detach().std())
    assert abs(std - np.sqrt(2.0 / 512)) < 0.05 * np.sqrt(2.0 / 512)


# ---------------------------------------------------------------------------
# FC losses and their parameter gradients
# ---------------------------------------------------------------------------


def _fc_case(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((24, 2))
    K = np.exp(rng.normal(0, 0.5, (24, 1)))
    grid = np.exp(rng.normal(0, 0.5, (n * n, 1)))
    kgv, kgh = rng.normal(0, 1, (2, 24))
    return x, K, grid, kgv, kgh


def _fc_losses(mod, net, x, K, grid, kgv, kgh, n=8):
    """The FC losses of ``mod`` (the port's or JAX's ops.darcy) for one
    network; JAX networks are (model_fn, params) pairs."""
    call = ((lambda f, *a: f(net[0], net[1], *a)) if mod is jd
            else (lambda f, *a: f(net, *a)))
    return [call(mod.mixed_residual_fc, x, K),
            call(mod.mixed_residual_fc, x, grid, True, n),
            call(mod.primal_residual_fc, x, kgv, kgh, K[:, 0]),
            call(mod.primal_variational_fc, x, K),
            call(mod.neumann_boundary, x),
            call(mod.neumann_boundary_mixed, x)]


def _port_fc(params, case, dtype):
    model = _torch_cppn("cppn", params, dtype, **CPPN_KW["cppn"])
    names = [n for n, _ in model.named_parameters()]
    p = {n: v.detach().clone().requires_grad_(True)
         for n, v in model.named_parameters()}
    vals, grads = [], []
    for v in _fc_losses(td, (model, p),
                        *(torch.from_numpy(a).to(dtype) for a in case)):
        g = torch.autograd.grad(v, [p[n] for n in names], allow_unused=True)
        vals.append(float(v.detach()))
        grads.append(np.concatenate([
            (np.zeros(p[n].numel()) if gi is None else
             gi.detach().double().numpy().ravel()) for n, gi in zip(names, g)]))
    return np.array(vals), grads


def _jax_fc(params, case, x64):
    """JAX's values and flax-parameter gradients, flattened in the port's
    parameter order (Dense kernels transposed)."""
    dtype = np.float64 if x64 else np.float32
    jm = jcppn.CPPN(**CPPN_KW["cppn"])
    with jax.enable_x64(x64):
        pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(dtype)),
                                    params)
        arrays = [jnp.asarray(a.astype(dtype)) for a in case]
        model_fn = lambda p, pts: jm.apply({"params": p}, pts)  # noqa: E731

        def f(p):
            return jnp.stack(_fc_losses(jd, (model_fn, p), *arrays))

        vals, jac = jax.jit(lambda p: (f(p), jax.jacrev(f)(p)))(pj)
        vals = np.asarray(vals, np.float64)
    sd_order = [n for n, _ in _torch_cppn("cppn", params, **CPPN_KW["cppn"])
                .named_parameters()]
    grads = []
    for i in range(len(vals)):
        flat = []
        for key in sd_order:
            layer, leaf = key.rsplit(".", 1)
            g = np.asarray(jac[layer]["kernel" if leaf == "weight"
                                      else "bias"][i], np.float64)
            flat.append((g.T if leaf == "weight" else g).ravel())
        grads.append(np.concatenate(flat))
    return vals, grads


def test_fc_losses_and_parameter_gradients_match_jax():
    """mixed_residual_fc (on the grid and off it, with bilinear K),
    primal_residual_fc (per-point Hessians), primal_variational_fc,
    neumann_boundary and neumann_boundary_mixed: values and the gradients
    with respect to every CPPN parameter, which flow through the per-point
    Jacobians, against ``jax.jacrev`` of the same losses."""
    _, params = _jax_cppn("cppn", **CPPN_KW["cppn"])
    case = _fc_case()
    t32 = _port_fc(params, case, torch.float32)
    t64 = _port_fc(params, case, torch.float64)
    j32 = _jax_fc(params, case, False)
    j64 = _jax_fc(params, case, True)
    own = np.abs(j32[0] - j64[0])
    assert (np.abs(t32[0] - j32[0])
            <= np.maximum(1e-5 * np.abs(j32[0]), 3 * own)).all()
    np.testing.assert_allclose(t64[0], j64[0], rtol=1e-10)
    for g, g64, gj, gj64 in zip(t32[1], t64[1], j32[1], j64[1]):
        assert np.abs(gj).max() > 0
        bound = max(1e-5 * np.abs(gj).max(), 3 * np.abs(gj - gj64).max())
        assert np.abs(g - gj).max() <= bound
        assert np.abs(g64 - gj64).max() <= 1e-10 * np.abs(gj64).max()


def test_bilinear_interpolate_matches_jax():
    """Interior points, the top/right edge (the clamped cell) and the
    corners: the same values as JAX (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    im = rng.normal(0, 1, (7, 9)).astype(np.float32)
    x = np.concatenate([rng.random(20) * 8, [0.0, 8.0, 8.0]]).astype(np.float32)
    y = np.concatenate([rng.random(20) * 6, [0.0, 6.0, 0.0]]).astype(np.float32)
    np.testing.assert_allclose(
        td.bilinear_interpolate(*map(torch.from_numpy, (im, x, y))).numpy(),
        np.asarray(jd.bilinear_interpolate(*map(jnp.asarray, (im, x, y)))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def test_decoder_train_mode_matches_flax():
    """The solver's Decoder (blocks 2,2, growth 4, 8 init features, nz 2)
    with the flax weights: the train-mode forward (batch statistics) on a
    (1, nz, 4, 4) latent within 1e-5, the updated running statistics
    within 1e-6, the reference module names, and the same parameter
    count."""
    kw = dict(blocks=[2, 2], growth_rate=4, init_features=8)
    latent = np.random.default_rng(0).normal(0, 0.5, (1, 4, 4, 2)).astype(
        np.float32)
    jm = jcodec.Decoder(2, 3, **kw)
    var = jm.init(jax.random.key(0), jnp.asarray(latent), train=False)
    out_j, mut = jm.apply(var, jnp.asarray(latent), train=True,
                          mutable=["batch_stats"])
    tm = tcodec.Decoder(2, 3, **kw)
    sd = codec_state_dict_from_jax(var["params"], var["batch_stats"])
    tm.load_state_dict(sd)
    assert sorted(sd) == sorted(tm.state_dict())
    assert "features.Conv0.weight" in sd
    assert "features.TransUp1.conv2.weight" in sd
    tm.train()
    out_t = tm(torch.from_numpy(np.moveaxis(latent, -1, 1)))
    assert out_t.shape == (1, 3, 16, 16)
    np.testing.assert_allclose(out_t.detach().numpy(),
                               np.moveaxis(np.asarray(out_j), -1, 1),
                               rtol=1e-5, atol=1e-5)
    after = codec_state_dict_from_jax(var["params"], mut["batch_stats"])
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                       rtol=1e-6, atol=1e-6)
    n_j = sum(np.size(a) for a in jax.tree_util.tree_leaves(var["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_j


# ---------------------------------------------------------------------------
# L-BFGS against optax, the Adam warmup
# ---------------------------------------------------------------------------


def _lsq():
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((30, 8)), rng.standard_normal(30)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    return (lambda x: jnp.sum((jnp.asarray(A) @ x - jnp.asarray(b)) ** 2),
            lambda x: torch.sum((At @ x - bt) ** 2), np.zeros(8))


def _rosenbrock():
    x0 = np.array([-1.2, 1.0, -1.5, 2.0, 0.3])
    return (lambda x: jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2
                              + (1 - x[:-1]) ** 2),
            lambda x: torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2
                                + (1 - x[:-1]) ** 2), x0)


def _tiny_cppn():
    """The mixed residual of a CPPN 2-8-8-3 on 32 points, in float64; the
    JAX loss takes the port's flat parameter vector."""
    kw = dict(dim_in=2, dim_out=3, dim_hidden=8, layers_hidden=2)
    jm, params = _jax_cppn("cppn", **kw)
    tm = _torch_cppn("cppn", params, torch.float64, **kw)
    flat = tlb.FlatParams(tm)
    rng = np.random.default_rng(4)
    x, K = rng.random((32, 2)), np.exp(rng.normal(0, 0.5, (32, 1)))
    xt, Kt = torch.from_numpy(x), torch.from_numpy(K)
    names, shapes = flat.names, flat.shapes

    def j_loss(v):
        p, off = {}, 0
        for name, shape in zip(names, shapes):
            size = int(np.prod(shape))
            a = v[off:off + size].reshape(shape)
            off += size
            layer, leaf = name.rsplit(".", 1)
            p.setdefault(layer, {})["kernel" if leaf == "weight"
                                    else "bias"] = a.T if leaf == "weight" else a
        return jd.mixed_residual_fc(lambda q, pts: jm.apply({"params": q}, pts),
                                    p, jnp.asarray(x), jnp.asarray(K))

    def t_loss(v):
        return td.mixed_residual_fc((tm, flat.unflatten(v)), xt, Kt)

    return j_loss, t_loss, flat.vector().numpy()


def _optax_iterates(j_loss, x0, lr, n):
    with jax.enable_x64(True):
        opt = jlb.lbfgs_optimizer(learning_rate=lr)
        x = jnp.asarray(x0, jnp.float64)
        state = opt.init(x)
        epoch = jlb.make_lbfgs_epoch(j_loss, opt, iters_per_epoch=1,
                                     with_linesearch=lr is None)
        out = []
        for _ in range(n):
            x, state, _ = epoch(x, state)
            step = (float(state[2].learning_rate) if lr is None else lr)
            out.append((np.asarray(x), step))
    return out


@pytest.mark.parametrize("problem", ["least_squares", "rosenbrock",
                                     "tiny_cppn"])
@pytest.mark.parametrize("linesearch", ["fixed", "zoom"])
def test_lbfgs_iterates_match_optax(problem, linesearch):
    """10 L-BFGS steps (memory 50) from the same start in float64: the
    iterates equal optax's within 1e-10 with fixed lr-0.5 steps and within
    1e-8 with the zoom linesearch, whose accepted step sizes agree within
    1e-8 too (on the Rosenbrock problem several steps take 2-3 linesearch
    evaluations, so the zoom's interpolation runs)."""
    j_loss, t_loss, x0 = {"least_squares": _lsq, "rosenbrock": _rosenbrock,
                          "tiny_cppn": _tiny_cppn}[problem]()
    lr = 0.5 if linesearch == "fixed" else None
    if problem == "rosenbrock" and lr is not None:
        lr = 1e-3                      # a fixed 0.5 step diverges there
    ref = _optax_iterates(j_loss, x0, lr, 10)
    opt = tlb.lbfgs_optimizer(learning_rate=lr)
    x = torch.from_numpy(np.array(x0, np.float64))
    state = opt.init(x)
    epoch = tlb.make_lbfgs_epoch(t_loss, opt, iters_per_epoch=1,
                                 with_linesearch=lr is None)
    tol = 1e-10 if lr is not None else 1e-8
    steps = []
    for x_ref, step_ref in ref:
        x, state, _ = epoch(x, state)
        scale = max(1.0, np.abs(x_ref).max())
        assert np.abs(x.numpy() - x_ref).max() <= tol * scale
        if lr is None:
            assert abs(state.stepsize - step_ref) <= tol
            steps.append(state.linesearch_steps)
    assert np.isfinite(x.numpy()).all()
    if lr is None and problem == "rosenbrock":
        assert max(steps) >= 2


LINESEARCH_FUNCS = {
    "quartic": (lambda x: jnp.sum(x ** 4) + 0.5 * jnp.sum(x ** 2),
                lambda x: torch.sum(x ** 4) + 0.5 * torch.sum(x ** 2)),
    "wavy": (lambda x: jnp.sum(jnp.sin(3 * x) + 0.1 * x ** 2),
             lambda x: torch.sum(torch.sin(3 * x) + 0.1 * x ** 2))}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
@pytest.mark.parametrize("name", list(LINESEARCH_FUNCS))
def test_zoom_linesearch_matches_optax(name, scale):
    """One zoom linesearch along -scale * grad from three random points, in
    float64: the accepted step within 1e-10 relative and the number of
    linesearch steps equal to optax's ``scale_by_zoom_linesearch``
    (20 steps, initial guess 1).  A short direction grows the interval
    (up to 8 doublings), a long one zooms with cubic, quadratic and
    bisection steps (up to 12 evaluations)."""
    j_fn, t_fn = LINESEARCH_FUNCS[name]
    for seed in range(3):
        x0 = np.random.default_rng(seed).normal(0, 2, 6)
        with jax.enable_x64(True):
            ls = optax.scale_by_zoom_linesearch(
                max_linesearch_steps=20, initial_guess_strategy="one")
            x = jnp.asarray(x0)
            v, g = jax.value_and_grad(j_fn)(x)
            _, st = ls.update(-scale * g, ls.init(x), x, value=v, grad=g,
                              value_fn=j_fn)
            want, want_n = (float(st.learning_rate),
                            int(st.info.num_linesearch_steps))
        xt = torch.from_numpy(x0)
        vt, gt = tlb.value_and_grad(t_fn, xt)
        step, value, _, n = tlb._zoom_linesearch(t_fn, xt, -scale * gt,
                                                 float(vt), gt, 20)
        assert n == want_n, (seed, n, want_n)
        assert abs(step - want) <= 1e-10 * max(1.0, abs(want)), (seed, step)
        assert value == float(t_fn(xt + step * (-scale * gt)))


def test_lbfgs_epoch_reports_returned_params_loss():
    """The epoch's loss is loss(returned params), and ``evals`` counts the
    epoch's loss evaluations: the value and gradient the linesearch cached
    are reused, so a step costs its linesearch evaluations only, plus one
    fresh evaluation when nothing is cached, plus the report."""
    _, t_loss, x0 = _rosenbrock()
    opt = tlb.lbfgs_optimizer(learning_rate=None)
    x = torch.from_numpy(x0)
    state = opt.init(x)
    epoch = tlb.make_lbfgs_epoch(t_loss, opt, iters_per_epoch=1)
    for i in range(8):
        x, state, reported = epoch(x, state)
        assert float(reported) == float(t_loss(x))
        assert state.evals == (i == 0) + state.linesearch_steps + 1
    assert state.count == 8
    x, state, _ = tlb.make_lbfgs_epoch(t_loss, opt, 5)(x, state)
    assert state.count == 13 and state.evals >= 5 + 1
    fixed = tlb.lbfgs_optimizer(learning_rate=0.1)
    s2 = fixed.init(x)
    x2, s2, rep2 = tlb.make_lbfgs_epoch(t_loss, fixed, 3, False)(x, s2)
    assert float(rep2) == float(t_loss(x2)) and s2.evals == 4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_warmup_matches_jax(dtype):
    """20 Adam steps at lr 2e-3 on the least-squares problem: the returned
    params and loss equal ``run_adam_warmup``'s (float64 within 1e-12,
    float32 within 1e-5 relative)."""
    rng = np.random.default_rng(1)
    A, b = rng.standard_normal((30, 8)), rng.standard_normal(30)
    x0 = rng.standard_normal(8)
    x64 = dtype == "float64"
    with jax.enable_x64(x64):
        Aj, bj = jnp.asarray(A.astype(dtype)), jnp.asarray(b.astype(dtype))
        xj, lj = jlb.run_adam_warmup(
            lambda x: jnp.sum((Aj @ x - bj) ** 2), jnp.asarray(x0.astype(dtype)),
            20, 2e-3)
        xj = np.asarray(xj)
    At, bt = torch.from_numpy(A.astype(dtype)), torch.from_numpy(b.astype(dtype))
    xt, lt = tlb.run_adam_warmup(lambda x: torch.sum((At @ x - bt) ** 2),
                                 torch.from_numpy(x0.astype(dtype)), 20, 2e-3)
    tol = 1e-12 if x64 else 1e-5
    np.testing.assert_allclose(xt.numpy(), xj, rtol=tol, atol=tol)
    np.testing.assert_allclose(lt, lj, rtol=tol)
    assert not np.allclose(xj, x0)

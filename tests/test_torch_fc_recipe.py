"""The FC solver's objective, Adam warmup and zoom step against JAX.

Both packages build the objective as their ``solve_fc_mixed_residual``
CLIs do (the collocation residual plus ``weight_bound`` times the
Dirichlet and Neumann terms, ``pde_surrogate_tpu/cli/
solve_fc_mixed_residual.py:127-134``), at a small size: a CPPN of 3
hidden layers of 16 at 16², weight bound 10, the full grid as collocation
points (256, on the grid), 256 Dirichlet points on each of the left and
right sides off the grid and the top and bottom rows, all drawn by the
CLI's sampler from seed 1, on one ``sample_kle`` field (64 terms, seed
1).  The flax CPPN's weights (``model.init`` from key 1) are moved
into the port (``utils/from_jax.cppn_state_dict_from_jax``); the JAX loss
takes the port's flat parameter vector, cut back into the flax tree.

Cases of one test (measured on a CPU with the JAX side given 1, 4 and 8
cores: the same numbers on each):

* ``objective``: the loss at the start within 1e-5 relative and its
  gradient within 1e-4 of its largest value, both in float32 (measured:
  0 and 2.7e-7).
* ``warmup``: 200 Adam steps at lr 2e-3 (the CLIs' ``--adam-lr``), the
  port in float64 against ``run_adam_warmup`` in the JAX package's own
  precision (float32): the losses within 2e-5 relative (measured: 3.3e-6,
  the JAX side's float32 drift; the port's own float32 warmup lies 2.7e-7
  from its float64 one).  The loss falls from 7.73 to 0.479.
* ``zoom``: one zoom L-BFGS iteration from the JAX warmup's end, the port
  in float64 against the JAX package in float32: the same number of
  linesearch steps (2), the accepted step within 2e-3 relative and the
  loss after it within 5e-5 relative (measured: 1.3e-5 and 8.6e-8).

Why this field and these bounds.  The port's own float64 warmup moves by
at most 6.1e-8 when its start is perturbed by 1e-7 relative (three
draws), so 200 steps stay on one trajectory: unlike the conv solver's
train-mode BatchNorm, the tanh CPPN has no kinks.  Over the fields of
seeds 1 to 6 the same measurements give the warmup 5.4e-7 to 3.3e-6, the
zoom's step 1.3e-5 to 3.1e-4 and its loss 8.2e-8 to 7.3e-6, with 2
linesearch steps on each; each bound is about 6x the largest of them.
Seed 1 is the first field.  The recipe's 4000 Adam steps and 2000 zoom
epochs are not held step by step here: the JAX side's float32 drift
grows with the horizon, and the whole recipe is held by where its runs
land (ROADMAP R4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.models.cppn import CPPN as TCPPN
from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops.sampling import SampleSpatial2d
from pde_surrogate_torch.train import lbfgs as tlb
from pde_surrogate_torch.utils.from_jax import cppn_state_dict_from_jax
from pde_surrogate_tpu.models.cppn import CPPN as JCPPN
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.train import lbfgs as jlb

torch.set_num_threads(1)

IMSIZE, WEIGHT_BOUND, FIELD_SEED = 16, 10.0, 1
CPPN_KW = dict(dim_in=2, dim_out=3, dim_hidden=16, layers_hidden=3)
ADAM_STEPS, ADAM_LR = 200, 2e-3
WARMUP_BOUND, STEP_BOUND, ZOOM_BOUND = 2e-5, 2e-3, 5e-5


class _Recipe:
    """Both objectives on one start: ``j_loss`` (JAX, float32) and
    ``t_loss(dtype)`` (the port) of the port's flat vector ``x0``."""

    def __init__(self, field_seed: int = FIELD_SEED):
        sampler = SampleSpatial2d(IMSIZE, IMSIZE, rng=1)
        colloc = sampler.colloc(True, n_samples=IMSIZE * IMSIZE)
        dirichlet = np.concatenate(
            [sampler.left(on_grid=False, n_samples=256),
             sampler.right(on_grid=False, n_samples=256)], 0)
        neumann = np.concatenate([sampler.top(True), sampler.bottom(True)], 0)
        K = sample_kle(1, IMSIZE, 64, rng=np.random.default_rng(field_seed))
        iy = np.rint(colloc[:, 0] * (IMSIZE - 1)).astype(int)
        ix = np.rint(colloc[:, 1] * (IMSIZE - 1)).astype(int)
        K_colloc = K[0][iy, ix].reshape(-1, 1).astype(np.float32)
        y_diri = np.concatenate([np.ones((256, 1)), np.zeros((256, 1))],
                                0).astype(np.float32)
        self.arrays = [a.astype(np.float32) for a in
                       (colloc, K_colloc, dirichlet, y_diri, neumann)]

        jm = JCPPN(**CPPN_KW)
        params = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.key(1), jnp.zeros((1, 2)))["params"])
        self.state_dict = cppn_state_dict_from_jax(params)
        shapes = [(n, tuple(p.shape)) for n, p in
                  TCPPN(**CPPN_KW).named_parameters()]
        self.x0 = np.concatenate([self.state_dict[n].numpy().reshape(-1)
                                  for n, _ in shapes])

        def tree(v):
            out, o = {}, 0
            for n, shape in shapes:
                a = v[o:o + int(np.prod(shape))].reshape(shape)
                o += a.size
                layer, leaf = n.rsplit(".", 1)
                out.setdefault(layer, {})[
                    "kernel" if leaf == "weight" else "bias"] = (
                    a.T if leaf == "weight" else a)
            return out

        def model_fn(p, pts):
            return jm.apply({"params": p}, pts)

        xc, kc, xd, yd, xn = map(jnp.asarray, self.arrays)

        def j_loss(v):
            p = tree(v)
            loss_colloc = jd.mixed_residual_fc(model_fn, p, xc, kc,
                                               rand_colloc=False,
                                               imsize=IMSIZE)
            loss_diri = jnp.mean((model_fn(p, xd)[:, 0:1] - yd) ** 2)
            loss_neum = jd.neumann_boundary_mixed(model_fn, p, xn)
            return loss_colloc + WEIGHT_BOUND * (loss_diri + loss_neum)

        self.j_loss = j_loss

    def t_loss(self, dtype):
        model = TCPPN(**CPPN_KW)
        model.load_state_dict(self.state_dict)
        model.to(dtype)
        flat = tlb.FlatParams(model)
        xc, kc, xd, yd, xn = (torch.from_numpy(a).to(dtype)
                              for a in self.arrays)

        def loss(v):
            net = (model, flat.unflatten(v))
            loss_colloc = td.mixed_residual_fc(net, xc, kc, rand_colloc=False,
                                               imsize=IMSIZE)
            loss_diri = torch.mean((torch.func.functional_call(
                model, net[1], (xd,))[:, 0:1] - yd) ** 2)
            loss_neum = td.neumann_boundary_mixed(net, xn)
            return loss_colloc + WEIGHT_BOUND * (loss_diri + loss_neum)

        return loss

    @functools.cached_property
    def jax_warmup(self):
        x, loss = jlb.run_adam_warmup(self.j_loss, jnp.asarray(self.x0),
                                      ADAM_STEPS, ADAM_LR)
        return np.asarray(x), loss


@pytest.fixture(scope="module")
def recipe():
    return _Recipe()


def _objective(r):
    lj, gj = jax.jit(jax.value_and_grad(r.j_loss))(jnp.asarray(r.x0))
    lt, gt = tlb.value_and_grad(r.t_loss(torch.float32),
                                torch.from_numpy(r.x0))
    gj = np.asarray(gj)
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def _warmup(r):
    _, lj = r.jax_warmup
    _, lt = tlb.run_adam_warmup(r.t_loss(torch.float64),
                                torch.from_numpy(r.x0.astype(np.float64)),
                                ADAM_STEPS, ADAM_LR)
    assert lj < 0.1 * float(r.j_loss(jnp.asarray(r.x0)))
    assert abs(lt - lj) <= WARMUP_BOUND * lj


def _zoom(r):
    xw, _ = r.jax_warmup
    opt = jlb.lbfgs_optimizer(memory_size=50, learning_rate=None)
    _, state, lj = jlb.make_lbfgs_epoch(r.j_loss, opt, iters_per_epoch=1)(
        jnp.asarray(xw), opt.init(jnp.asarray(xw)))
    zoom = state[2]                    # optax's ScaleByZoomLinesearchState
    step_j = float(zoom.learning_rate)
    n_j = int(zoom.info.num_linesearch_steps)
    t_opt = tlb.lbfgs_optimizer(memory_size=50, learning_rate=None)
    xt = torch.from_numpy(xw.astype(np.float64))
    _, t_state, lt = tlb.make_lbfgs_epoch(r.t_loss(torch.float64), t_opt,
                                          iters_per_epoch=1)(
        xt, t_opt.init(xt))
    assert t_state.linesearch_steps == n_j
    assert abs(t_state.stepsize - step_j) <= STEP_BOUND * step_j
    assert float(lj) < r.jax_warmup[1]
    assert abs(float(lt) - float(lj)) <= ZOOM_BOUND * float(lj)


@pytest.mark.parametrize("case", ["objective", "warmup", "zoom"])
def test_fc_solver_recipe_matches_jax(recipe, case):
    {"objective": _objective, "warmup": _warmup, "zoom": _zoom}[case](recipe)

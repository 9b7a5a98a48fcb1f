"""The conv solver's objective, Adam warmup and zoom step against JAX.

Both packages build the objective as their ``solve_conv_mixed_residual``
CLIs do, at a small size: a Decoder [2, 2] (growth 16, 48 features) at
16², nz 1, the latent 0.5·N(0, 1) from ``np.random.default_rng(1)``, the
5x5 Sobel stencils with ``correct=True``, train-mode BatchNorm and
boundary weight 10, on one ``sample_kle`` field (64 terms, seed 3).  The
JAX Decoder's weights (drawn as its initialisers draw them) are moved
into the port (``utils/from_jax.codec_state_dict_from_jax``) and the JAX
loss takes the port's flat parameter vector, permuted back into the flax
tree.

Cases of one test (measured on a CPU with the JAX side given 1, 4 and 8
cores, whose float32 sums XLA orders differently):

* ``objective``: the loss at the start within 1e-5 relative and its
  gradient within 1e-4 of its largest value, both in float32 (measured:
  7.0e-8 to 1.4e-7 and 9.6e-7 to 1.2e-6).
* ``warmup``: 200 Adam steps at lr 2e-3, the port in float64 against
  ``run_adam_warmup`` in the JAX package's own precision (float32): the
  losses within 2e-4 relative (measured: 4.2e-5 to 4.8e-5, the JAX
  side's float32 drift; the port's own float32 warmup lies 4.3e-6 from
  its float64 one).
* ``zoom``: one zoom L-BFGS iteration from the JAX warmup's end, the port
  in float64 against the JAX package in float32: the same number of
  linesearch steps, the accepted step within 1e-2 relative and the loss
  after it within 1.5e-4 relative (measured: 4.8e-5 to 4.1e-3 and 3.5e-7
  to 5.3e-5; up to 5.8e-3 and 7.6e-5 from starts perturbed by 1e-7
  relative: the zoom interpolates on value differences of ~1e-2 of the
  loss, and float32 resolves them to ~1e-5).

Why no longer horizon is held, and why this field.  The objective has
ReLU kinks under train-mode BatchNorm, and a rounding can move a
trajectory across one within a few steps.  The port's own float64
warmup moves by 6e-8 to 3.2e-2 on the fields of seeds 1 to 12 when its
start is perturbed by 1e-7 relative.  Seed 3 is the first seed whose
warmup moves less than 2e-7 under three such perturbations; on seed 2
both packages' float32 warmups land 3.2e-2 from the float64 one, on any
core count.  After one epoch of 20 zoom iterations the losses part even
on seed 3:

=========================================  ===========  ================
Losses compared (relative difference)      200 Adam     then 20 zoom
                                           steps        iterations
=========================================  ===========  ================
seed 3: both packages in float32           5.1e-5       4.3e-2
seed 3: the port in float64 against the    4.6e-5       3.4e-2
JAX package's own precision
seed 2: both packages in float32           3.2e-2       1.9e-2
seed 2: the port in float64 against the    3.2e-2       1.1e-2
JAX package's own precision
=========================================  ===========  ================

The JAX package cannot run in float64 (its Decoder casts its output to
float32 and its Sobel operators are float32 constants), so a whole
recipe is held by where its runs land (``tools/f1_seeds.py``), not step
by step; ``test_f1_seeds_parses_solver_logs`` holds that tool's reading
of the JAX package's logs and the port's.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.models.codec import Decoder as TDecoder
from pde_surrogate_torch.ops import darcy as td
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.train import lbfgs as tlb
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import Decoder as JDecoder
from pde_surrogate_tpu.ops import darcy as jd
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import lbfgs as jlb

torch.set_num_threads(1)

IMSIZE, BLOCKS, WEIGHT_BOUND, SOBEL_SIZE = 16, [2, 2], 10.0, 5
ADAM_STEPS, ADAM_LR = 200, 2e-3


def _jax_decoder_weights(model, latent):
    """The Decoder's flax (params, batch_stats), drawn as its initialisers
    draw them (conv kernels U(+-1/sqrt(fan_in)), BatchNorm scale 1 and
    bias 0, statistics 0 and 1) from numpy seed 1: ``model.init`` takes
    20-30 s on one CPU core."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(1), latent,
                                               train=False))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        return np.full(leaf.shape, name in ("scale", "var"), np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables["batch_stats"]


class _Recipe:
    """Both objectives on one start: ``j_loss`` (JAX, float32) and
    ``t_loss(dtype)`` (the port) of the port's flat vector ``x0``."""

    def __init__(self):
        rng = np.random.default_rng(1)
        latent = (rng.standard_normal((1, IMSIZE // 4, IMSIZE // 4, 1))
                  .astype(np.float32) * 0.5)
        K = sample_kle(1, IMSIZE, 64, rng=np.random.default_rng(3))
        K = K[:, None].astype(np.float32)                   # (1, 1, H, W)
        jm = JDecoder(1, out_channels=3, blocks=BLOCKS)
        params, batch_stats = _jax_decoder_weights(jm, latent)
        self.state_dict = codec_state_dict_from_jax(params, batch_stats)
        names = [n for n, _ in TDecoder(1, 3, BLOCKS).named_parameters()]

        # where each flax leaf's entries sit in the port's flat vector
        leaves, treedef = jax.tree_util.tree_flatten(params)
        sizes = [leaf.size for leaf in leaves]
        offsets = np.cumsum([0] + sizes)
        ids = [np.arange(o, o + s, dtype=np.float64).reshape(leaf.shape)
               for o, s, leaf in zip(offsets, sizes, leaves)]
        id_sd = codec_state_dict_from_jax(
            jax.tree_util.tree_unflatten(treedef, ids), batch_stats)
        port_of = np.concatenate([id_sd[n].numpy().reshape(-1)
                                  for n in names]).astype(np.int64)
        to_jax = np.empty_like(port_of)
        to_jax[port_of] = np.arange(port_of.size)
        self.x0 = np.concatenate([self.state_dict[n].numpy().reshape(-1)
                                  for n in names])

        sobel = JSobel(IMSIZE, correct=True, filter_size=SOBEL_SIZE)
        Kj, zj = jnp.asarray(np.moveaxis(K, 1, -1)), jnp.asarray(latent)

        def j_loss(v):
            flat = v[to_jax]
            tree = jax.tree_util.tree_unflatten(treedef, [
                flat[o:o + s].reshape(leaf.shape)
                for o, s, leaf in zip(offsets, sizes, leaves)])
            out, _ = jm.apply({"params": tree, "batch_stats": batch_stats},
                              zj, train=True, mutable=["batch_stats"])
            energy = (jd.conv_constitutive_constraint(Kj, out, sobel)
                      + jd.conv_continuity_constraint(out, sobel))
            diri, neum = jd.conv_boundary_condition(out)
            return energy + (diri + neum) * WEIGHT_BOUND

        self.j_loss = j_loss
        self.K = torch.from_numpy(K)
        self.latent = torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(latent, -1, 1)))

    def t_loss(self, dtype):
        model = TDecoder(1, 3, BLOCKS)
        model.load_state_dict(self.state_dict)
        model.to(dtype).train()
        flat = tlb.FlatParams(model)
        sobel = TSobel(IMSIZE, correct=True, filter_size=SOBEL_SIZE)
        K, latent = self.K.to(dtype), self.latent.to(dtype)

        def loss(v):
            out = torch.func.functional_call(model, flat.unflatten(v),
                                             (latent,))
            energy = (td.conv_constitutive_constraint(K, out, sobel)
                      + td.conv_continuity_constraint(out, sobel))
            diri, neum = td.conv_boundary_condition(out)
            return energy + (diri + neum) * WEIGHT_BOUND

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
    assert lj < 0.01 * float(r.j_loss(jnp.asarray(r.x0)))
    assert abs(lt - lj) <= 2e-4 * lj


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
    assert abs(t_state.stepsize - step_j) <= 1e-2 * step_j
    assert float(lj) < r.jax_warmup[1]
    assert abs(float(lt) - float(lj)) <= 1.5e-4 * float(lj)


@pytest.mark.parametrize("case", ["objective", "warmup", "zoom"])
def test_conv_solver_recipe_matches_jax(recipe, case):
    {"objective": _objective, "warmup": _warmup, "zoom": _zoom}[case](recipe)


PORT_LOG = """initial weights and latent: f1_jax_init_seed1.npz
Adam warmup (20000 steps): loss 0.002886, 10.082 ms/step
start training...
epoch 1: loss 0.001318, 31 loss evaluations, 0.437 s
epoch 2: loss 0.001325, 21 loss evaluations, 0.265 s
epoch 3: loss 0.001181, 23 loss evaluations, 0.300 s
epoch 3: relative l2 [0.0982 0.0299 0.2073]
Finished optimization for 3 epochs using 0.017 minutes
"""


@pytest.mark.parametrize("log", ["tpu", "jax_cpu_f32", "port"])
def test_f1_seeds_parses_solver_logs(log):
    """``tools/f1_seeds.parse_log`` reads the JAX package's logs of the
    canonical recipe (the committed TPU run, and its float32 run on a CPU
    from the start in ``f1_jax_init_seed1.npz``: warmups, losses, rises
    and rel-L2 as the records quote them) and the port's log alike, the
    port's Adam ms per step and median seconds per L-BFGS epoch too."""
    from pde_surrogate_torch.tools.f1_seeds import parse_log
    logs = pathlib.Path(__file__).resolve().parents[1] / "logs"
    if log == "jax_cpu_f32":
        got = parse_log((logs / "f1_jax_cpu_f32_seed1.log").read_text())
        assert got["adam_loss"] == 0.005159
        assert got["loss_at"] == {1: 0.003711, 50: 0.002667, 500: 0.00063}
        assert got["rises"] == 0
        assert got["rel_l2_at"][50] == [0.06893154, 0.04803004, 0.2189452]
        assert got["rel_l2_at"][500] == [0.10617821, 0.03536435, 0.22007394]
        assert got["lbfgs_minutes"] == 54.615
    elif log == "tpu":
        got = parse_log((logs / "solve_conv_kle1024_longadam.log")
                        .read_text())
        assert got["adam_loss"] == 0.007148
        assert got["loss_at"] == {1: 0.004106, 50: 0.003889, 500: 0.003899}
        assert got["rises"] == 239
        assert got["rel_l2_at"][500] == [0.05916943, 0.05139192, 0.2527714]
        assert got["rel_l2_at"][50][0] == 0.05903615
        assert got["adam_ms_per_step"] is None
        assert got["lbfgs_minutes"] == 5.002
    else:
        got = parse_log(PORT_LOG)
        assert got["adam_loss"] == 0.002886 and got["final_loss"] == 0.001181
        assert got["rises"] == 1 and got["rel_l2"] == [0.0982, 0.0299, 0.2073]
        assert got["adam_ms_per_step"] == 10.082
        assert got["lbfgs_s_per_epoch"] == 0.300
        assert got["lbfgs_minutes"] == 0.017

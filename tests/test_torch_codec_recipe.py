"""The codec CLI's training loop over several epochs against the JAX package.

Both packages run the loop of their ``train_codec_mixed_residual`` CLIs at
the CLIs' settings, at a small size: a DenseED [1, 2, 1] (growth 4, 8
initial features; the JAX one with ``shared_stats=True``, its CLI's
default) at 16², 32 train fields of ``sample_kle`` (512 terms, seed 1),
batch 8, 3 epochs (12 steps), Adam under OneCycle over the 12 steps (lr
1e-3, div 2, pct 0.3) as both CLIs compute ``total_steps``, the 3x3 Sobel
mixed residual (``correct=True``) with boundary weight 10 and the CLIs'
coupled L2 (weight decay 0).  After each epoch the eval step runs on 16
labelled val fields in batches of 8 with BatchNorm on its running
statistics, and R² comes from each package's ``r2_score`` with the
``y_variation`` of each package's ``load_data`` of one val file.  The
JAX weights are drawn as its initialisers draw them and moved into the
port (``utils/from_jax.codec_state_dict_from_jax``); both packages take
the same batches, one numpy permutation per epoch.

The JAX package runs in its own float32; the port runs in float64, the
reference, and in float32.  Cases, each holding the JAX package against
the port's float64 run (measured with the JAX side on 1, 4 and 8 CPU
cores, whose float32 sums XLA orders differently):

* ``steps``: every step's loss and its three parts within 3e-5
  relative (measured 1.05e-5);
* ``evals``: every epoch's val R², rel-L2 and consistency within 5e-6
  relative (measured 1.54e-6);
* ``state``: the final parameters within 7e-5 and the BatchNorm running
  statistics within 4e-6 of each tensor's largest value (measured
  2.31e-5 and 1.32e-6), the step count 12 on both;
* ``port_f32``: the port's own float32 run against its float64 run,
  within the same bounds (measured 7.0e-7, 6.8e-7, 5.2e-6 and 5.1e-7).

The JAX side gave the same numbers on 1, 4 and 8 cores: at this size
XLA splits no sum over threads.

The recommended objective, ``--physics fvcg`` (``test_codec_recipe_fvcg_
matches_jax``): the same loop with the CG-preconditioned error objective
at the CLIs' ``--fvcg-iters`` default, the grid size (16 CG iterations),
unrolled under autograd in both packages, in the train steps and the
evals.  Its field is seed 2, by the rule of "Why seed 1": on seed 1 the port's
float64 fvcg loop moves by 1.4e-6 to 2.5e-6 under the three 1e-7
perturbations, on seed 2 by 3.1e-7 to 8.2e-7.  Bounds, each about 3x the
JAX package's float32 distance from the port's float64 run (measured on
1, 4 and 8 cores, the largest given): steps 1e-5 (3.35e-6), evals 6e-6
(1.86e-6), parameters 2.5e-5 (7.74e-6), BatchNorm statistics 9e-6
(2.97e-6); the port's float32 run lies 7.9e-7, 2.1e-7, 2.2e-6 and 4.9e-7
from its float64 run.  The fvcg loop takes ~6 s on one core.

Why seed 1.  Adam's first steps divide by the gradient's own size, so a
rounding in a small gradient moves its parameter by a share of the lr;
under train-mode BatchNorm the objective also has ReLU kinks, and a
rounding can carry a trajectory across one.  On the fields of seeds 1 to
10 the port's float64 loop moves by 3.9e-7 to 1.4e-2 (losses and eval
metrics) when its start is perturbed three times by 1e-7 relative.
Seed 1 is the first whose every such move stays below 1e-6 (7.7e-7 to
8.7e-7); its parameters move by up to 1.0e-5 of their largest value,
which is why the parameter bound is the widest.  On seed 3 (moves of
1.0e-5 to 1.7e-5) the JAX package's float32 losses lie 3.2e-2 from the
port's float64 ones while the port's float32 losses lie 9.6e-6 from
them: a kink crossed in one package and not in the other, not a fault of
either.  The loop takes ~7 s on 4 cores, ~14 s on one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.data.hdf5 import load_data as t_load_data
from pde_surrogate_torch.data.hdf5 import save_dataset
from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.solvers.fd_darcy import solve_darcy_batch_fast
from pde_surrogate_torch.train import codec_trainer as ttr
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_torch.utils.metrics import r2_score as t_r2_score
from pde_surrogate_tpu.data.hdf5 import load_data as j_load_data
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import codec_trainer as jtr
from pde_surrogate_tpu.utils.metrics import r2_score as j_r2_score

torch.set_num_threads(1)

IMSIZE, BLOCKS, GROWTH, FEATURES = 16, [1, 2, 1], 4, 8
NTRAIN, BATCH, EPOCHS, NVAL, TEST_BATCH, K_SEED = 32, 8, 3, 16, 8, 1
# the CLIs' defaults; total_steps = epochs * (ntrain // batch) in both
OPT = dict(lr_max=1e-3, total_steps=EPOCHS * (NTRAIN // BATCH),
           div_factor=2.0, pct_start=0.3, weight_decay=0.0)
WEIGHT_BOUND = 10.0
LOSSES = ("loss", "loss_pde", "loss_dirichlet", "loss_neumann")
BOUNDS = {"steps": 3e-5, "evals": 5e-6, "params": 7e-5, "stats": 4e-6}
FVCG_SEED = 2
FVCG_BOUNDS = {"steps": 1e-5, "evals": 6e-6, "params": 2.5e-5,
               "stats": 9e-6}


class _Drawn:
    """The JAX DenseED's variables drawn as its initialisers draw them
    (conv kernels U(+-1/sqrt(fan_in)), BatchNorm scale 1 and bias 0,
    statistics 0 and 1) from numpy, handed to ``create_state`` in place of
    ``model.init`` (which compiles op by op for ~15 s on one core)."""

    def __init__(self, model, sample):
        rng = np.random.default_rng(1)
        shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), sample,
                                                   train=False))

        def draw(path, leaf):
            name = path[-1].key
            if name == "kernel":
                bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
                return jnp.asarray(rng.uniform(-bound, bound, leaf.shape)
                                   .astype(np.float32))
            return jnp.full(leaf.shape, name in ("scale", "var"),
                            jnp.float32)

        self.variables = jax.tree_util.tree_map_with_path(draw, shapes)

    def init(self, key, sample, train):
        return self.variables


class _Loop:
    """The data, the batch order and both packages' 12 steps and 3 evals."""

    def __init__(self, tmp_dir, physics="sobel", k_seed=K_SEED):
        self.physics = physics
        k = sample_kle(NTRAIN + NVAL, IMSIZE, 512,
                       rng=np.random.default_rng(k_seed))
        self.x = k[:NTRAIN, None].astype(np.float32)
        x_val = k[NTRAIN:].astype(np.float32)
        y_val = solve_darcy_batch_fast(torch.from_numpy(x_val)).numpy()
        val = str(tmp_dir / "val.hdf5")
        save_dataset(val, x_val[:, None], y_val)
        self.t_val = t_load_data(val, NVAL, only_input=False,
                                 return_stats=True)
        self.j_val = j_load_data(val, NVAL, only_input=False,
                                 return_stats=True)
        self.perms = [np.random.default_rng([k_seed, e]).permutation(NTRAIN)
                      for e in range(1, EPOCHS + 1)]
        self.jm = JDenseED(1, 3, imsize=IMSIZE, blocks=BLOCKS,
                           growth_rate=GROWTH, init_features=FEATURES,
                           shared_stats=True)
        self.drawn = _Drawn(self.jm, jnp.zeros((1, IMSIZE, IMSIZE, 1)))
        v = self.drawn.variables
        self.start = codec_state_dict_from_jax(v["params"], v["batch_stats"])
        self.jax = self._run_jax()
        self.port = {dt: self._run_port(dt)
                     for dt in (torch.float64, torch.float32)}

    def _batches(self, epoch):
        p = self.perms[epoch]
        return [self.x[p[i:i + BATCH]] for i in range(0, NTRAIN, BATCH)]

    def _run_jax(self):
        state, tx = jtr.create_state(self.drawn, jax.random.key(0), None,
                                     **OPT)
        sobel = JSobel(IMSIZE, correct=True, filter_size=3)
        step = jtr.make_mixed_residual_step(self.jm, tx, sobel, WEIGHT_BOUND,
                                            physics=self.physics)
        evaluate = jtr.make_eval_step(self.jm, sobel, WEIGHT_BOUND,
                                      physics=self.physics)
        x_val, y_val, stats = self.j_val
        steps, evals = [], []
        for epoch in range(EPOCHS):
            for xb in self._batches(epoch):
                state, m = step(state, jnp.asarray(np.moveaxis(xb, 1, -1)))
                steps.append([float(m[k]) for k in LOSSES])
            outs = [evaluate(state, jnp.asarray(x_val[i:i + TEST_BATCH]),
                             jnp.asarray(y_val[i:i + TEST_BATCH]))
                    for i in range(0, NVAL, TEST_BATCH)]
            r2 = j_r2_score(jnp.concatenate([o["sse"] for o in outs]).sum(0),
                            jnp.asarray(stats["y_variation"]))
            rel = jnp.concatenate([o["rel_l2"] for o in outs]).mean(0)
            cons = jnp.mean(jnp.stack([o["consistency"] for o in outs]))
            evals.append(np.concatenate([np.asarray(r2), np.asarray(rel),
                                         [float(cons)]]))
        final = codec_state_dict_from_jax(jax.device_get(state.params),
                                          jax.device_get(state.batch_stats))
        return {"steps": np.array(steps), "evals": np.array(evals),
                "state": final, "count": int(state.step)}

    def _run_port(self, dtype):
        model = TDenseED(1, 3, IMSIZE, BLOCKS, growth_rate=GROWTH,
                         init_features=FEATURES)
        model.load_state_dict(self.start)
        model.to(dtype)
        state = ttr.create_state(model, **OPT)
        sobel = TSobel(IMSIZE, correct=True, filter_size=3)
        step = ttr.make_mixed_residual_step(state, sobel, WEIGHT_BOUND,
                                            physics=self.physics)
        evaluate = ttr.make_eval_step(state, sobel, WEIGHT_BOUND,
                                      physics=self.physics)
        x_val, y_val, stats = self.t_val
        x_val = torch.from_numpy(x_val).to(dtype)
        y_val = torch.from_numpy(y_val).to(dtype)
        steps, evals = [], []
        for epoch in range(EPOCHS):
            for xb in self._batches(epoch):
                m = step(torch.from_numpy(xb).to(dtype))
                steps.append([float(m[k]) for k in LOSSES])
            outs = [evaluate(x_val[i:i + TEST_BATCH], y_val[i:i + TEST_BATCH])
                    for i in range(0, NVAL, TEST_BATCH)]
            r2 = t_r2_score(torch.cat([o["sse"] for o in outs]).sum(0),
                            torch.as_tensor(stats["y_variation"]).to(dtype))
            rel = torch.cat([o["rel_l2"] for o in outs]).mean(0)
            cons = torch.stack([o["consistency"] for o in outs]).mean()
            evals.append(np.concatenate([r2.numpy(), rel.numpy(),
                                         [float(cons)]]))
        final = {k: v.detach().double() for k, v in model.state_dict().items()}
        return {"steps": np.array(steps), "evals": np.array(evals),
                "state": final, "count": state.step}


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _state_errs(got: dict, want: dict) -> dict:
    """The largest difference over the parameters and over the running
    statistics, each relative to its tensor's largest value."""
    errs = {"params": 0.0, "stats": 0.0}
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = w.double()
        e = float((got[name] - w).abs().max() / w.abs().max())
        kind = "stats" if "running" in name else "params"
        errs[kind] = max(errs[kind], e)
    return errs


def _assert_close(got: dict, want: dict, bounds: dict = BOUNDS):
    assert got["count"] == want["count"] == OPT["total_steps"]
    assert _rel(got["steps"], want["steps"]) <= bounds["steps"]
    assert _rel(got["evals"], want["evals"]) <= bounds["evals"]
    for kind, err in _state_errs(got["state"], want["state"]).items():
        assert err <= bounds[kind], (kind, err)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    return _Loop(tmp_path_factory.mktemp("codec_recipe"))


@pytest.fixture(scope="module")
def fvcg_loop(tmp_path_factory):
    return _Loop(tmp_path_factory.mktemp("codec_recipe_fvcg"),
                 physics="fvcg", k_seed=FVCG_SEED)


def _check(loop, case: str, bounds: dict):
    j, ref = loop.jax, loop.port[torch.float64]
    if case == "steps":
        assert _rel(j["steps"], ref["steps"]) <= bounds["steps"]
        # the loop trains: the OneCycle run ends below its first loss
        assert j["steps"][-1, 0] < j["steps"][0, 0]
    elif case == "evals":
        assert _rel(j["evals"], ref["evals"]) <= bounds["evals"]
        assert not np.array_equal(j["evals"][0], j["evals"][-1])
    elif case == "state":
        assert j["count"] == ref["count"] == OPT["total_steps"]
        for kind, err in _state_errs(j["state"], ref["state"]).items():
            assert err <= bounds[kind], (kind, err)
        moved = {k: float((ref["state"][k] - v.double()).abs().max())
                 for k, v in loop.start.items()
                 if not k.endswith("num_batches_tracked")}
        assert min(moved.values()) > 1e-4       # every tensor trained
    else:
        _assert_close(loop.port[torch.float32], ref, bounds)


@pytest.mark.parametrize("case", ["steps", "evals", "state", "port_f32"])
def test_codec_recipe_matches_jax(loop, case):
    _check(loop, case, BOUNDS)


@pytest.mark.parametrize("case", ["steps", "evals", "state", "port_f32"])
def test_codec_recipe_fvcg_matches_jax(fvcg_loop, case):
    _check(fvcg_loop, case, FVCG_BOUNDS)

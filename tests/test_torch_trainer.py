"""Port parity: the OneCycle and LR-range schedules, one training step of
every objective (the four label-free physics and the supervised MSE), the
eval step and the checkpoint round trip, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.train import checkpoint as tck
from pde_surrogate_torch.train import codec_trainer as ttr
from pde_surrogate_torch.train.schedules import find_lr_schedule as t_find
from pde_surrogate_torch.train.schedules import one_cycle_schedule as t_sched
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import checkpoint as jck
from pde_surrogate_tpu.train import codec_trainer as jtr
from pde_surrogate_tpu.train.schedules import find_lr_schedule as j_find
from pde_surrogate_tpu.train.schedules import one_cycle_schedule as j_sched

torch.set_num_threads(1)


@pytest.mark.parametrize("div,pct", [(2.0, 0.3), (25.0, 0.25)])
def test_one_cycle_schedule_per_step(div, pct):
    """Same float32 arithmetic in the same order: most steps agree bit for
    bit; the rest differ by the rounding of cos (XLA's and torch's), within
    the 1.3e-7 of docs/PARITY.md's one_cycle row, taken relative to lr_max
    (in the cosine tail lr falls to lr_max/div/1e4, where one f32 ulp of
    cos+1 is a large relative change).  Past the last step too."""
    total, lr_max = 97, 1e-3
    ts, js = t_sched(lr_max, total, div, pct), j_sched(lr_max, total, div,
                                                        pct)
    got = np.array([ts(s) for s in range(total + 5)])
    want = np.array([float(js(jnp.int32(s))) for s in range(total + 5)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1.3e-7 * lr_max)
    assert np.mean(got == want) > 0.9


def test_find_lr_schedule_per_step():
    """The exponential range-test lr: JAX evaluates it in float32, the
    port in float64, so 1e-6 relative."""
    ts, js = t_find(1e-8, 10.0, 15), j_find(1e-8, 10.0, 15)
    got = np.array([ts(s) for s in range(16)])
    want = np.array([float(js(jnp.int32(s))) for s in range(16)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 1e-8 and abs(got[-1] - 10.0) < 1e-9


IMSIZE, BLOCKS = 16, [1, 2, 1]


def _models(x_seed=0):
    """The JAX DenseED with its optimizer, the port's with the same weights
    (coupled L2 1e-4, OneCycle over 10 steps), and a batch of K and of
    labels."""
    rng = np.random.default_rng(x_seed)
    x = np.exp(rng.normal(0, 1, (4, 1, IMSIZE, IMSIZE))).astype(np.float32)
    y = rng.normal(0, 1, (4, 3, IMSIZE, IMSIZE)).astype(np.float32)
    jm = JDenseED(1, 3, imsize=IMSIZE, blocks=BLOCKS, growth_rate=4,
                  init_features=8, shared_stats=True)
    jstate, tx = jtr.create_state(jm, jax.random.key(0),
                                  jnp.zeros((1, IMSIZE, IMSIZE, 1)),
                                  lr_max=1e-3, total_steps=10,
                                  weight_decay=1e-4)
    tm = TDenseED(1, 3, IMSIZE, BLOCKS, growth_rate=4, init_features=8)
    tm.load_state_dict(codec_state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    tstate = ttr.create_state(tm, lr_max=1e-3, total_steps=10,
                              weight_decay=1e-4)
    return jm, jstate, tx, tm, tstate, x, y


def _assert_same_state(tm, tstate, jnew):
    """Parameters 1e-6 absolute, BN running stats 2e-5, the same step and
    lr."""
    assert tstate.step == int(jnew.step) == 1
    want = codec_state_dict_from_jax(jax.device_get(jnew.params),
                                     jax.device_get(jnew.batch_stats))
    got = tm.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 2e-5 if "running" in k else 1e-6
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(ttr.current_lr(tstate), jtr.current_lr(jnew),
                               rtol=1e-6)


@pytest.mark.parametrize("physics", ["sobel", "fv", "fvcg", "sobel_fvcg"])
def test_one_mixed_residual_step_matches_jax(physics):
    """From identical weights and batch, one Adam step (coupled L2, OneCycle
    lr) under each label-free objective (fvcg at 8 CG iterations, flux
    weight 1 in the hybrid) gives the same loss, parameters and BN running
    stats.

    The first Adam update is lr * g / (|g| + eps), which is +-lr wherever
    |g| >> eps: f32 noise in g moves it by ~lr * 1e-4 relative at most.
    Tolerances: loss 1e-4 relative, params 1e-6 absolute, stats 2e-5."""
    jm, jstate, tx, tm, tstate, x, _ = _models()
    kw = dict(physics=physics, fvcg_weight=100.0, fvcg_flux_weight=1.0,
              fvcg_iters=8)
    jstep = jtr.make_mixed_residual_step(jm, tx, JSobel(IMSIZE), 10.0, **kw)
    jnew, jmet = jstep(jstate, jnp.asarray(np.moveaxis(x, 1, -1)))
    tmet = ttr.make_mixed_residual_step(tstate, TSobel(IMSIZE), 10.0, **kw)(
        torch.from_numpy(x))
    for k in ("loss", "loss_pde", "loss_dirichlet", "loss_neumann"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4)
    _assert_same_state(tm, tstate, jnew)


def test_one_mle_step_matches_jax():
    """One supervised MSE step from identical weights: the same loss,
    parameters and BN running stats (tolerances as above)."""
    jm, jstate, tx, tm, tstate, x, y = _models(1)
    jnew, jmet = jtr.make_mle_step(jm, tx)(
        jstate, jnp.asarray(np.moveaxis(x, 1, -1)),
        jnp.asarray(np.moveaxis(y, 1, -1)))
    tmet = ttr.make_mle_step(tstate)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    _assert_same_state(tm, tstate, jnew)


def test_eval_step_matches_jax_fvcg():
    """The eval step under fvcg (8 CG iterations) from identical weights:
    the physics loss (1e-4 relative), per-sample rel-L2 and SSE against the
    labels and the flux-pressure consistency (1e-5 relative), and the
    output (1e-5 of its scale)."""
    jm, jstate, _, tm, tstate, x, y = _models(2)
    kw = dict(physics="fvcg", fvcg_iters=8)
    jout = jtr.make_eval_step(jm, JSobel(IMSIZE), 10.0, **kw)(
        jstate, jnp.asarray(np.moveaxis(x, 1, -1)),
        jnp.asarray(np.moveaxis(y, 1, -1)))
    tout = ttr.make_eval_step(tstate, TSobel(IMSIZE), 10.0, **kw)(
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                               rtol=1e-4)
    for k in ("rel_l2", "sse", "consistency"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, err_msg=k)
    want = np.moveaxis(np.asarray(jout["output"]), -1, 1)
    np.testing.assert_allclose(tout["output"].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_checkpoint_round_trip(tmp_path):
    ckpt = str(tmp_path / "checkpoints")
    tm = TDenseED(1, 3, 16, [1, 1, 1], growth_rate=4, init_features=8)
    state = ttr.create_state(tm, lr_max=1e-3, total_steps=4)
    ttr.make_mixed_residual_step(state, TSobel(16))(torch.rand(2, 1, 16, 16)
                                                     + 0.5)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    history = [(1, 0.4), (2, float("nan")), (3, 0.2), (4, 0.3)]
    tck.save_checkpoint(ckpt, 3, state, meta={"epoch": 3,
                                               "ckpt_consistency": history})
    tck.save_checkpoint(ckpt, 5, state)            # no meta sidecar

    other = ttr.create_state(TDenseED(1, 3, 16, [1, 1, 1], growth_rate=4,
                                      init_features=8), 1e-3, 4)
    restored, meta = tck.restore_checkpoint(ckpt, 3, other, with_meta=True)
    assert restored is other and other.step == 1
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert other.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()
    assert meta["epoch"] == 3
    assert tck.restore_checkpoint(ckpt, 5, other, with_meta=True)[1] == {}

    assert tck.latest_epoch(ckpt) == 5
    assert tck.latest_meta_epoch(ckpt) == 3
    assert tck.latest_meta_epoch(ckpt, at_or_below=2) is None
    assert tck.latest_epoch(str(tmp_path / "missing")) is None
    sel = tck.select_consistency_epoch(meta["ckpt_consistency"])
    assert sel == jck.select_consistency_epoch(history) == (3, 0.2)
    assert tck.select_consistency_epoch([(1, float("inf"))]) is None
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))

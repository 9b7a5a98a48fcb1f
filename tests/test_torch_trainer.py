"""Port parity: the OneCycle schedule, one mixed-residual training step and
the checkpoint round trip, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel
from pde_surrogate_torch.train import checkpoint as tck
from pde_surrogate_torch.train import codec_trainer as ttr
from pde_surrogate_torch.train.schedules import one_cycle_schedule as t_sched
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import checkpoint as jck
from pde_surrogate_tpu.train import codec_trainer as jtr
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


def test_one_mixed_residual_step_matches_jax():
    """From identical weights and batch, one Adam step (coupled L2, OneCycle
    lr) gives the same loss, parameters and BN running stats.

    The first Adam update is lr * g / (|g| + eps), which is +-lr wherever
    |g| >> eps: f32 noise in g moves it by ~lr * 1e-4 relative at most.
    Tolerances: loss 1e-4 relative, params 1e-6 absolute, stats 2e-5."""
    imsize, blocks = 16, [1, 2, 1]
    rng = np.random.default_rng(0)
    x = (np.exp(rng.normal(0, 1, (4, 1, imsize, imsize)))).astype(np.float32)
    jm = JDenseED(1, 3, imsize=imsize, blocks=blocks, growth_rate=4,
                  init_features=8, shared_stats=True)
    jstate, tx = jtr.create_state(jm, jax.random.key(0),
                                  jnp.zeros((1, imsize, imsize, 1)),
                                  lr_max=1e-3, total_steps=10,
                                  weight_decay=1e-4)
    tm = TDenseED(1, 3, imsize, blocks, growth_rate=4, init_features=8)
    tm.load_state_dict(codec_state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    tstate = ttr.create_state(tm, lr_max=1e-3, total_steps=10,
                              weight_decay=1e-4)

    jstep = jtr.make_mixed_residual_step(jm, tx, JSobel(imsize), 10.0)
    jnew, jmet = jstep(jstate, jnp.asarray(np.moveaxis(x, 1, -1)))
    tmet = ttr.make_mixed_residual_step(tstate, TSobel(imsize), 10.0)(
        torch.from_numpy(x))

    assert tstate.step == int(jnew.step) == 1
    for k in ("loss", "loss_pde", "loss_dirichlet", "loss_neumann"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4)
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

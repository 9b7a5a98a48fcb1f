"""Port parity: data parallelism and the domain-decomposed Darcy solve
(pde_surrogate_torch/parallel) against the JAX package, on the CPU.

Ranks are spawned with ``parallel.launch.spawn`` (gloo, a file store in
``tmp_path``, one intra-op thread each, as this process has); they run the
port's ``tools/dist_check`` functions and never import this module or JAX.
The JAX references are computed here and handed over as numpy-made tensors;
weights move with ``utils/from_jax``.

* DP codec step, 2 ranks: DenseED [2,3,2]/8/16 at 32^2, batch 8, as the
  JAX package's ``tests/test_training.py::small_model``, with and without
  concat-free: in float32 the first step against JAX's single-device step
  (loss 1e-5 relative, every parameter and BN buffer 2e-5, the second
  step's loss too); three steps in float64 against the port's one-process
  steps (the same bounds; the two ranks' replicas bit-equal).  Three
  float32 steps are ill-conditioned at these inputs (``tools/dist_check``):
  the one-process path alone moves 5.8e-5 under a 1e-7 perturbation.
* DP cGlow step, 2 ranks, at ``tests/test_glow_training.py``'s sizes: three
  losses in float64 within 2e-5 relative of one process, the ranks'
  replicas bit-equal; the first, in float32 with JAX's noise, within 2e-5
  of JAX's.
* ``DeviceDataset`` under a mesh, and what the 2-D mesh refuses (the 2-D
  mesh's parity: ``tests/test_torch_parallel_space.py``).
* The sharded solve on 4 ranks at 32^2 against JAX ``solve_darcy`` (5e-4
  at 1200 iterations, as ``tests/test_spatial_parallel.py``) and against
  JAX's own circular-ring sharded solve.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.data.pipeline import DeviceDataset
from pde_surrogate_torch.parallel import mesh as tmesh
from pde_surrogate_torch.parallel.launch import spawn
from pde_surrogate_torch.parallel.spatial import solve_darcy_spatial
from pde_surrogate_torch.tools import dist_check
from pde_surrogate_torch.utils.from_jax import (codec_state_dict_from_jax,
                                                glow_state_dict_from_jax)
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.models.glow import MultiScaleCondGlow as JGlow
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.parallel import spatial as jspatial
from pde_surrogate_tpu.solvers.fd_darcy import solve_darcy
from pde_surrogate_tpu.train import codec_trainer as jtr
from pde_surrogate_tpu.train import glow_trainer as jgtr

torch.set_num_threads(1)


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


@functools.lru_cache(maxsize=None)
def _codec_case(concat_free: bool, workdir: str):
    """From the same weights and batch: JAX's first single-device step (its
    loss, the next loss, the state after it) and the port's on 2 spawned
    ranks in float32; three steps of the port on 2 ranks and in this
    process in float64."""
    x = sample_kle(8, 32, 32, rng=0)[:, None]
    jm = JDenseED(1, 3, imsize=32, blocks=[2, 3, 2], growth_rate=8,
                  init_features=16, shared_stats=True, concat_free=concat_free)
    js, tx = jtr.create_state(jm, jax.random.key(0), _nhwc(x), lr_max=1e-3,
                              total_steps=10)
    sd0 = codec_state_dict_from_jax(jax.device_get(js.params),
                                    jax.device_get(js.batch_stats))
    jstep = jtr.make_mixed_residual_step(jm, tx, JSobel(32), 10.0)
    js, m1 = jstep(js, _nhwc(x))
    jsd = codec_state_dict_from_jax(jax.device_get(js.params),
                                    jax.device_get(js.batch_stats))
    _, m2 = jstep(js, _nhwc(x))
    kw = dict(in_channels=1, out_channels=3, imsize=32, blocks=[2, 3, 2],
              growth_rate=8, init_features=16, concat_free=concat_free)
    xt = torch.from_numpy(x)
    todo = [(dist_check.codec_run, (sd0, xt, kw, 2)),
            (dist_check.codec_run, (sd0, xt, kw, 3, "cpu", torch.float64))]
    ranks = spawn(dist_check.calls, 2, todo, workdir=workdir)
    plain = dist_check.codec_run(None, sd0, xt, kw, 3, "cpu", torch.float64)
    jlosses = np.asarray([float(m1["loss"]), float(m2["loss"])])
    return jlosses, jsd, ranks[0][0], [r[1] for r in ranks], plain


def _assert_state(got: dict, want: dict):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=dist_check.CODEC_STATE_ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist"))


@pytest.mark.parametrize("concat_free", [False, True],
                         ids=["concat", "concat-free"])
def test_dp_codec_steps_match_jax(workdir, concat_free):
    """Two ranks, each on 4 of the 8 fields, with global BatchNorm moments
    and averaged gradients, in float32: JAX's single-device loss, its
    parameters and running statistics after the step, and the loss of the
    step after."""
    jlosses, jsd, dp32, _, _ = _codec_case(concat_free, workdir)
    np.testing.assert_allclose(dp32["losses"].numpy(), jlosses,
                               rtol=dist_check.CODEC_LOSS_RTOL)
    _assert_state(dp32["first"], jsd)


@pytest.mark.parametrize("concat_free", [False, True],
                         ids=["concat", "concat-free"])
def test_dp_codec_steps_match_one_process(workdir, concat_free):
    """Three float64 steps on 2 ranks and in one process: losses,
    parameters and BatchNorm buffers (num_batches_tracked too); the two
    ranks' replicas are bit-equal."""
    _, _, _, dp, plain = _codec_case(concat_free, workdir)
    np.testing.assert_allclose(dp[0]["losses"].numpy(),
                               plain["losses"].numpy(),
                               rtol=dist_check.CODEC_LOSS_RTOL)
    _assert_state(dp[0]["state"], plain["state"])
    for k, v in dp[0]["state"].items():
        torch.testing.assert_close(dp[1]["state"][k], v, rtol=0, atol=0,
                                   msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(plain["state"][k]) == 3


@functools.lru_cache(maxsize=None)
def _glow_case(workdir: str):
    """JAX's first reverse-KL loss with its noise, and the port's on 2
    ranks in float32; three port losses in float64 on 2 ranks and in this
    process (the first step on JAX's noise)."""
    n, bs = 16, 8
    x = sample_kle(bs, n, 16, rng=0)[:, None]
    y = (np.random.default_rng(1).standard_normal((bs, n, n, 3)) * 0.1
         ).astype(np.float32)
    jm = JGlow(img_size=n, x_channels=1, y_channels=3, enc_blocks=[2, 2],
               flow_blocks=[2, 2])
    js, tx = jgtr.create_glow_state(jm, jax.random.key(0), jnp.asarray(y),
                                    _nhwc(x), lr_max=1e-3, total_steps=20)
    # every weight moved by N(0, 0.01^2): the init's zero heads would leave
    # the coupling nets, and their BatchNorm, out of the loss
    leaves, tree = jax.tree_util.tree_flatten(js.params)
    rng = np.random.default_rng(0)
    js = js._replace(params=jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
                    .astype(np.float32)) for a in leaves]))
    noise = jm.apply(jgtr._variables(js), jax.random.fold_in(js.key, js.step),
                     1, bs, method=jm.create_noise)
    eps = [_nchw(e[0]) for e in noise]
    sd0 = glow_state_dict_from_jax(jax.device_get(js.params),
                                   jax.device_get(js.batch_stats),
                                   jax.device_get(js.constants))
    jstep = jgtr.make_reverse_kl_step(jm, tx, JSobel(n), beta=150.0,
                                      weight_bound=50.0,
                                      n_out_pixels=3 * n * n)
    _, m = jstep(js, _nhwc(x))
    kw = dict(img_size=n, x_channels=1, y_channels=3, enc_blocks=[2, 2],
              flow_blocks=[2, 2])
    xt = torch.from_numpy(x)
    todo = [(dist_check.glow_run, (sd0, xt, kw, 1, eps)),
            (dist_check.glow_run, (sd0, xt, kw, 3, eps, "cpu",
                                   torch.float64))]
    ranks = spawn(dist_check.calls, 2, todo, workdir=workdir)
    plain = dist_check.glow_run(None, sd0, xt, kw, 3, eps, "cpu",
                                torch.float64)
    return float(m["loss"]), ranks[0][0], [r[1] for r in ranks], plain


def test_dp_glow_steps_match_one_process(workdir):
    """Three float64 reverse-KL steps on 2 ranks (each drawing the global
    batch's noise and taking its rows) against one process: the losses
    within 2e-5 relative; both ranks see the same global losses and hold
    bit-equal replicas (the parameters against one process: not compared,
    ``tools/dist_check``)."""
    _, _, dp, plain = _glow_case(workdir)
    np.testing.assert_allclose(dp[0]["losses"].numpy(),
                               plain["losses"].numpy(),
                               rtol=dist_check.GLOW_LOSS_RTOL)
    torch.testing.assert_close(dp[1]["losses"], dp[0]["losses"], rtol=0,
                               atol=0)
    for k, v in dp[0]["state"].items():
        torch.testing.assert_close(dp[1]["state"][k], v, rtol=0, atol=0,
                                   msg=k)


def test_dp_glow_first_loss_matches_jax(workdir):
    jloss, dp32, _, _ = _glow_case(workdir)
    np.testing.assert_allclose(float(dp32["losses"][0]), jloss,
                               rtol=dist_check.GLOW_LOSS_RTOL)


def _fake_mesh(rank, world):
    return tmesh.Mesh(None, rank, world, torch.device("cpu"))


@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "test"])
def test_device_dataset_shards_are_the_global_batch(shuffle):
    """Each rank's shard of every batch, put together in rank order, is
    the one-process batch, for the shuffled training set and the ordered
    test set alike."""
    a = np.arange(48 * 2, dtype=np.float32).reshape(48, 2)
    b = -a
    one = DeviceDataset(a, b, batch_size=12, device="cpu", seed=3,
                        shuffle=shuffle)
    ranks = [DeviceDataset(a, b, batch_size=12, device="cpu", seed=3,
                           shuffle=shuffle, mesh=_fake_mesh(r, 3))
             for r in range(3)]
    assert all(len(ds) == len(one) == 4 for ds in ranks)
    for epoch in (1, 2):
        shards = [list(ds.batches(epoch)) for ds in ranks]
        for s, (ga, gb) in enumerate(one.batches(epoch)):
            assert all(sh[s][0].shape == (4, 2) for sh in shards)
            torch.testing.assert_close(torch.cat([sh[s][0] for sh in shards]),
                                       ga, rtol=0, atol=0)
            torch.testing.assert_close(torch.cat([sh[s][1] for sh in shards]),
                                       gb, rtol=0, atol=0)


def test_device_dataset_rejects_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        DeviceDataset(np.zeros((20, 2)), batch_size=10, device="cpu",
                      mesh=_fake_mesh(0, 4))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch(torch.zeros(10, 2), _fake_mesh(1, 4))


def _dp_sp_refusals(mesh):
    """What the data x space mesh takes and what it raises on, in a
    one-rank gloo group."""
    from pde_surrogate_torch.models.codec import Conv2d, DenseED
    from pde_surrogate_torch.models.glow import MultiScaleCondGlow
    from pde_surrogate_torch.ops.filters import SobelFilter
    from pde_surrogate_torch.parallel.halo import RowShard
    from pde_surrogate_torch.train.codec_trainer import (
        create_state, make_eval_step, make_mixed_residual_step,
        make_mle_step)
    with pytest.raises(ValueError, match="a 4x2 mesh in a process group of "
                                         "1 ranks"):
        tmesh.dp_sp_mesh(4, 2, "cpu")
    m = tmesh.dp_sp_mesh(1, 1, "cpu")
    assert (m.coords, m.shape, m.n_data) == ((0, 0), (1, 1), 1)
    shard = tmesh.batch_space_sharding(m)
    assert shard(torch.zeros(2, 1, 8, 8)).shape == (2, 1, 8, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        shard(torch.zeros(2, 1, 6, 6))
    with pytest.raises(ValueError, match="multiple of 8"):
        tmesh.batch_space_sharding(m, 8)(torch.zeros(2, 1, 12, 12))
    kw = dict(in_channels=1, out_channels=3, imsize=8, blocks=[1, 1, 1],
              growth_rate=2, init_features=4)
    x = torch.from_numpy(sample_kle(2, 8, 16, rng=0))[:, None].float()
    # every objective, the supervised and eval steps and dropout take the
    # mesh (their parity: tests/test_torch_parallel_space_codec.py)
    model = tmesh.replicate(DenseED(**kw, drop_rate=0.1), m)
    state = create_state(model, 1e-3, 10, mesh=m)
    for physics in ("sobel", "fv", "fvcg", "sobel_fvcg"):
        out = make_mixed_residual_step(state, SobelFilter(8),
                                       physics=physics, fvcg_iters=4)(x)
        assert torch.isfinite(out["loss"])
    y = torch.zeros(2, 3, 8, 8)
    assert torch.isfinite(make_mle_step(state)(x, y)["loss"])
    out = make_eval_step(state, SobelFilter(8), physics="fvcg",
                         fvcg_iters=4)(x, y)
    assert out["rel_l2"].shape == (2, 3) and out["output"].shape == y.shape
    # dropout on a mesh draws from the step's generator, never torch's
    # global RNG
    model.train()
    with pytest.raises(ValueError, match="dropout_masks"):
        model(x)
    # a biased codec conv has a row form: the bias after the block conv
    conv = Conv2d(1, 2, 3, padding=1)
    whole = conv(x)
    torch.testing.assert_close(whole, torch.nn.functional.conv2d(
        x, conv.weight, conv.bias, 1, 1), rtol=0, atol=0)
    tmesh.replicate(torch.nn.Sequential(conv), m)
    torch.testing.assert_close(conv(x), whole, rtol=1e-6, atol=1e-6)
    # the cGlow takes the mesh; a conv without a row form raises naming it
    tmesh.replicate(MultiScaleCondGlow(
        img_size=8, x_channels=1, y_channels=3, enc_blocks=[1, 1],
        flow_blocks=[1, 1]), m)
    for bad in (torch.nn.Conv2d(1, 2, 3, padding=1),
                Conv2d(1, 2, 3, padding=2, dilation=2),
                Conv2d(2, 2, 3, padding=1, groups=2),
                Conv2d(1, 2, (3, 1), padding=(1, 0))):
        with pytest.raises(NotImplementedError,
                           match="has no row-block form"):
            tmesh.replicate(torch.nn.Sequential(bad), m)
    # a 5x5 Sobel reads 2 rows beyond its block: 8 blocks of 1 row raise
    with pytest.raises(ValueError, match="narrower than the operator's halo"):
        SobelFilter(8, filter_size=5).on_rows(RowShard(None, 0, 8)).halo()


def test_dp_sp_mesh_validation(tmp_path):
    """``dp_sp_mesh`` raises on a shape that is not the world size,
    ``batch_space_sharding`` on rows per rank that are not a multiple of
    4 (or of the multiple asked for); under a space mesh every codec
    objective, the supervised and eval steps, dropout (from the step's
    generator only), a biased codec conv and the cGlow are taken, and a
    conv without a row-block form raises naming it, as a block narrower
    than the Sobel's halo does."""
    from pde_surrogate_torch.parallel.launch import run
    run(_dp_sp_refusals, 1, device="cpu", workdir=str(tmp_path))


def _wall_field():
    """A KLE field whose top and bottom rows differ by two orders of
    magnitude, so that a halo that wrapped round would show."""
    K = sample_kle(1, 32, 64, rng=5)[0].copy()
    K[0] = 100.0
    K[-1] = 0.01
    return K


@functools.lru_cache(maxsize=None)
def _spatial_case(workdir: str):
    """The 4-rank sharded solves: one field after 25, 100, 400 and 1200
    iterations, 3 fields at 1200, the wall field at 1200."""
    one = sample_kle(1, 32, 64, rng=np.random.default_rng(0))[0]
    three = sample_kle(3, 32, 64, rng=np.random.default_rng(1))
    cases = [(torch.from_numpy(one), [25, 100, 400, 1200]),
             (torch.from_numpy(three), [1200]),
             (torch.from_numpy(_wall_field()), [1200])]
    return one, three, spawn(dist_check.spatial_runs, 4, cases,
                             workdir=workdir)


def test_spatial_solver_matches_single_device(workdir):
    one, _, res = _spatial_case(workdir)
    u = res[0][0][-1].numpy()
    assert u.shape == (32, 32)
    np.testing.assert_allclose(u, np.asarray(solve_darcy(jnp.asarray(one))),
                               atol=5e-4)
    # every rank assembles the same field
    for r in range(1, 4):
        torch.testing.assert_close(res[r][0][-1], res[0][0][-1], rtol=0,
                                   atol=0)


def test_spatial_solver_batched_fields(workdir):
    """Per-field CG scalars: each of the 3 fields matches its own solve."""
    _, three, res = _spatial_case(workdir)
    u = res[0][1][0].numpy()
    assert u.shape == (3, 32, 32)
    for i in range(3):
        np.testing.assert_allclose(
            u[i], np.asarray(solve_darcy(jnp.asarray(three[i]))), atol=5e-4)


def test_spatial_solver_iteration_convergence(workdir):
    """More iterations, closer to the converged solve: a wrong halo or
    all-reduce would stall or diverge the iteration."""
    one, _, res = _spatial_case(workdir)
    ref = np.asarray(solve_darcy(jnp.asarray(one)))
    errs = [np.max(np.abs(u.numpy() - ref)) for u in res[0][0][:3]]
    assert errs[1] < errs[0]
    assert errs[2] <= errs[1]
    assert errs[2] < 5e-4


def test_spatial_non_circular_halo_gives_the_ring_result(workdir):
    """The port's edge ranks receive zeros, the JAX package's circular
    ring the opposite edge; both multiply it by a zero wall conductivity,
    so on a field with very different top and bottom rows the two sharded
    solves agree (1e-5: f32 sums in another order) and both meet the
    single-device solve."""
    _, _, res = _spatial_case(workdir)
    K = _wall_field()
    ring = np.asarray(jspatial.solve_darcy_spatial(
        jnp.asarray(K), jspatial.spatial_mesh(4), n_iter=1200))
    u = res[0][2][0].numpy()
    np.testing.assert_allclose(u, ring, atol=1e-5)
    np.testing.assert_allclose(u, np.asarray(solve_darcy(jnp.asarray(K))),
                               atol=5e-4)


def test_spatial_solver_non_divisible_raises():
    K = torch.ones(30, 30)
    with pytest.raises(ValueError, match="not divisible"):
        solve_darcy_spatial(K, _fake_mesh(0, 4))

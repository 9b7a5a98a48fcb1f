"""Port parity: the data x space training step (ROADMAP E3c) on the CPU.

The JAX package shards the DenseED step over a ``('data', 'space')`` mesh
(``parallel/mesh.py`` ``dp_sp_mesh``, ``batch_space_sharding``) and lets
XLA insert the conv halos and the BatchNorm reductions; the port exchanges
halo rows by hand (``pde_surrogate_torch/parallel/halo.py``).

* The block arithmetic in one process, float64: every conv kind of the
  DenseED, the upsampling before a conv (nearest, bilinear) and the Sobel
  stencils (3x3, 5x5, with and without the boundary fix), cut into 2 and 4
  row blocks with the neighbours' rows handed over, against the whole
  field, forward and backward (input and weight gradients) within 1e-12 of
  the largest value; the loss's partial sums summed over the blocks against
  the whole fields' loss, likewise.
* The halo ``autograd.Function`` on 2 and 4 gloo ranks: its rows and the
  gradient it sends back equal slicing and summing one tensor.
* The JAX DP x SP test's counterpart (``tests/test_training.py::
  test_dp_sp_2d_mesh_step_on_fake_mesh``): DenseED [2,3,2]/8/16 at 32^2,
  batch 8, concat and concat-free, JAX's weights moved by
  ``utils/from_jax``, on a 2x2 and a 1x4 mesh of 4 spawned gloo ranks.  In
  float32 the first step against JAX's single-device step (loss 1e-5
  relative, every parameter and BatchNorm buffer 2e-5, the next step's
  loss too); three float64 steps against the port's one-process steps
  under the same bounds, every rank's replica bit-equal.  Three float32
  steps are ill-conditioned at these inputs (``tools/dist_check``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.ops.darcy import (conv_continuity_constraint,
                                           mixed_residual_loss)
from pde_surrogate_torch.ops.filters import SobelFilter
from pde_surrogate_torch.parallel.halo import RowShard
from pde_surrogate_torch.parallel.launch import spawn
from pde_surrogate_torch.tools import dist_check
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import codec_trainer as jtr

torch.set_num_threads(1)

CASES = dist_check.row_block_cases(full=False)


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_arithmetic_matches_the_whole_field(case, n_blocks):
    """Each conv kind and Sobel stencil on row blocks equals the whole
    field's result, forward and backward, within 1e-12 of its largest
    value in float64; the halos are those the operators need: 3 above and
    2 below for ``In_conv``, 1 / 0 for the strided 3x3, none for 1x1, 1 /
    1 for a 3x3 and for the upsampling before one, 2 / 2 for a 5x5; the
    Sobel's derived from its operators' band between ranks, 1 (3x3) and 2
    (5x5) whether the boundary fix widens it next to the walls or not."""
    err = dist_check.row_block_errors([case], n_blocks, "cpu",
                                      torch.float64)[case[0]]
    want = {"In_conv 7x7/s2/p3": (3, 2), "down 1x1": (0, 0),
            "down 3x3/s2/p1": (1, 0), "LastDecoding conv3 5x5/p2": (2, 2),
            "sobel 5x5 correct=True": (2, 2),
            "sobel 5x5 correct=False": (2, 2)}.get(case[0], (1, 1))
    assert err["halo"] == want
    for k in ("out", "grad_x", "grad_w"):
        if err[k] is not None:
            assert err[k] <= dist_check.ROW_BLOCK_RTOL_F64, (k, err)


def _cut_padded(x, n_blocks, halo):
    h = x.shape[-2] // n_blocks
    xp = torch.nn.functional.pad(x, (0, 0, *halo))
    return [(x[..., j * h:(j + 1) * h, :],
             xp[..., j * h:(j + 1) * h + sum(halo), :])
            for j in range(n_blocks)]


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("law", [None, "poly", "exp"])
def test_loss_partial_sums_add_up_to_the_whole_loss(law, n_blocks):
    """The mixed residual on each row block (its halo handed over), summed
    over the blocks: the loss and its pde, Dirichlet and Neumann terms,
    and the gradients with respect to the output and to K, within 1e-12
    of the whole fields' in float64; the continuity term without the top
    and bottom rows (``use_tb=False``) likewise."""
    n, bs = 16, 2
    rng = np.random.default_rng(3)
    K = torch.from_numpy(sample_kle(bs, n, 32, rng=rng)[:, None])
    out = torch.from_numpy(rng.standard_normal((bs, 3, n, n)) * 0.3)
    K.requires_grad_(True)
    out.requires_grad_(True)
    whole = SobelFilter(n)
    w_loss, w_terms = mixed_residual_loss(K, out, whole, 10.0, law)
    w_tb = conv_continuity_constraint(out, whole, use_tb=False)
    sums = [0.0] * 5
    halo = whole.on_rows(RowShard(None, 0, n_blocks)).halo()
    for j, ((k_blk, _), (o_blk, o_pad)) in enumerate(zip(
            _cut_padded(K, n_blocks, halo), _cut_padded(out, n_blocks, halo))):
        f = whole.on_rows(RowShard(None, j, n_blocks))
        assert f.halo() == halo
        a, b = halo
        loss, terms = mixed_residual_loss(
            k_blk, o_blk, f, 10.0, law,
            halo=(o_pad[..., :a, :], o_pad[..., o_pad.shape[-2] - b:, :]))
        parts = [loss, *terms, conv_continuity_constraint(o_pad, f, False)]
        sums = [s + p for s, p in zip(sums, parts)]
    for got, want in zip(sums, [w_loss, *w_terms, w_tb]):
        np.testing.assert_allclose(got.item(), want.item(), rtol=1e-12)
    g_whole = torch.autograd.grad(w_loss + w_tb, (out, K))
    g_blocks = torch.autograd.grad(sums[0] + sums[4], (out, K))
    for gb, gw in zip(g_blocks, g_whole):
        assert float((gb - gw).abs().max()) <= 1e-12 * float(gw.abs().max())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_space"))


@functools.lru_cache(maxsize=None)
def _halo_case(n_ranks: int, workdir: str):
    """A (2, 3, 16, 5) float64 tensor whose 16 rows are split over
    ``n_ranks`` gloo ranks; each halo of the DenseED's convs exchanged
    with random cotangents."""
    rng = np.random.default_rng(n_ranks)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 5)))
    cases = [(a, b,
              torch.from_numpy(rng.standard_normal((n_ranks, 2, 3, a, 5))),
              torch.from_numpy(rng.standard_normal((n_ranks, 2, 3, b, 5))))
             for a, b in [(3, 2), (1, 0), (1, 1), (2, 2), (0, 1)]]
    return x, cases, spawn(dist_check.halo_runs, n_ranks, x, cases,
                           workdir=workdir)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_halo_exchange_on_gloo_ranks(workdir, n_ranks):
    """Each rank's rows above and below are its neighbours' edge rows
    (zeros at a wall), and the gradient that comes back to each rank's
    block is that of slicing the whole tensor: every rank's cotangents
    sent to the owners of the rows and summed there."""
    x, cases, ranks = _halo_case(n_ranks, workdir)
    h = x.shape[-2] // n_ranks
    for i, (a, b, g_above, g_below) in enumerate(cases):
        xg = x.clone().requires_grad_(True)
        total = 0.0
        for r in range(n_ranks):
            got = ranks[r][i]
            r0, r1 = r * h, (r + 1) * h
            above = xg[..., r0 - a:r0, :] if r else torch.zeros_like(
                got["above"])
            below = (xg[..., r1:r1 + b, :] if r < n_ranks - 1
                     else torch.zeros_like(got["below"]))
            torch.testing.assert_close(got["above"], above.detach(), rtol=0,
                                       atol=0)
            torch.testing.assert_close(got["below"], below.detach(), rtol=0,
                                       atol=0)
            total = total + (above * g_above[r]).sum() + (
                below * g_below[r]).sum()
        grad, = torch.autograd.grad(total, xg)
        for r in range(n_ranks):
            torch.testing.assert_close(ranks[r][i]["grad"],
                                       grad[..., r * h:(r + 1) * h, :],
                                       rtol=0, atol=1e-15)


SHAPES = [(2, 2), (1, 4)]


@functools.lru_cache(maxsize=None)
def _codec_case(concat_free: bool, workdir: str):
    """From the same weights and batch: JAX's first single-device step (its
    loss, the next loss, the state after it); the port's on each mesh of 4
    spawned ranks in float32 (2 steps) and float64 (3 steps); three port
    steps in this process in float64."""
    x = sample_kle(8, 32, 32, rng=0)[:, None]
    jm = JDenseED(1, 3, imsize=32, blocks=[2, 3, 2], growth_rate=8,
                  init_features=16, shared_stats=True, concat_free=concat_free)
    nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    js, tx = jtr.create_state(jm, jax.random.key(0), nhwc, lr_max=1e-3,
                              total_steps=10)
    sd0 = codec_state_dict_from_jax(jax.device_get(js.params),
                                    jax.device_get(js.batch_stats))
    jstep = jtr.make_mixed_residual_step(jm, tx, JSobel(32), 10.0)
    js, m1 = jstep(js, nhwc)
    jsd = codec_state_dict_from_jax(jax.device_get(js.params),
                                    jax.device_get(js.batch_stats))
    _, m2 = jstep(js, nhwc)
    kw = dict(in_channels=1, out_channels=3, imsize=32, blocks=[2, 3, 2],
              growth_rate=8, init_features=16, concat_free=concat_free)
    xt = torch.from_numpy(x)
    todo = [(dist_check.codec_dpsp_run, (shape, sd0, xt, kw, 2))
            for shape in SHAPES] + [
        (dist_check.codec_dpsp_run, (shape, sd0, xt, kw, 3, "cpu",
                                     torch.float64)) for shape in SHAPES]
    ranks = spawn(dist_check.calls, 4, todo, workdir=workdir)
    plain = dist_check.codec_run(None, sd0, xt, kw, 3, "cpu", torch.float64)
    jlosses = np.asarray([float(m1["loss"]), float(m2["loss"])])
    n = len(SHAPES)
    return (jlosses, jsd, {s: ranks[0][i] for i, s in enumerate(SHAPES)},
            {s: [r[n + i] for r in ranks] for i, s in enumerate(SHAPES)},
            plain)


def _assert_state(got: dict, want: dict):
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=dist_check.CODEC_STATE_ATOL,
                                   err_msg=k)


_IDS = {"ids": ["concat", "concat-free"]}


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("concat_free", [False, True], **_IDS)
def test_dpsp_codec_steps_match_jax(workdir, concat_free, shape):
    """Four ranks, each on its rows of its samples, in float32: JAX's
    single-device loss, its parameters and running statistics after the
    step, and the loss of the step after."""
    jlosses, jsd, f32, _, _ = _codec_case(concat_free, workdir)
    np.testing.assert_allclose(f32[shape]["losses"].numpy(), jlosses,
                               rtol=dist_check.CODEC_LOSS_RTOL)
    _assert_state(f32[shape]["first"], jsd)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("concat_free", [False, True], **_IDS)
def test_dpsp_codec_steps_match_one_process(workdir, concat_free, shape):
    """Three float64 steps on four ranks and in one process: losses,
    parameters and BatchNorm buffers (num_batches_tracked too); every
    rank's replica is bit-equal to rank 0's."""
    _, _, _, f64, plain = _codec_case(concat_free, workdir)
    ranks = f64[shape]
    np.testing.assert_allclose(ranks[0]["losses"].numpy(),
                               plain["losses"].numpy(),
                               rtol=dist_check.CODEC_LOSS_RTOL)
    _assert_state(ranks[0]["state"], plain["state"])
    for r in ranks[1:]:
        torch.testing.assert_close(r["losses"], ranks[0]["losses"], rtol=0,
                                   atol=0)
        for k, v in ranks[0]["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=0,
                                       msg=k)
            if k.endswith("num_batches_tracked"):
                assert int(v) == int(plain["state"][k]) == 3

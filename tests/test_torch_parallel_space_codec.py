"""Port parity: the data x space mesh for every codec objective, the
supervised and eval steps and dropout (ROADMAP E3d), on the CPU.

The JAX package runs any step core on a ``('data', 'space')`` mesh by
constraining its batches to ``batch_space_sharding`` and letting XLA
partition it (``pde_surrogate_tpu/train/codec_trainer.py``
``make_epoch_fn``); the port computes each rank's rows by hand
(``ops/darcy.py``, ``utils/metrics.py``, ``models/codec.py``).

* The block arithmetic in one process, float64, 2 and 4 row blocks with
  the neighbours' rows handed over, against the whole fields within 1e-12
  of the largest value, forward and backward: the finite-volume residual
  and its terms, the flux mismatch against the labels' own face fluxes
  (``solvers/fd_darcy``), the row-block Laplacian of the PCGs with its
  faces and the partial per-field dots, and the biased row conv.
* The in-loss PCG on 2 and 4 gloo ranks, float64: e and the gradient of
  a random projection of it with respect to the output against the
  one-process ``_cg_pressure_errors``, within 1e-10 of their largest
  values.
* DenseED [2,3,2]/8/16 at 32^2, batch 8, JAX's weights via
  ``utils/from_jax``, on a 2x2 and a 1x4 mesh of 4 gloo ranks: the first
  float32 step of ``fv``, ``fvcg`` and ``sobel_fvcg`` (16 CG iterations)
  and of the supervised step against JAX's single-device step (loss 1e-5
  relative; parameters and BatchNorm buffers 2e-5, or for the fvcg
  family, whose float32 gradient amplifies rounding, 3x the port's own
  one-process distance from JAX where that is larger); three float64
  steps of each against the port's one-process steps under the same
  bounds (2e-5); the eval step (``sobel_fvcg``) against JAX's
  ``make_eval_step``: per-sample rel-L2 and SSE, the consistency and the
  loss within 1e-5 relative.
* Dropout (rate 0.2): the masks of a step on a 2-rank data mesh and on a
  2x2 mesh are the one-process masks' samples and rows, bit for bit;
  three float64 steps against one process (1e-5, 2e-5).  JAX draws its
  masks from another generator, so dropout is held to JAX only through
  the rule (one mask of the global batch per (seed, step)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.ops.darcy import (_flux_mismatch,
                                           fv_mixed_residual_loss)
from pde_surrogate_torch.parallel.halo import RowShard, conv_rows
from pde_surrogate_torch.parallel.launch import spawn
from pde_surrogate_torch.solvers.fd_darcy import (_face_conductivities,
                                                  _face_fluxes, _laplacian,
                                                  darcy_fields)
from pde_surrogate_torch.tools import dist_check
from pde_surrogate_torch.utils.from_jax import codec_state_dict_from_jax
from pde_surrogate_tpu.models.codec import DenseED as JDenseED
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import codec_trainer as jtr

torch.set_num_threads(1)

RTOL_BLOCKS = 1e-12     # block arithmetic against the whole field, float64
RTOL_PCG = 1e-10        # the PCG on gloo ranks against one process, float64


def _fields(n=16, bs=2, seed=3):
    rng = np.random.default_rng(seed)
    K = torch.from_numpy(sample_kle(bs, n, 32, rng=rng)[:, None]
                         .astype(np.float64))
    out = torch.from_numpy(rng.standard_normal((bs, 3, n, n)) * 0.3)
    return K.requires_grad_(True), out.requires_grad_(True)


def _cut(t, n_blocks, j, a=1, b=1):
    """Block j of ``t`` and its ``a`` rows above and ``b`` below (zeros at
    a wall)."""
    h = t.shape[-2] // n_blocks
    tp = torch.nn.functional.pad(t, (0, 0, a, b))
    blk = tp[..., j * h + a:(j + 1) * h + a, :]
    return blk, tp[..., j * h:j * h + a, :], tp[..., (j + 1) * h + a:
                                                (j + 1) * h + a + b, :]


def _close(got, want, rtol, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_fv_residual_partial_sums_add_up(n_blocks):
    """The finite-volume residual on each row block (one row of K and of u
    from each neighbour), summed over the blocks: the loss and its pde,
    Dirichlet and Neumann terms, and the gradients with respect to the
    output and K, against the whole fields."""
    K, out = _fields()
    w_loss, w_terms = fv_mixed_residual_loss(K, out, 10.0)
    sums = [0.0] * 4
    for j in range(n_blocks):
        k_blk, ka, kb = _cut(K[:, 0], n_blocks, j)
        u_blk, ua, ub = _cut(out[:, 0], n_blocks, j)
        o_blk = _cut(out, n_blocks, j)[0]
        loss, terms = fv_mixed_residual_loss(
            k_blk[:, None], o_blk, 10.0, RowShard(None, j, n_blocks),
            halo=((ka, kb), (ua, ub)))
        sums = [s + p for s, p in zip(sums, [loss, *terms])]
    for got, want in zip(sums, [w_loss, *w_terms]):
        np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL_BLOCKS)
    for gb, gw, name in zip(torch.autograd.grad(sums[0], (out, K)),
                            torch.autograd.grad(w_loss, (out, K)),
                            ("d/d output", "d/d K")):
        _close(gb, gw, RTOL_BLOCKS, name)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_flux_mismatch_matches_the_label_convention(n_blocks):
    """The flux mismatch on row blocks, summed: each block's fluxes
    (``_face_fluxes``) averaged to nodes against the labels of the whole
    field (``darcy_fields``, held against the JAX package's in
    ``test_torch_cg_darcy.py``), and its gradient with respect to u and
    the flux channels."""
    K, out = _fields(seed=4)
    sigma = out[:, 1:]
    ref = darcy_fields(K[:, 0], out[:, 0])[:, 1:]
    want = torch.mean((sigma - ref) ** 2)
    got = 0.0
    for j in range(n_blocks):
        rows = RowShard(None, j, n_blocks)
        k_blk, ka, kb = _cut(K[:, 0], n_blocks, j)
        u_blk, ua, ub = _cut(out[:, 0], n_blocks, j)
        _, fx, _, fy = _face_fluxes(k_blk, u_blk, (ka, kb), (ua, ub), rows)
        got = got + _flux_mismatch(_cut(sigma, n_blocks, j)[0], fx, fy,
                                   rows)
    np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL_BLOCKS)
    _close(torch.autograd.grad(got, out)[0], torch.autograd.grad(want, out)[0],
           RTOL_BLOCKS, "d/d output")


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_row_block_laplacian_and_partial_dots(n_blocks):
    """The PCGs' row-block Laplacian (``_laplacian`` on the faces of
    ``_face_conductivities``, each given the neighbours' rows) against the
    whole field's (held against the JAX package's operator in
    ``test_torch_fvcg.py``), forward and its gradient; each block's per-field dot of v with it, summed over the
    blocks, against the whole field's."""
    K, v = _fields(seed=5)
    K, v = K[:, 0], v[:, 0]
    whole = _laplacian(v, _face_conductivities(K))
    dot = torch.sum(v * whole, dim=(-2, -1))
    parts, dots = [], 0.0
    for j in range(n_blocks):
        rows = RowShard(None, j, n_blocks)
        k_blk, ka, kb = _cut(K, n_blocks, j)
        v_blk, va, vb = _cut(v, n_blocks, j)
        lap = _laplacian(v_blk, _face_conductivities(k_blk, ka, kb, rows),
                         va, vb)
        parts.append(lap)
        dots = dots + torch.sum(v_blk * lap, dim=(-2, -1))
    blocks = torch.cat(parts, -2)
    _close(blocks, whole, RTOL_BLOCKS, "laplacian")
    _close(dots, dot, RTOL_BLOCKS, "dots")
    g = torch.randn_like(whole)
    _close(torch.autograd.grad(blocks, v, g)[0],
           torch.autograd.grad(whole, v, g)[0], RTOL_BLOCKS, "d/d v")


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_biased_row_conv(stride, n_blocks):
    """A biased 3x3 conv (the cGlow's ``in_conv`` and ``Conv2dZeros``, a
    strided one as the encoder's) on row blocks, the bias added after the
    block conv: the output and the gradients of the input, weight and
    bias against ``F.conv2d`` of the whole field."""
    rng = np.random.default_rng(stride)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 12)))
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)))
    bias = torch.from_numpy(rng.standard_normal(4))
    for t in (x, w, bias):
        t.requires_grad_(True)
    whole = torch.nn.functional.conv2d(x, w, bias, stride, 1)
    a, b = 1, 2 - stride
    blocks = torch.cat([conv_rows(*_cut(x, n_blocks, j, a, b), w, stride, 1,
                                  bias) for j in range(n_blocks)], -2)
    _close(blocks, whole, RTOL_BLOCKS, "output")
    g = torch.from_numpy(rng.standard_normal(whole.shape))
    for gb, gw, name in zip(torch.autograd.grad(blocks, (x, w, bias), g),
                            torch.autograd.grad(whole, (x, w, bias), g),
                            ("d/d x", "d/d weight", "d/d bias")):
        _close(gb, gw, RTOL_BLOCKS, name)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_space_codec"))


@functools.lru_cache(maxsize=None)
def _pcg_case(n_ranks: int, workdir: str):
    """Two float64 cases at 16^2 (a KLE field; a channel-like one with a
    contrast of 100): K, an output, 12 and 40 CG iterations and a random
    cotangent of e; the ranks' rows of e and of its gradient."""
    rng = np.random.default_rng(10 + n_ranks)
    K1 = sample_kle(2, 16, 32, rng=rng)[:, None]
    K2 = np.where(rng.random((2, 1, 16, 16)) < 0.3, 100.0, 1.0)
    cases = []
    for K, n_cg in ((K1, 12), (K2, 40)):
        out = rng.standard_normal((2, 3, 16, 16)) * 0.3
        g = rng.standard_normal((2, 16, 16))
        cases.append(tuple(torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in (K, out, n_cg, g)))
    return cases, spawn(dist_check.pcg_rows_runs, n_ranks, cases,
                        workdir=workdir)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_in_loss_pcg_on_gloo_ranks(workdir, n_ranks):
    """Each rank's rows of the PCG's e (one halo row exchanged per matvec,
    the per-field dots all-reduced over the ranks) and of the gradient of
    ``sum(e * g)`` with respect to its rows of the output, put together,
    against the one-process PCG."""
    from pde_surrogate_torch.ops.darcy import _cg_pressure_errors
    cases, ranks = _pcg_case(n_ranks, workdir)
    for i, (K, out, n_cg, g) in enumerate(cases):
        o = out.clone().requires_grad_(True)
        e = _cg_pressure_errors(K, o, n_cg)
        grad, = torch.autograd.grad((e * g).sum(), o)
        _close(torch.cat([r[i]["e"] for r in ranks], -2), e.detach(),
               RTOL_PCG, f"e, case {i}")
        _close(torch.cat([r[i]["grad"] for r in ranks], -2), grad,
               RTOL_PCG, f"gradient, case {i}")


SHAPES = [(2, 2), (1, 4)]
OBJECTIVES = ["fv", "fvcg", "sobel_fvcg", "mle"]
N_CG = 16
KW = dict(in_channels=1, out_channels=3, imsize=32, blocks=[2, 3, 2],
          growth_rate=8, init_features=16)


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


def _sd(js):
    return codec_state_dict_from_jax(jax.device_get(js.params),
                                     jax.device_get(js.batch_stats))


def _step_kw(objective):
    if objective == "mle":
        return {"physics": "mle"}
    return {"physics": objective, "n_cg": N_CG}


@functools.lru_cache(maxsize=None)
def _codec_case(workdir: str):
    """From JAX's initial weights and one batch (with random labels): JAX's
    first single-device step of each objective and its eval step; the
    port's first float32 step of each in this process; on each mesh of 4
    spawned ranks the port's first float32 step and three float64 steps
    of each, and the eval step; three float64 steps of each in this
    process."""
    x = sample_kle(8, 32, 32, rng=0)[:, None]
    y = (np.random.default_rng(7).standard_normal((8, 3, 32, 32)) * 0.3
         ).astype(np.float32)
    jm = JDenseED(1, 3, imsize=32, blocks=[2, 3, 2], growth_rate=8,
                  init_features=16, shared_stats=True)
    js, tx = jtr.create_state(jm, jax.random.key(0), _nhwc(x), lr_max=1e-3,
                              total_steps=10)
    sd0 = _sd(js)
    jax_first = {}
    for obj in OBJECTIVES:
        # the JAX steps donate their state
        state = jax.tree.map(jnp.copy, js)
        if obj == "mle":
            s1, m1 = jtr.make_mle_step(jm, tx)(state, _nhwc(x), _nhwc(y))
        else:
            s1, m1 = jtr.make_mixed_residual_step(
                jm, tx, JSobel(32), 10.0, physics=obj,
                fvcg_iters=N_CG)(state, _nhwc(x))
        jax_first[obj] = (float(m1["loss"]), _sd(s1))
    jev = jtr.make_eval_step(jm, JSobel(32), 10.0, physics="sobel_fvcg",
                             fvcg_iters=N_CG)(js, _nhwc(x), _nhwc(y))
    jev = {k: np.asarray(jev[k]) for k in ("loss", "rel_l2", "sse",
                                           "consistency")}
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    todo = []
    for shape in SHAPES:
        for obj in OBJECTIVES:
            kw = dict(_step_kw(obj), y=yt)
            todo.append((dist_check.codec_dpsp_run,
                         (shape, sd0, xt, KW, 1), kw))
            todo.append((dist_check.codec_dpsp_run,
                         (shape, sd0, xt, KW, 3, "cpu", torch.float64), kw))
        todo.append((dist_check.codec_eval_run,
                     (shape, sd0, xt, yt, KW, "sobel_fvcg", N_CG)))
    ranks = spawn(dist_check.calls, 4, todo, workdir=workdir)
    plain32, plain64 = {}, {}
    for obj in OBJECTIVES:
        kw = dict(_step_kw(obj), y=yt)
        plain32[obj] = dist_check.codec_run(None, sd0, xt, KW, 1, **kw)
        plain64[obj] = dist_check.codec_run(None, sd0, xt, KW, 3, "cpu",
                                            torch.float64, **kw)
    mesh = {}
    i = 0
    for shape in SHAPES:
        for obj in OBJECTIVES:
            mesh[shape, obj, "f32"] = ranks[0][i]
            mesh[shape, obj, "f64"] = [r[i + 1] for r in ranks]
            i += 2
        mesh[shape, "eval"] = [r[i] for r in ranks]
        i += 1
    return jax_first, jev, plain32, plain64, mesh


def _state_err(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k].numpy() - v.numpy()).max())
               for k, v in want.items()
               if not k.endswith("num_batches_tracked"))


_SHAPE_IDS = {"ids": ["2x2", "1x4"]}


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_dpsp_first_step_matches_jax(workdir, objective, shape):
    """Four ranks in float32: each objective's first loss against JAX's
    single-device step, and the parameters and running statistics after
    it."""
    jax_first, _, plain32, _, mesh = _codec_case(workdir)
    jloss, jsd = jax_first[objective]
    got = mesh[shape, objective, "f32"]
    np.testing.assert_allclose(float(got["losses"][0]), jloss,
                               rtol=dist_check.CODEC_LOSS_RTOL)
    bound = dist_check.CODEC_STATE_ATOL
    if objective in ("fvcg", "sobel_fvcg"):
        bound = max(bound, 3 * _state_err(plain32[objective]["first"], jsd))
    assert _state_err(got["first"], jsd) <= bound


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_dpsp_steps_match_one_process(workdir, objective, shape):
    """Three float64 steps of each objective on four ranks and in one
    process: the losses, parameters and BatchNorm buffers; every rank's
    replica bit-equal to rank 0's."""
    _, _, _, plain64, mesh = _codec_case(workdir)
    ranks = mesh[shape, objective, "f64"]
    plain = plain64[objective]
    np.testing.assert_allclose(ranks[0]["losses"].numpy(),
                               plain["losses"].numpy(),
                               rtol=dist_check.CODEC_LOSS_RTOL)
    assert _state_err(ranks[0]["state"], plain["state"]) <= \
        dist_check.CODEC_STATE_ATOL
    for r in ranks[1:]:
        torch.testing.assert_close(r["losses"], ranks[0]["losses"], rtol=0,
                                   atol=0)
        for k, v in ranks[0]["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=0,
                                       msg=k)


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
def test_dpsp_eval_step_matches_jax(workdir, shape):
    """The eval step on four ranks against JAX's: each data shard's
    per-sample rel-L2 and SSE (summed over its space ranks), the mean of
    the data shards' consistency, and the global loss, within 1e-5
    relative; every space rank of a data shard agrees."""
    _, jev, _, _, mesh = _codec_case(workdir)
    ranks = mesh[shape, "eval"]
    n_space = shape[1]
    lead = ranks[::n_space]
    for k in ("rel_l2", "sse"):
        got = torch.cat([r[k] for r in lead]).numpy()
        np.testing.assert_allclose(got, jev[k], rtol=1e-5, err_msg=k)
    cons = np.mean([float(r["consistency"]) for r in lead])
    np.testing.assert_allclose(cons, jev["consistency"], rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), jev["loss"], rtol=1e-5)
    for i, r in enumerate(ranks):
        d = lead[i // n_space]
        for k in ("rel_l2", "sse", "consistency"):
            torch.testing.assert_close(r[k], d[k], rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _dropout_case(workdir: str):
    """Drop rate 0.2, float64: the masks of step 0 and three Sobel steps,
    in one process, on a 2-rank data mesh and on a 2x2 mesh."""
    torch.manual_seed(0)
    from pde_surrogate_torch.models.codec import DenseED
    kw = dict(KW, drop_rate=0.2)
    sd0 = DenseED(**kw).state_dict()
    xt = torch.from_numpy(sample_kle(8, 32, 32, rng=2))[:, None]
    plain = dist_check.codec_dropout_run(None, None, sd0, xt, kw)
    data = spawn(dist_check.codec_dropout_run, 2, None, sd0, xt, kw,
                 workdir=workdir)
    dpsp = spawn(dist_check.codec_dropout_run, 4, (2, 2), sd0, xt, kw,
                 workdir=workdir)
    return plain, {"data": (data, (2, 1)), "2x2": (dpsp, (2, 2))}


@pytest.mark.parametrize("mesh", ["data", "2x2"])
def test_dropout_masks_are_the_global_batchs(workdir, mesh):
    """Every rank's dropout masks are its samples and rows of the masks
    one process draws for the whole batch, bit for bit (so the ranks of a
    data mesh no longer drop the same elements of different samples);
    three float64 steps against one process."""
    plain, meshes = _dropout_case(workdir)
    ranks, (n_data, n_space) = meshes[mesh]
    assert len(plain["masks"]) == 10    # 7 dense layers, 3 transitions
    for r, got in enumerate(ranks):
        d, s = divmod(r, n_space)
        assert len(got["masks"]) == len(plain["masks"])
        for m, want in zip(got["masks"], plain["masks"]):
            b, h = want.shape[0] // n_data, want.shape[-2] // n_space
            assert torch.equal(m, want[d * b:(d + 1) * b, :,
                                       s * h:(s + 1) * h])
    assert not torch.equal(ranks[0]["masks"][0], ranks[-1]["masks"][0])
    np.testing.assert_allclose(ranks[0]["losses"].numpy(),
                               plain["losses"].numpy(),
                               rtol=dist_check.CODEC_LOSS_RTOL)
    assert _state_err(ranks[0]["state"], plain["state"]) <= \
        dist_check.CODEC_STATE_ATOL


def test_dropout_masks_follow_seed_and_step():
    """The step's masks are a function of (seed, step): the same for the
    same pair (a resumed run draws what an uninterrupted one draws),
    different for the next step; remat replays them in its recomputation,
    so its step equals the plain model's."""
    from pde_surrogate_torch.models.codec import DenseED, dropout_masks
    torch.manual_seed(0)
    kw = dict(KW, drop_rate=0.2)
    x = torch.from_numpy(sample_kle(4, 32, 32, rng=3))[:, None].float()
    model = DenseED(**kw)

    def masks(seed, step):
        with torch.no_grad(), dropout_masks(model, seed, step,
                                            record=True) as src:
            model(x)
        return src.drawn

    model.train()
    a, b, c = masks(0, 5), masks(0, 5), masks(0, 6)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    grads = []
    for remat in (False, True):
        m = DenseED(**kw, remat=remat)
        m.load_state_dict(model.state_dict())
        m.train()
        with dropout_masks(m, 0, 5):
            y = m(x)
        grads.append((y.detach(), torch.autograd.grad(
            y.square().sum(), list(m.parameters()))))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    for g1, g0 in zip(grads[1][1], grads[0][1]):
        torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6 * float(
            g0.abs().max()))

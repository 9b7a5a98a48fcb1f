"""Port parity: the conditional Glow on the data x space mesh (ROADMAP
E3d), on the CPU.

The JAX package runs the cGlow's steps on a ``('data', 'space')`` mesh by
sharding their batches; the port runs every conv of the encoder and the
flow on row blocks (codec ``Conv2d``), routes the reference-order
squeeze's rows between the space ranks in one all-to-all, takes ActNorm's
data-init moments over the group and keeps every log-density a partial
sum (``models/flow.py``, ``models/glow.py``, ``train/glow_trainer.py``).

* The squeeze in one process, float64, 2 and 4 row blocks: subpixel
  (row-local) and reference order (the chunks routed as
  ``flow.squeeze_routes`` says), forward and reverse, against the whole
  field exactly, and the gradient of a random projection likewise.
* enc and flow blocks [2, 2, 2] at 32^2, batch 8, JAX's weights moved by
  N(0, 0.01^2) (so that the coupling nets act) via ``utils/from_jax``, on
  a 2x2 and a 1x4 mesh of 4 gloo ranks (8 and 16 rows per rank, each a
  multiple of 2^2), the noise given as ``eps_list``: ActNorm data-init
  (every ActNorm within 1e-4 relative of JAX's ``data_init_actnorm``)
  and the first float32 reverse-KL loss after it against JAX's
  single-device step, the eval step's loss, per-sample rel-L2 and SSE and
  the forward-KL loss against JAX's, within 2e-5 relative; three float64
  reverse-KL steps after the data-init against one process, in subpixel
  and reference order, the losses within 2e-5 relative and the ranks'
  replicas bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.data.grf import sample_kle
from pde_surrogate_torch.models.flow import (Squeeze, squeeze_routes,
                                             squeeze_rows_assemble,
                                             squeeze_rows_chunks)
from pde_surrogate_torch.parallel.launch import spawn
from pde_surrogate_torch.tools import dist_check
from pde_surrogate_torch.utils.from_jax import glow_state_dict_from_jax
from pde_surrogate_tpu.models.glow import MultiScaleCondGlow as JGlow
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel
from pde_surrogate_tpu.train import glow_trainer as jgtr

torch.set_num_threads(1)


def _whole_rows(y, n_blocks, q):
    h = y.shape[-2] // n_blocks
    return y[..., q * h:(q + 1) * h, :]


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
@pytest.mark.parametrize("order", ["subpixel", "reference"])
def test_squeeze_on_row_blocks(order, reverse, n_blocks):
    """Each block's squeeze (subpixel: its own rows; reference: the chunks
    of ``squeeze_routes``, each sent where it says and found where the
    receiver looks for it) equals the whole field's rows of that block,
    and so does the gradient of a random projection."""
    f = 2
    rng = np.random.default_rng(n_blocks)
    shape = (2, 12, 8, 8) if reverse else (2, 3, 16, 16)
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
    sq = Squeeze(f, order)
    whole = sq(x, reverse=reverse)
    h = shape[-2] // n_blocks
    blocks = [x[..., j * h:(j + 1) * h, :] for j in range(n_blocks)]
    if order == "subpixel":
        parts = [sq(b, reverse=reverse) for b in blocks]
    else:
        chunks = [squeeze_rows_chunks(b, f, reverse) for b in blocks]
        parts = []
        for q in range(n_blocks):
            sends, takes = squeeze_routes(f, n_blocks, q, reverse)
            for k, (dest, slot) in enumerate(sends):
                assert squeeze_routes(f, n_blocks, dest, reverse)[1][slot] \
                    == (q, k)
            parts.append(squeeze_rows_assemble(torch.stack(
                [chunks[src][k] for src, k in takes]), f, reverse))
    for q, p in enumerate(parts):
        torch.testing.assert_close(p, _whole_rows(whole, n_blocks, q),
                                   rtol=0, atol=0)
    g = torch.from_numpy(rng.standard_normal(whole.shape))
    got, = torch.autograd.grad(torch.cat(parts, -2), x, g)
    want, = torch.autograd.grad(whole, x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


N, BS, BLOCKS = 32, 8, [2, 2, 2]
NPIX = 3 * N * N
SHAPES = [(2, 2), (1, 4)]
KW = dict(img_size=N, x_channels=1, y_channels=3, enc_blocks=BLOCKS,
          flow_blocks=BLOCKS)
ACTNORM_RTOL = 1e-4     # data-init against JAX (tests/test_torch_glow_trainer)


class _Compiled:
    """The JAX model with ``init`` and ``apply`` each compiled as one
    program (op by op the data-init's applies take minutes on one core);
    every other attribute is the model's."""

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


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


def _copy(state):
    return jax.tree.map(jnp.copy, state)   # the JAX steps donate their state


def _sd(js):
    return glow_state_dict_from_jax(jax.device_get(js.params),
                                    jax.device_get(js.batch_stats),
                                    jax.device_get(js.constants))


def _eps(jm, js, key):
    """The noise JAX's ``generate`` draws from ``key``, NCHW."""
    noise = jm.model.apply(jgtr._variables(js), key, 1, BS,
                           method=jm.model.create_noise)
    return [_nchw(e[0]) for e in noise]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_space_glow"))


@functools.lru_cache(maxsize=None)
def _glow_case(workdir: str):
    """JAX: ActNorm data-init, then the first reverse-KL step on its
    noise; from the weights before the data-init, the eval step on a
    key's noise and one forward-KL step.  The port: the same on each mesh
    of 4 spawned ranks in float32, and three float64 reverse-KL steps
    after the data-init (subpixel and reference order) there and in this
    process."""
    x = sample_kle(BS, N, 32, rng=0)[:, None]
    y = (np.random.default_rng(1).standard_normal((BS, 3, N, N)) * 0.1
         ).astype(np.float32)
    jm = _Compiled(JGlow(**KW))
    js, tx = jgtr.create_glow_state(jm, jax.random.key(0), _nhwc(y),
                                    _nhwc(x), lr_max=1e-3, total_steps=20)
    leaves, tree = jax.tree_util.tree_flatten(js.params)
    rng = np.random.default_rng(0)
    js = js._replace(params=jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
                    .astype(np.float32)) for a in leaves]))
    sd0 = _sd(js)
    ji = jgtr.data_init_actnorm(jm, _copy(js), _nhwc(y), _nhwc(x))
    step_eps = _eps(jm, ji, jax.random.fold_in(ji.key, ji.step))
    _, m = jgtr.make_reverse_kl_step(jm.model, tx, JSobel(N), 150.0, 50.0,
                                     NPIX)(_copy(ji), _nhwc(x))
    eval_key = jax.random.key(5)
    jev = jgtr.make_glow_eval_step(jm.model, JSobel(N), 150.0, 50.0, NPIX)(
        js, _nhwc(x), _nhwc(y), eval_key)
    _, mf = jgtr.make_forward_kl_step(jm.model, tx, NPIX)(
        _copy(js), _nhwc(x), _nhwc(y))
    jax_ref = {"init": _sd(ji), "loss": float(m["loss"]),
               "fkl": float(mf["loss"]),
               "eval": {k: np.asarray(jev[k]) for k in
                        ("loss", "residual", "neg_entropy", "rel_l2",
                         "sse")}}
    eval_eps = _eps(jm, js, eval_key)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ref_kw = dict(KW, squeeze_order="reference")
    todo = []
    for shape in SHAPES:
        todo += [
            (dist_check.glow_dpsp_run, (shape, sd0, xt, KW, 1, step_eps),
             {"init_y": yt}),
            (dist_check.glow_dpsp_run, (shape, sd0, xt, KW, 3, step_eps,
                                        "cpu", torch.float64),
             {"init_y": yt}),
            (dist_check.glow_dpsp_run, (shape, sd0, xt, ref_kw, 3, step_eps,
                                        "cpu", torch.float64),
             {"init_y": yt}),
            (dist_check.glow_eval_fkl_run, (shape, sd0, xt, yt, KW,
                                            eval_eps))]
    ranks = spawn(dist_check.calls, 4, todo, workdir=workdir)
    plain = {kw.get("squeeze_order", "subpixel"): dist_check.glow_run(
        None, sd0, xt, kw, 3, step_eps, "cpu", torch.float64, init_y=yt)
        for kw in (KW, ref_kw)}
    mesh = {}
    for i, shape in enumerate(SHAPES):
        for j, name in enumerate(("f32", "subpixel", "reference", "eval")):
            mesh[shape, name] = [r[4 * i + j] for r in ranks]
    return jax_ref, plain, mesh


_SHAPE_IDS = {"ids": ["2x2", "1x4"]}


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
def test_dpsp_data_init_and_reverse_kl_match_jax(workdir, shape):
    """Four ranks in float32: every ActNorm after the data-init (the
    moments of the whole group) against JAX's, and the first reverse-KL
    loss after it on JAX's noise."""
    jax_ref, _, mesh = _glow_case(workdir)
    got = mesh[shape, "f32"][0]
    names = [k for k in jax_ref["init"] if ".norm." in f".{k}"
             and k.endswith(("norm.weight", "norm.bias"))]
    assert len(names) == 10    # 5 ActNorms
    for k in names:
        np.testing.assert_allclose(got["init"][k].numpy(),
                                   jax_ref["init"][k].numpy(),
                                   rtol=ACTNORM_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got["losses"][0]), jax_ref["loss"],
                               rtol=dist_check.GLOW_LOSS_RTOL)


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
def test_dpsp_eval_and_forward_kl_match_jax(workdir, shape):
    """The eval step on four ranks (one sample on JAX's noise): the global
    loss, residual and entropy term, each data shard's per-sample rel-L2
    and SSE; then the forward-KL step's loss, against JAX's."""
    jax_ref, _, mesh = _glow_case(workdir)
    ranks = mesh[shape, "eval"]
    jev = jax_ref["eval"]
    for r in ranks:
        for k in ("loss", "residual", "neg_entropy"):
            np.testing.assert_allclose(float(r["eval"][k]), jev[k],
                                       rtol=dist_check.GLOW_LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(float(r["fkl_loss"]), jax_ref["fkl"],
                                   rtol=dist_check.GLOW_LOSS_RTOL)
    lead = ranks[::shape[1]]
    for k in ("rel_l2", "sse"):
        got = torch.cat([r["eval"][k] for r in lead]).numpy()
        np.testing.assert_allclose(got, jev[k], rtol=dist_check.GLOW_LOSS_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, **_SHAPE_IDS)
@pytest.mark.parametrize("order", ["subpixel", "reference"])
def test_dpsp_glow_steps_match_one_process(workdir, order, shape):
    """Three float64 reverse-KL steps after the data-init on four ranks
    and in one process: the losses within 2e-5 relative, the parameters
    and buffers after them within 2e-5 (``tools/dist_check``); every
    rank's losses and replica bit-equal."""
    _, plain, mesh = _glow_case(workdir)
    ranks = mesh[shape, order]
    np.testing.assert_allclose(ranks[0]["losses"].numpy(),
                               plain[order]["losses"].numpy(),
                               rtol=dist_check.GLOW_LOSS_RTOL)
    for k, v in plain[order]["state"].items():
        torch.testing.assert_close(ranks[0]["state"][k], v, rtol=0,
                                   atol=dist_check.CODEC_STATE_ATOL, msg=k)
    for r in ranks[1:]:
        torch.testing.assert_close(r["losses"], ranks[0]["losses"], rtol=0,
                                   atol=0)
        for k, v in ranks[0]["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=0,
                                       msg=k)

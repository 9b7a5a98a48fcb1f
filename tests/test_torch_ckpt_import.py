"""Port parity: importing PyTorch checkpoints (.pth) into run dirs.

The reference checkout and its published ``.pth`` files are not part of
this repository, so no real reference checkpoint is loaded here
(tests/test_torch_import.py, which needs them, skips without it).  The
codec ``.pth`` is saved from a port DenseED, whose names are the
reference's; the cGlow ``.pth`` is built from a small JAX glow by
inverting the JAX package's ``convert_glow_state_dict`` map (the ``flow.``
/ ``revlayers.`` / ``reduce.`` levels put back, the ActNorm and
Conv2dZeros tensors in the reference's (C,1,1) / (1,C,1,1) shapes, the LU
masks added).  The JAX importers and the port's run on the same file; the
run dirs they write must give the same predictions (codec) and the same
log p(y|x) (cGlow) within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_surrogate_torch.cli import import_torch_ckpt as t_imp
from pde_surrogate_torch.cli import predict_codec as t_predict
from pde_surrogate_torch.cli.train_cglow_reverse_kl import build_model
from pde_surrogate_torch.data.hdf5 import load_args, save_dataset
from pde_surrogate_torch.models.codec import DenseED as TDenseED
from pde_surrogate_torch.train.checkpoint import restore_weights
from pde_surrogate_torch.utils.torch_import import (convert_glow_state_dict,
                                                    load_state_dict)
from pde_surrogate_tpu.cli import import_torch_ckpt as j_imp
from pde_surrogate_tpu.cli import predict_codec as j_predict
from pde_surrogate_tpu.models import glow as jg
from pde_surrogate_tpu.train import checkpoint as j_ckpt
from pde_surrogate_tpu.train import glow_trainer as j_gt
from pde_surrogate_tpu.utils import torch_import as j_ti

torch.set_num_threads(1)

CODEC = dict(imsize=16, blocks=[2, 3, 2], growth_rate=4, init_features=8)
GLOW = dict(imsize=16, enc_blocks=[2, 2, 2], flow_blocks=[2, 2, 2])


def _codec_pth(tmp_path, wrapped: bool):
    torch.manual_seed(0)
    m = TDenseED(1, 3, 16, [2, 3, 2], growth_rate=4, init_features=8)
    with torch.no_grad():                  # running stats off their init
        m.train()(torch.randn(4, 1, 16, 16))
    sd = m.state_dict()
    pth = tmp_path / "model_epoch7.pth"
    torch.save({"epoch": 7, "model_state_dict": sd} if wrapped else sd, pth)
    return str(pth)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "wrapped"])
def test_codec_import_predicts_like_jax(tmp_path, wrapped):
    """A bare state dict and one wrapped in ``model_state_dict``: both
    importers' run dirs predict the same K within 1e-5 of the largest
    output; the port's forward ends the CLI run."""
    pth = _codec_pth(tmp_path, wrapped)
    rng = np.random.default_rng(1)
    k_file = str(tmp_path / "k.hdf5")
    save_dataset(k_file, np.exp(rng.normal(0, 1, (6, 1, 16, 16))).astype(
        np.float32))
    j_imp.import_codec_ckpt(pth, 7, str(tmp_path / "j"), **CODEC)
    model = t_imp.main(["--pth", pth, "--out-run-dir", str(tmp_path / "t"),
                        "--imsize", "16", "--blocks", "2", "3", "2",
                        "--growth-rate", "4", "--init-features", "8",
                        "--device", "cpu"])
    assert isinstance(model, TDenseED)
    assert load_args(str(tmp_path / "t")).blocks == [2, 3, 2]
    pred_j, _, _ = j_predict.main(["--run-dir", str(tmp_path / "j"),
                                   "--input", k_file, "--output",
                                   str(tmp_path / "pj.hdf5")])
    pred_t, _, _ = t_predict.main(["--device", "cpu", "--run-dir",
                                   str(tmp_path / "t"), "--input", k_file,
                                   "--output", str(tmp_path / "pt.hdf5")])
    pred_j = np.moveaxis(pred_j, -1, 1)
    np.testing.assert_allclose(pred_t, pred_j, rtol=1e-5,
                               atol=1e-5 * np.abs(pred_j).max())


def test_codec_topology_mismatch_raises_in_both(tmp_path):
    pth = _codec_pth(tmp_path, False)
    kw = dict(CODEC, blocks=[2, 2, 2])
    with pytest.raises(ValueError, match="--blocks/--growth-rate"):
        j_imp.import_codec_ckpt(pth, 7, str(tmp_path / "j"), **kw)
    with pytest.raises(ValueError, match="--blocks/--growth-rate"):
        t_imp.import_codec_ckpt(pth, 7, str(tmp_path / "t"), **kw)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix, str(k), np.asarray(v)


def _reference_names(params, batch_stats, constants):
    """The reference's state dict of a JAX glow: the inverse of
    ``convert_glow_state_dict``."""
    def name(path, leaf):
        parts = ["flow"] if path[0].startswith("revblock") else []
        for i, p in enumerate(path):
            if p.startswith("revlayer"):
                parts.append("revlayers")
            if p in ("norm1", "conv_zero") and path[i - 1] == "coupling_nn" \
                    and "denselayer1" in coupling_children[path[:i]]:
                parts.append("reduce")
            parts.append(p)
        return ".".join(parts + [leaf])

    coupling_children: dict = {}
    for path, _, _ in _flatten(params):
        for i in range(1, len(path)):
            coupling_children.setdefault(path[:i], set()).add(path[i])
    actnorms = {path for path, leaf, v in _flatten(params)
                if leaf == "weight" and v.ndim == 1}
    bns = {path for path, _, _ in _flatten(batch_stats)}
    sd = {}
    for path, leaf, v in _flatten(params):
        if leaf == "kernel":
            leaf, v = "weight", v.transpose(3, 2, 0, 1)
        elif leaf == "scale" and path in bns:
            leaf = "weight"
        elif leaf == "scale":
            v = v.reshape(1, -1, 1, 1)
        elif leaf in ("weight", "bias") and path in actnorms:
            v = v.reshape(-1, 1, 1)
        sd[name(path, leaf)] = v
    for path, leaf, v in _flatten(batch_stats):
        sd[name(path, {"mean": "running_mean", "var": "running_var"}[leaf])] = v
        sd[name(path, "num_batches_tracked")] = np.array(3)
    for path, leaf, v in _flatten(constants):
        sd[name(path, leaf)] = v
        if leaf == "p":
            c = v.shape[0]
            sd[name(path, "l_mask")] = np.tril(np.ones((c, c)), -1)
            sd[name(path, "u_mask")] = np.triu(np.ones((c, c)), 1)
            sd[name(path, "eye")] = np.eye(c)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _fast_glow_state(monkeypatch):
    """The JAX importer's template state with the model's init compiled as
    one program (op by op it takes about a minute on one core)."""
    create = j_gt.create_glow_state

    class _Init:
        def __init__(self, variables):
            self.variables = variables

        def init(self, *args, **kwargs):
            return self.variables

    def fast(model, key, sample_y, sample_x, **kw):
        init_key, _ = jax.random.split(key)
        v = jax.jit(functools.partial(model.init, train=False))(
            init_key, sample_y, sample_x)
        return create(_Init(v), key, sample_y, sample_x, **kw)

    monkeypatch.setattr(j_gt, "create_glow_state", fast)
    return fast


def test_glow_import_log_p_matches_jax(tmp_path, monkeypatch):
    """A reference-named cGlow .pth (saved as the reference's training dict)
    through both importers: ``convert_glow_state_dict`` of the JAX package
    gives the JAX tree back, the port's converter gives the names and
    shapes of the port's model, and log p(y|x) of the two run dirs agrees
    within 1e-5 relative; a topology mismatch raises in both."""
    fast = _fast_glow_state(monkeypatch)
    jm = jg.MultiScaleCondGlow(img_size=16, x_channels=1, y_channels=3,
                               enc_blocks=[2, 2, 2], flow_blocks=[2, 2, 2],
                               squeeze_order="reference")
    rng = np.random.default_rng(5)
    x = np.exp(rng.normal(0, 1, (2, 16, 16, 1))).astype(np.float32)
    y = (0.3 * rng.normal(0, 1, (2, 16, 16, 3))).astype(np.float32)
    vs = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(y), jnp.asarray(x)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.normal(0, 1, a.shape).astype(
            np.float32), dict(vs["params"]))
    tree = (params, dict(vs["batch_stats"]), dict(vs["constants"]))
    ref = _reference_names(*tree)
    assert any(k.startswith("flow.revblock2.revlayers.revlayer1.") for k in ref)
    assert any(".coupling_nn.reduce.conv_zero." in k for k in ref)

    back = j_ti.convert_glow_state_dict({k: v.numpy() for k, v in ref.items()})
    for got, want in zip(back, tree):
        got, want = list(_flatten(got)), list(_flatten(want))
        assert [(p, k) for p, k, _ in got] == [(p, k) for p, k, _ in want]
        for (_, _, a), (_, _, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)

    pth = str(tmp_path / "model_epoch9.pth")
    torch.save({"epoch": 9, "model": ref, "optimizer": {}, "logger": {}}, pth)
    j_imp.import_glow_ckpt(pth, 9, str(tmp_path / "j"), **GLOW)
    t_imp.import_glow_ckpt(pth, 9, str(tmp_path / "t"), **GLOW)
    assert set(convert_glow_state_dict(load_state_dict(pth))) == set(
        build_model(load_args(str(tmp_path / "t")), "cpu").state_dict())

    state, _ = fast(jm, jax.random.key(0), jnp.asarray(y[:1]),
                    jnp.asarray(x[:1]), lr_max=1e-3, total_steps=1)
    state = j_ckpt.restore_checkpoint(str(tmp_path / "j" / "checkpoints"), 9,
                                      state)
    _, logp_j, _ = jax.jit(functools.partial(jm.apply, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats,
         "constants": state.constants}, jnp.asarray(y), jnp.asarray(x))

    run_args = load_args(str(tmp_path / "t"))
    assert run_args.squeeze_order == "reference" and run_args.epochs == 9
    tm = build_model(run_args, "cpu")
    restore_weights(str(tmp_path / "t" / "checkpoints"), 9, tm)
    with torch.no_grad():
        _, logp_t, _ = tm.eval()(
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(y, -1, 1))),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=1e-5)

    kw = dict(GLOW, flow_blocks=[2, 3, 2])
    with pytest.raises(ValueError, match="--enc-blocks/--flow-blocks"):
        j_imp.import_glow_ckpt(pth, 9, str(tmp_path / "j2"), **kw)
    with pytest.raises(ValueError, match="--enc-blocks/--flow-blocks"):
        t_imp.import_glow_ckpt(pth, 9, str(tmp_path / "t2"), **kw)


def test_import_cli_defaults_to_cuda(tmp_path):
    """The importer runs on CUDA unless told otherwise and never falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_imp.main(["--pth", _codec_pth(tmp_path, False), "--out-run-dir",
                    str(tmp_path / "t")])

"""Port parity: the UQ suite (uq/uq.py) against the JAX package.

* ``GlowSurrogate.sample`` / ``predict`` of a 16^2 cGlow (enc/flow blocks
  [2, 2, 2], weights moved from the JAX model) with the eps the JAX
  surrogate draws from its key: samples, mean and variance within 1e-5 of
  their scale.
* ``propagate``: its chunking (the largest divisor of N up to the batch
  size, or the first whole batches when N has none near it) and its
  moments E[Y], Var over repeats of E[Y], E[Y^2] - E[Y]^2 against numpy
  on the very samples the surrogate drew (1e-5 relative).
* The five tasks on the same deterministic surrogate in both packages:
  ``nrmse_test.txt``, ``r2_test.txt``, ``log_stats.txt``,
  ``reliability_diagram.txt``, ``out_stats.mat`` and the ``plot_dist``
  arrays agree to 1e-6 relative (the all-NaN checkpoint included).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from pde_surrogate_torch.models.glow import MultiScaleCondGlow as TGlow
from pde_surrogate_torch.uq import uq as tuq
from pde_surrogate_torch.utils.from_jax import glow_state_dict_from_jax
from pde_surrogate_tpu.models.glow import MultiScaleCondGlow as JGlow
from pde_surrogate_tpu.train.glow_trainer import GlowState
from pde_surrogate_tpu.uq import uq as juq

torch.set_num_threads(1)
N, B = 16, 4


def _x(seed, n=B):
    return np.exp(np.random.default_rng(seed).normal(
        0, 1, (n, N, N, 1))).astype(np.float32)


def test_surrogate_sample_and_predict_match_jax():
    jm = JGlow(img_size=N, x_channels=1, y_channels=3, enc_blocks=[2, 2, 2],
               flow_blocks=[2, 2, 2])
    x = _x(0)
    vs = jax.device_get(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.zeros((B, N, N, 3)), jnp.asarray(x)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(np.float32), vs["params"])
    state = GlowState(jnp.zeros((), jnp.int32), params, vs["batch_stats"],
                      vs["constants"], None, jax.random.key(0))
    key = jax.random.key(3)
    js = juq.GlowSurrogate(jm, state, n_samples=3)
    samples = np.asarray(js.sample(x, key))
    mean, var = (np.asarray(a) for a in js.predict(x, key))
    eps = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(e), -1, 2))) for e in jm.apply(
        vs, key, 3, B, method=jm.create_noise)]

    tm = TGlow(N, 1, 3, [2, 2, 2], [2, 2, 2])
    tm.load_state_dict(glow_state_dict_from_jax(params, vs["batch_stats"],
                                                vs["constants"]))
    ts = tuq.GlowSurrogate(tm, n_samples=3)
    tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    got = ts.sample(tx, eps_list=eps).numpy()
    tmean, tvar = (a.numpy() for a in ts.predict(tx, eps_list=eps))
    for a, b in ((got, np.moveaxis(samples, -1, 2)),
                 (tmean, np.moveaxis(mean, -1, 1)),
                 (tvar, np.moveaxis(var, -1, 1))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    assert (tvar >= 0).all()


@pytest.mark.parametrize("n,batch,chunk", [(16, 8, 8), (14, 8, 7),
                                           (13, 8, 8)])
def test_propagate_chunks_and_moments_against_numpy(n, batch, chunk,
                                                    capsys):
    m = TGlow(N, 1, 3, [2, 2, 2], [2, 2, 2], seed=2)
    s = tuq.GlowSurrogate(m, n_samples=3)
    drawn = []
    sample = s.sample

    def recording(x, generator=None, eps_list=None):
        out = sample(x, generator, eps_list)
        drawn.append(out.double().numpy())
        return out

    s.sample = recording
    mc = torch.from_numpy(np.moveaxis(_x(4, n), -1, 1).copy())
    ee, ve, ev, vv = (a.double().numpy() for a in s.propagate(
        mc, seed=5, var_samples=2, batch_size=batch))
    n_chunks = (n // chunk)
    assert [d.shape[1] for d in drawn] == [chunk] * n_chunks * 2
    if n % chunk:
        assert "using first 8 MC samples" in capsys.readouterr().out
    per_rep = np.stack([np.stack(drawn[r * n_chunks:(r + 1) * n_chunks])
                        for r in range(2)])    # (rep, chunk, S, b, C, H, W)
    ey = per_rep.mean(axis=(2, 3)).mean(axis=1)
    eyy = (per_rep ** 2).mean(axis=(2, 3)).mean(axis=1)
    vy = eyy - ey ** 2
    for got, want in ((ee, ey.mean(0)), (ve, ey.var(0)), (ev, vy.mean(0)),
                      (vv, vy.var(0))):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    again = s.propagate(mc, seed=5, var_samples=2, batch_size=batch)
    assert torch.equal(again[0], torch.from_numpy(ee).float())


class _Stub:
    """A deterministic surrogate in either layout: the predictive mean and
    variance are fixed functions of x, ``propagate`` returns fixed fields
    and ``sample`` shifts the mean by +-sqrt(var)."""

    def __init__(self, nchw: bool, nan: bool = False):
        self.nchw, self.nan = nchw, nan
        self.device = torch.device("cpu")

    def _moments(self, x):
        x = np.asarray(x)
        if self.nchw:
            x = np.moveaxis(x, 1, -1)
        scale = np.array([1.0, 3.0, 0.5], np.float32)
        mean = np.tanh(np.log(x)) * scale
        var = (0.05 + 0.1 * np.log(x) ** 2) * scale ** 2
        if self.nan:
            mean = np.full_like(mean, np.nan)
        if self.nchw:
            return (torch.from_numpy(np.moveaxis(mean, -1, 1).copy()),
                    torch.from_numpy(np.moveaxis(var, -1, 1).copy()))
        return jnp.asarray(mean), jnp.asarray(var)

    def predict(self, x, key=None, eps_list=None):
        return self._moments(x)

    def sample(self, x, key=None, eps_list=None):
        mean, var = self._moments(x)
        if self.nchw:
            return torch.stack([mean - var.sqrt(), mean + var.sqrt()])
        return jnp.stack([mean - jnp.sqrt(var), mean + jnp.sqrt(var)])

    def propagate(self, mc_x, key, var_samples=10, batch_size=64):
        fields = [np.full((N, N, 3), v, np.float32) * np.arange(
            1, 4, dtype=np.float32) for v in (0.5, 0.01, 0.2, 0.003)]
        if self.nchw:
            return tuple(torch.from_numpy(np.moveaxis(f, -1, 0).copy())
                         for f in fields)
        return tuple(jnp.asarray(f) for f in fields)


def _uqs(tmp_path, nan=False):
    x, xm = _x(6, 8), _x(7, 12)
    y = np.random.default_rng(8).normal(0, 1, (8, N, N, 3)).astype(
        np.float32)
    ym = np.random.default_rng(9).normal(0, 1, (12, N, N, 3)).astype(
        np.float32)
    var = ((y - y.mean(0)) ** 2).sum((0, 1, 2))
    j = juq.UQCondGlow(_Stub(False, nan), (xm, ym), (x, y), var,
                       str(tmp_path / "j"), N, batch_size=4,
                       key=jax.random.key(0))

    def t(a):
        return np.ascontiguousarray(np.moveaxis(a, -1, 1))
    p = tuq.UQCondGlow(_Stub(True, nan), (t(xm), t(ym)), (t(x), t(y)), var,
                       str(tmp_path / "t"), N, batch_size=4)
    return j, p


def test_uq_tasks_match_jax(tmp_path):
    j, p = _uqs(tmp_path)
    for task in ("test_metric", "plot_reliability_diagram"):
        getattr(j, task)()
        getattr(p, task)()
    j.propagate_uncertainty(var_samples=2)
    p.propagate_uncertainty(var_samples=2)
    jp, jt = j.plot_dist(3)
    pp, pt = p.plot_dist(3)
    np.testing.assert_allclose(pp, np.asarray(jp), rtol=1e-6)
    np.testing.assert_array_equal(pt, jt)
    for name in ("nrmse_test.txt", "r2_test.txt", "log_stats.txt",
                 "uncertainty_quality/reliability_diagram.txt"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / name),
                                   np.loadtxt(tmp_path / "j" / name),
                                   rtol=1e-6, err_msg=name)
    # the JAX task draws its figures before it writes the .mat; the
    # numbers it writes are moveaxis(mc statistics, -1, 0) and the
    # surrogate's four fields
    mat = scipy.io.loadmat(tmp_path / "t" / "out_stats" / "out_stats.mat")
    np.testing.assert_allclose(mat["sample_mean"],
                               np.moveaxis(j.mc_y.mean(0), -1, 0), rtol=1e-6)
    np.testing.assert_allclose(mat["sample_var"],
                               np.moveaxis(j.mc_y.var(0), -1, 0), rtol=1e-6)
    for key, f in zip(("y_pred_EE", "y_pred_VE", "y_pred_EV", "y_pred_VV"),
                      _Stub(False).propagate(None, None)):
        np.testing.assert_array_equal(mat[key], np.moveaxis(
            np.asarray(f), -1, 0))
    # the same figures, and the numbers of the distribution estimate
    files = {d: {os.path.relpath(os.path.join(r, f), tmp_path / d)
                 for r, _, fs in os.walk(tmp_path / d) for f in fs}
             for d in ("j", "t")}
    assert files["t"] == files["j"] | {
        f"dist_estimate/{n}.npy" for n in ("locations", "pred", "target")}
    assert {f for f in files["j"] if f.endswith(".pdf")} >= {
        "uncertainty_quality/reliability_diagram_0.pdf",
        "out_stats/pred_mean_vs_MC.pdf"}


def test_uq_test_metric_all_nan_matches_jax(tmp_path):
    """A fully diverged checkpoint: NaN metrics and the abnormal-rate
    stats instead of a crash, as in the JAX package."""
    j, p = _uqs(tmp_path, nan=True)
    jrel, jr2 = j.test_metric()
    prel, pr2 = p.test_metric()
    assert np.isnan(prel).all() and np.isnan(pr2).all() and prel.shape == (3,)
    assert np.isnan(np.asarray(jrel)).all()
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t" / "log_stats.txt"),
                                  np.loadtxt(tmp_path / "j" / "log_stats.txt"))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t" / "log_stats.txt"),
                                  [8, 8, 1.0])

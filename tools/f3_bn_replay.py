"""Replay BatchNorm's fold from a trained DenseED state in the JAX package
and in the port, with no weight update (ROADMAP F3).

The state is an ``.npz`` of the port's DenseED state dict
(``pde_surrogate_torch/tools/f3_bn_split.py --export``, e.g. seed 4's
epoch 280 from the card).  The port loads it in float64 and in float32;
the JAX package loads it through
``pde_surrogate_tpu/utils/torch_import.convert_codec_state_dict``, built
twice: with ``shared_stats=True`` (its CLI's default) and with plain
BatchNorm.  Every case then takes the same train batches (one numpy
permutation of the train split, 128 batches of 32) in train mode, where
only the BatchNorm fold runs, and evaluates the val split as the CLIs do
(BatchNorm on its running statistics) at the start and after every 16
batches: 9 evals.

It compares every eval's R², rel-L2 and consistency (relative) and every
running statistic at every eval point (against each tensor's largest
value), and gives each case's range of u's R² over its evals.  The bounds
are those of ``tests/test_torch_codec_recipe.py`` (evals 5e-6, BatchNorm
statistics 4e-6), holding JAX's float32 against the port's float64; where
the port's own float32 run lies further than a third of a bound from its
float64 run, 3x that distance is used instead, and the bounds are printed
before any JAX case runs.  It also checks that both packages hold the
biased variance: the JAX variables' ``var`` is the state's
``running_var`` bit for bit, and after the first batch each package's
running variance is 0.9 of the old one plus 0.1 of the BatchNorm input's
biased batch variance (the port's float64 input moments), nearer to it
than to the fold of the unbiased variance.  Beside the bounded cases, the
JAX package with plain BatchNorm runs once more under ``jax.enable_x64``
(its shared-statistics path reduces in float32 whatever its input), which
tells the JAX package's float32 arithmetic from a difference of the fold
or the eval; and on the first batch each BatchNorm's float32 moments of
one input, the port's and the JAX package's (E[x²] − E[x]² from XLA's
float32 sums, as flax's), are held against their float64 values.

The data are the codec CLI's canonical splits (kle512 at 64², 4096 train
and 512 val fields), made on the CPU by the port's own code (the val
labels by K1's plain twin) into ``--data-dir``; ``--card-log`` names a
card run's log whose first line (the val output variation) they must
reproduce.

``--orders N`` runs instead, in the port's float32, the state's val
R² under precise statistics (``f3_bn_split.py`` (b)) taken in N batch
orders of the train split: how far the batch order alone moves them at
fixed weights.

    JAX_PLATFORMS=cpu python tools/f3_bn_replay.py \\
        --state logs/f3_seed4_epoch280.npz --card-log logs/f3_port_f32_seed4.log \\
        --out logs/f3_bn_replay_seed4.log
    JAX_PLATFORMS=cpu python tools/f3_bn_replay.py \\
        --state logs/f3_seed4_epoch280.npz --orders 4 \\
        --out logs/f3_precise_orders_seed4.log
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pde_surrogate_torch.models.codec import BatchNorm2d  # noqa: E402
from pde_surrogate_torch.models.codec import DenseED as TDenseED  # noqa: E402
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel  # noqa: E402
from pde_surrogate_torch.train import codec_trainer as ttr  # noqa: E402
from pde_surrogate_torch.utils.from_jax import \
    codec_state_dict_from_jax  # noqa: E402
from pde_surrogate_torch.utils.metrics import \
    r2_score as t_r2_score  # noqa: E402
from pde_surrogate_tpu.models.codec import DenseED as JDenseED  # noqa: E402
from pde_surrogate_tpu.models.codec import \
    _batch_moments as j_batch_moments  # noqa: E402
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel  # noqa: E402
from pde_surrogate_tpu.train import codec_trainer as jtr  # noqa: E402
from pde_surrogate_tpu.utils.metrics import \
    r2_score as j_r2_score  # noqa: E402
from pde_surrogate_tpu.utils.torch_import import (  # noqa: E402
    check_tree_match, convert_codec_state_dict)

BOUNDS = {"evals": 5e-6, "stats": 4e-6}
WEIGHT_BOUND = 10.0
MOMENTUM = 0.1
X64 = "JAX float64 plain BN"
# the replay: the CLI's batch and test batch, evals every 16 batches
N_BATCHES, BATCH, EVERY, TEST_BATCH = 128, 32, 16, 64
MODEL_KEYS = ("imsize", "blocks", "growth_rate", "init_features",
              "drop_rate", "upsample")


def load_state(path: str) -> tuple[dict, dict]:
    """(state dict of numpy arrays, meta) of an ``f3_bn_split --export``
    file."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        sd = {k: z[k] for k in z.files if k != "meta"}
    return sd, meta


def port_model(sd: dict, dtype, model_kw: dict) -> TDenseED:
    kw = dict(model_kw)
    model = TDenseED(1, 3, kw.pop("imsize"), kw.pop("blocks"), **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model.to(dtype)


def jax_model(sd: dict, shared_stats: bool, model_kw: dict,
              dtype=jnp.float32):
    """The JAX DenseED and its variables (in ``dtype``) from the port's
    state dict (``convert_codec_state_dict``), their tree checked against
    the model's own."""
    kw = dict(model_kw)
    jm = JDenseED(1, 3, imsize=kw.pop("imsize"), blocks=kw.pop("blocks"),
                  shared_stats=shared_stats, **kw)
    params, stats = convert_codec_state_dict(sd)
    n = model_kw["imsize"]
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, n, n, 1)), train=False))
    problems = check_tree_match({"params": params, "batch_stats": stats},
                                shapes)
    if problems:
        raise ValueError(f"the state does not fit the JAX DenseED: "
                         f"{problems[:5]}")
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)
    return jm, cast(params), cast(stats)


def _stats_port(model) -> dict:
    return {k: v.detach().double().numpy().copy()
            for k, v in model.state_dict().items() if "running" in k}


def _stats_jax(params, batch_stats) -> dict:
    sd = codec_state_dict_from_jax(jax.device_get(params),
                                   jax.device_get(batch_stats))
    return {k: v.double().numpy() for k, v in sd.items() if "running" in k}


def _input_moments(model, x) -> dict:
    """Each BatchNorm's (mean, biased var, count, float32 errors) of its
    input in a train-mode forward of ``x`` with the fold off (the model is
    left as it was): the moments in float64, and how far each package's
    float32 moments of the same input lie from them (relative to each
    tensor's largest value): the port's (``torch.var_mean``) and the JAX
    package's (``_batch_moments``, E[x²] − E[x]² from XLA's float32
    sums)."""
    out, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            m.fold_stats = False

            def take(module, inputs, name=name):
                x = inputs[0]
                var, mean = torch.var_mean(x.double(), dim=(0, 2, 3),
                                           unbiased=False)
                mean, var = mean.numpy(), var.numpy()
                t_var, t_mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                               unbiased=False)
                j_mean, j_var = j_batch_moments(jnp.asarray(
                    np.moveaxis(x.float().numpy(), 1, -1)))
                err = {k: [float(np.max(np.abs(np.asarray(g, np.float64)
                                               - w)) / np.max(np.abs(w)))
                           for g, w in ((gm, mean), (gv, var))]
                       for k, gm, gv in (("port", t_mean.numpy(),
                                          t_var.numpy()),
                                         ("jax", j_mean, j_var))}
                out[name] = (mean, var, x.numel() // x.shape[1], err)
            hooks.append(m.register_forward_pre_hook(take))
    model.train()
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.fold_stats = True
    return out


def replay_port(model, batches, val, every: int, test_batch: int) -> dict:
    """The port's replay: ``evals`` (n, 7: R² ×3, rel-L2 ×3, consistency),
    ``stats`` (a running-statistics dict per eval), ``u_r2``."""
    dtype = next(model.parameters()).dtype
    state = ttr.create_state(model, lr_max=1e-3, total_steps=1)
    sobel = TSobel(val[0].shape[-1], correct=True, filter_size=3)
    evaluate = ttr.make_eval_step(state, sobel, WEIGHT_BOUND)
    x_val, y_val, y_var = (torch.from_numpy(val[0]).to(dtype),
                           torch.from_numpy(val[1]).to(dtype),
                           torch.as_tensor(val[2]).to(dtype))

    def run_eval():
        outs = [evaluate(x_val[i:i + test_batch], y_val[i:i + test_batch])
                for i in range(0, len(x_val), test_batch)]
        r2 = t_r2_score(torch.cat([o["sse"] for o in outs]).sum(0), y_var)
        rel = torch.cat([o["rel_l2"] for o in outs]).mean(0)
        cons = torch.stack([o["consistency"] for o in outs]).mean()
        return np.concatenate([r2.numpy(), rel.numpy(), [float(cons)]])

    evals, stats = [run_eval()], [_stats_port(model)]
    with torch.no_grad():
        for i, xb in enumerate(batches, start=1):
            model.train()
            model(torch.from_numpy(xb).to(dtype))
            if i % every == 0:
                evals.append(run_eval())
                stats.append(_stats_port(model))
    return _result(evals, stats)


def replay_jax(jm, params, batch_stats, batches, val, every: int,
               test_batch: int, dtype=np.float32) -> dict:
    """The JAX package's replay, as ``replay_port``'s, its inputs in
    ``dtype``."""
    sobel = JSobel(val[0].shape[-1], correct=True, filter_size=3)
    evaluate = jtr.make_eval_step(jm, sobel, WEIGHT_BOUND)

    @jax.jit
    def fold(stats, x):
        _, new = jm.apply({"params": params, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])
        return new["batch_stats"]

    x_val = np.moveaxis(val[0], 1, -1).astype(dtype)
    y_val = np.moveaxis(val[1], 1, -1).astype(dtype)

    def run_eval(stats):
        state = jtr.CodecState(jnp.zeros((), jnp.int32), params, stats, None)
        outs = [evaluate(state, jnp.asarray(x_val[i:i + test_batch]),
                         jnp.asarray(y_val[i:i + test_batch]))
                for i in range(0, len(x_val), test_batch)]
        r2 = j_r2_score(jnp.concatenate([o["sse"] for o in outs]).sum(0),
                        jnp.asarray(val[2], dtype))
        rel = jnp.concatenate([o["rel_l2"] for o in outs]).mean(0)
        cons = jnp.mean(jnp.stack([o["consistency"] for o in outs]))
        return np.concatenate([np.asarray(r2), np.asarray(rel),
                               [float(cons)]])

    stats = batch_stats
    evals, snaps = [run_eval(stats)], [_stats_jax(params, stats)]
    for i, xb in enumerate(batches, start=1):
        stats = fold(stats, jnp.asarray(np.moveaxis(xb, 1, -1), dtype))
        if i == 1:
            first = _stats_jax(params, stats)
        if i % every == 0:
            evals.append(run_eval(stats))
            snaps.append(_stats_jax(params, stats))
    out = _result(evals, snaps)
    out["first_fold"] = first
    return out


def _result(evals, stats) -> dict:
    evals = np.array(evals)
    return {"evals": evals, "stats": stats,
            "u_r2": evals[:, 0], "u_r2_range": float(np.ptp(evals[:, 0]))}


def eval_err(got: dict, want: dict) -> float:
    """The largest relative difference over every eval's R², rel-L2 and
    consistency."""
    return float(np.max(np.abs(got["evals"] - want["evals"])
                        / np.abs(want["evals"])))


def stats_errs(got: dict, want: dict) -> dict:
    """Per running-statistic tensor, its largest difference over the eval
    points relative to the tensor's largest value there (absolute where
    that is 0)."""
    out = {}
    for g, w in zip(got["stats"], want["stats"]):
        for k, v in w.items():
            scale = np.max(np.abs(v)) or 1.0        # a mean still at 0
            e = float(np.max(np.abs(g[k] - v)) / scale)
            out[k] = max(out.get(k, 0.0), e)
    return out


def used_bounds(f32: dict, f64: dict) -> tuple[dict, dict]:
    """(the port's float32 distances from its float64 run, the bounds
    used): a recipe bound, or 3x the distance where that exceeds a third
    of the bound."""
    dist = {"evals": eval_err(f32, f64),
            "stats": max(stats_errs(f32, f64).values())}
    return dist, {k: (BOUNDS[k] if dist[k] <= BOUNDS[k] / 3 else 3 * dist[k])
                  for k in BOUNDS}


def biased_fold_check(moments: dict, before: dict, after: dict) -> dict:
    """How far ``after``'s running variances lie from the fold of the
    biased batch variance and from the fold of the unbiased one, each the
    largest over the layers relative to the tensor's largest value."""
    out = {"biased": 0.0, "unbiased": 0.0}
    for name, (_, var, m, _) in moments.items():
        key = f"{name}.running_var"
        scale = np.max(np.abs(after[key]))
        for kind, v in (("biased", var), ("unbiased", var * m / (m - 1))):
            want = (1 - MOMENTUM) * before[key] + MOMENTUM * v
            out[kind] = max(out[kind],
                            float(np.max(np.abs(after[key] - want)) / scale))
    return out


def canonical_data(data_dir: str, ntrain: int = 4096, nval: int = 512):
    """(train inputs, (val inputs, val labels, y_variation)) of the codec
    CLI's canonical splits, made on the CPU by the port if absent."""
    from pde_surrogate_torch.cli._codec_common import resolve_dataset_files
    from pde_surrogate_torch.cli.train_codec_mixed_residual import Parser
    from pde_surrogate_torch.data.hdf5 import load_data
    args = Parser().parse_args(["--device", "cpu", "--data-dir", data_dir,
                                "--ntrain", str(ntrain), "--ntest",
                                str(nval)])
    train, val = resolve_dataset_files(args)
    x_train, _, _ = load_data(train, ntrain)
    x_val, y_val, stats = load_data(val, nval, only_input=False,
                                    return_stats=True)
    return x_train, (x_val, y_val, stats["y_variation"])


def card_variation(path: str) -> np.ndarray:
    """The val output variation a card run's log gives on its first
    line."""
    with open(path) as f:
        line = f.readline()
    m = re.match(r"Test output variation per channel: \[([^\]]+)\]", line)
    if m is None:
        raise ValueError(f"{path}: no output variation on the first line")
    return np.array([float(v) for v in m.group(1).split()])


def run(state_path: str, data_dir: str, card_log: str | None,
        log=print) -> dict:
    """The replay of ``state_path`` on the canonical splits (made in
    ``data_dir``): ``compare``'s result."""
    sd, meta = load_state(state_path)
    model_kw = {k: meta["model"][k] for k in MODEL_KEYS}
    log(f"[f3_bn_replay] state {state_path}: {json.dumps(meta)}")
    x_train, val = canonical_data(data_dir)
    log(f"[f3_bn_replay] val output variation {val[2].tolist()} "
        f"({len(val[0])} fields, labels by K1's plain twin on the CPU)")
    if card_log:
        card = card_variation(card_log)
        diff = float(np.max(np.abs(val[2] - card) / card))
        log(f"[f3_bn_replay] the card's log {card_log}: {card.tolist()}, "
            f"largest relative difference {diff:.2e}")
        if diff > 1e-6:
            raise ValueError("the CPU's val split is not the card's")
    perm = np.random.default_rng(0).permutation(len(x_train))
    batches = [x_train[perm[i * BATCH:(i + 1) * BATCH]]
               for i in range(N_BATCHES)]
    log(f"[f3_bn_replay] {N_BATCHES} train batches of {BATCH} (permutation "
        f"seed 0), no weight update, evals at the start and after every "
        f"{EVERY}: {N_BATCHES // EVERY + 1} evals")
    return compare(sd, model_kw, batches, val, EVERY, TEST_BATCH, log)


def compare(sd: dict, model_kw: dict, batches, val, every: int,
            test_batch: int, log=print) -> dict:
    """Every case's replay of ``batches`` from the state ``sd`` and the
    comparisons of ``run``; ``val`` is (inputs, labels, y_variation)."""
    cases, times = {}, {}
    for name, dtype in (("port float64", torch.float64),
                        ("port float32", torch.float32)):
        tic = time.time()
        cases[name] = replay_port(port_model(sd, dtype, model_kw), batches,
                                  val, every, test_batch)
        times[name] = time.time() - tic
    f64 = cases["port float64"]
    dist, bounds = used_bounds(cases["port float32"], f64)
    for k in BOUNDS:
        log(f"[f3_bn_replay] port float32 vs float64, {k}: {dist[k]:.3e} "
            f"(recipe bound {BOUNDS[k]:g}; bound used {bounds[k]:.3e})")
    probe = port_model(sd, torch.float64, model_kw)
    moments = _input_moments(probe, torch.from_numpy(batches[0]).double())
    probe.train()
    with torch.no_grad():
        probe(torch.from_numpy(batches[0]).double())
    first = {"port float64": _stats_port(probe)}
    for shared in (True, False):
        name = f"JAX f32 {'shared_stats' if shared else 'plain BN'}"
        jm, params, stats = jax_model(sd, shared, model_kw)
        same = all(np.array_equal(np.asarray(v), sd[k])
                   for k, v in _stats_jax(params, stats).items())
        log(f"[f3_bn_replay] {name}: running_var loaded bit for bit: "
            f"{same}")
        if not same:
            raise ValueError("the JAX package did not load the statistics")
        tic = time.time()
        cases[name] = replay_jax(jm, params, stats, batches, val, every,
                                 test_batch)
        times[name] = time.time() - tic
        first[name] = cases[name].pop("first_fold")
    # not a bounded case: the JAX package's own float64 (its shared-stats
    # path reduces in float32 whatever the input), which tells JAX's
    # float32 arithmetic from a difference of the fold or the eval
    with jax.enable_x64(True):
        jm, params, stats = jax_model(sd, False, model_kw, jnp.float64)
        tic = time.time()
        x64 = replay_jax(jm, params, stats, batches, val, every, test_batch,
                         np.float64)
        times[X64] = time.time() - tic
    first[X64] = x64.pop("first_fold")
    before = f64["stats"][0]
    fold = {k: biased_fold_check(moments, before, v)
            for k, v in first.items()}
    for k, v in fold.items():
        log(f"[f3_bn_replay] {k}, first batch: running var from the "
            f"biased fold {v['biased']:.2e}, from the unbiased fold "
            f"{v['unbiased']:.2e}")
    result = {"bounds": bounds, "port_f32_distance": dist,
              "fold_check": fold, "cases": {}, "seconds": times}
    for name, case in cases.items():
        errs = stats_errs(case, f64)
        rec = {"u_r2": case["u_r2"].tolist(),
               "u_r2_range": case["u_r2_range"],
               "evals_err": eval_err(case, f64) if case is not f64 else 0.0,
               "stats_err": max(errs.values())}
        rec["within"] = (rec["evals_err"] <= bounds["evals"]
                         and rec["stats_err"] <= bounds["stats"])
        rec["first_over"] = next((k for k, e in errs.items()
                                  if e > bounds["stats"]), None)
        result["cases"][name] = rec
        log(f"[f3_bn_replay] {name} ({times[name]:.0f} s): u R2 over the "
            f"evals {' '.join(f'{v:.6f}' for v in rec['u_r2'])}, range "
            f"{rec['u_r2_range']:.6f}")
        if case is f64:
            continue
        log(f"[f3_bn_replay] {name} vs port float64: evals "
            f"{rec['evals_err']:.3e} (bound {bounds['evals']:.3e}), "
            f"statistics {rec['stats_err']:.3e} (bound "
            f"{bounds['stats']:.3e}): {'within' if rec['within'] else 'OUT'}"
            f"; first layer over: {rec['first_over']}")
        for k, e in errs.items():
            log(f"[f3_bn_replay]   {name} {k}: {e:.3e}")
    errs = stats_errs(x64, f64)
    result["jax_float64"] = {"u_r2": x64["u_r2"].tolist(),
                             "u_r2_range": x64["u_r2_range"],
                             "evals_err": eval_err(x64, f64),
                             "stats_err": max(errs.values())}
    log(f"[f3_bn_replay] {X64} ({times[X64]:.0f} s, no bound: the JAX "
        f"package's float64 against the port's): evals "
        f"{result['jax_float64']['evals_err']:.3e}, statistics "
        f"{result['jax_float64']['stats_err']:.3e}; u R2 range "
        f"{x64['u_r2_range']:.6f}")
    result["moments_f32"] = {
        pkg: {"mean": max(v[3][pkg][0] for v in moments.values()),
              "var": max(v[3][pkg][1] for v in moments.values())}
        for pkg in ("port", "jax")}
    worst = max(moments, key=lambda k: moments[k][3]["jax"][1])
    log(f"[f3_bn_replay] first batch, each BatchNorm's float32 moments of "
        f"the same input against float64 (largest over the layers): the "
        f"port's mean {result['moments_f32']['port']['mean']:.2e}, var "
        f"{result['moments_f32']['port']['var']:.2e}; the JAX package's "
        f"mean {result['moments_f32']['jax']['mean']:.2e}, var "
        f"{result['moments_f32']['jax']['var']:.2e} (largest at {worst})")
    ranges = [result["cases"][k]["u_r2_range"] for k in cases]
    result["u_r2_range_spread"] = (max(ranges) - min(ranges)) / max(ranges)
    log(f"[f3_bn_replay] u R2 ranges {' / '.join(f'{r:.6f}' for r in ranges)}"
        f": they differ by {100 * result['u_r2_range_spread']:.2f} % of "
        f"the largest")
    return result


def precise_orders(sd: dict, model_kw: dict, x_train, val, seeds,
                   batch: int = BATCH, test_batch: int = TEST_BATCH,
                   log=print) -> dict:
    """The port's float32 val evals at the state's weights under its own
    running statistics and under precise statistics
    (``f3_bn_split.precise_statistics``) taken over the train split in
    several batch orders (a numpy permutation from each of ``seeds``):
    how far the batch order alone moves the precise statistics' R²."""
    from pde_surrogate_torch.tools.f3_bn_split import (precise_statistics,
                                                       with_statistics)
    model = port_model(sd, torch.float32, model_kw)
    own = replay_port(model, [], val, 1, test_batch)["evals"][0]
    log(f"[f3_bn_replay] port float32, the state's running statistics: "
        f"R2 {' / '.join(f'{v:.6f}' for v in own[:3])}")
    rows = []
    for seed in seeds:
        perm = np.random.default_rng(seed).permutation(len(x_train))
        batches = [torch.from_numpy(x_train[perm[i:i + batch]])
                   for i in range(0, len(x_train) - batch + 1, batch)]
        stats = precise_statistics(model, batches)
        ev = replay_port(with_statistics(model, stats), [], val, 1,
                         test_batch)["evals"][0]
        rows.append(ev[:3].tolist())
        log(f"[f3_bn_replay] precise statistics, batch order {seed}: R2 "
            f"{' / '.join(f'{v:.6f}' for v in ev[:3])}")
    u = [r[0] for r in rows]
    log(f"[f3_bn_replay] u R2 over {len(rows)} batch orders: "
        f"{min(u):.6f}-{max(u):.6f}, range {max(u) - min(u):.6f}")
    return {"own": own[:3].tolist(), "precise": rows,
            "u_range": max(u) - min(u)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--state", default="logs/f3_seed4_epoch280.npz")
    p.add_argument("--data-dir", default="datasets/f3_replay")
    p.add_argument("--card-log", default=None)
    p.add_argument("--orders", type=int, default=0,
                   help="instead of the replay: precise statistics at the "
                        "state's weights in this many batch orders")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = open(args.out, "w") if args.out else None

    def log(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    if args.orders:
        sd, meta = load_state(args.state)
        log(f"[f3_bn_replay] state {args.state}: {json.dumps(meta)}")
        x_train, val = canonical_data(args.data_dir)
        res = precise_orders(sd, {k: meta["model"][k] for k in MODEL_KEYS},
                             x_train, val, range(args.orders), log=log)
        log(json.dumps({"f3_precise_orders": res}))
        ok = True
    else:
        res = run(args.state, args.data_dir, args.card_log, log=log)
        log(json.dumps({"f3_bn_replay": res}))
        ok = all(c["within"] for c in res["cases"].values())
    if out:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

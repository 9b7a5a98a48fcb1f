"""Train the canonical Sobel codec's last epochs in the JAX package and in
the port from one exported training state and one batch order (ROADMAP
F3).

The state is a full export of a card run (``pde_surrogate_torch/tools/
f3_bn_split.py --export``: the model ``.npz`` and ``<stem>_adam.npz``,
e.g. seed 4's epoch 280).  Each case loads it and trains on:

* ``port64`` / ``port32``: the port in float64 / float32 on the CPU,
  restored through its own ``CodecState`` (``f3_bn_split.restore_export``:
  the weights, the BatchNorm buffers, Adam's moments and step);
* ``jax32``: the JAX package in float32 with ``shared_stats=True``, its
  CLI's default;
* ``jax64``: the JAX package under ``jax.enable_x64`` with plain
  BatchNorm (its shared-statistics path reduces in float32 whatever its
  input).

The JAX package takes the weights and BatchNorm buffers through
``pde_surrogate_tpu/utils/torch_import.convert_codec_state_dict`` and
Adam's moments through the same layout map into optax's ``mu`` and
``nu``; its optax state comes from its own ``create_state``, with every
count (the schedule's and Adam's) set to the exported step.  Each
package trains with its own ``make_mixed_residual_step`` (the 3x3 Sobel
mixed residual, boundary weight 10: the codec CLI's defaults) under its
own OneCycle schedule at its own step (both lrs are printed at the first
and the last step of the schedule's tail and must agree within 1e-7
relative), and evaluates the val split after each epoch with its own
eval step, as the CLI does: R² u / sigma1 / sigma2, rel-L2 and the
flux-pressure consistency.  Every case takes, for each epoch e, the
batches of the port's ``DeviceDataset(train, batch_size, seed).
epoch_indices(e)`` with the run's own batch size and seed: the order the
card run took.

``--phase a`` runs the first epoch after the state in all four cases, at
most ``--at-once`` (2) processes at a time, each on its share of this
process's cores (a queue: a case starts when another ends), and holds
the JAX package's float64 against the port's float64 after steps 1, 8,
32 and 128 within the bounds of ``tests/test_torch_codec_recipe.py``
(losses 3e-5 relative, evals 5e-6 relative, parameters 7e-5 and running
statistics 4e-6 of each tensor's largest value), printed before any JAX
case runs; the float32 cases' distances from the port's float64 are
recorded beside them and bounded nowhere.  ``--phase b`` trains the tail
(by default epochs 281-300) in the listed ``--tails``
(``<case>:<state>``), from the same queue, each into its own log: a JSON
line per epoch and a closing summary with ``R_tail``, the range of u's
R² over the tail, beside the card run's own
``R_card`` over the same epochs from ``--card-log``.  ``--case`` runs one
case in this process (what both phases start).  ``--parts`` shows where
the JAX package's float64 step first parts from the port's, on the first
batch after the state (``first_parts``): its DenseED returns float32
whatever its compute dtype, and its Sobel einsums output float32.

The data are the codec CLI's canonical splits (kle512 at 64², 4096 train
and 512 val fields), made on the CPU by ``tools/f3_bn_replay.py``'s
``canonical_data`` into ``--data-dir``; the card log's first line (the
val output variation) must agree within 1e-6 relative.

    JAX_PLATFORMS=cpu python tools/f3_tail_replay.py --phase a \\
        --state logs/f3_tail_seed4_epoch280.npz \\
        --card-log logs/f3_tail_port_f32_seed4.log \\
        --out logs/f3_tail_replay_phase_a_seed4.log
    JAX_PLATFORMS=cpu nohup python tools/f3_tail_replay.py --phase b \\
        --tails jax32:logs/f3_tail_seed4_epoch280.npz \\
        port32:logs/f3_tail_seed4_epoch280.npz \\
        jax32:logs/f3_tail_seed1_epoch280.npz --out-dir logs &
    JAX_PLATFORMS=cpu python tools/f3_tail_replay.py --parts \
        --state logs/f3_tail_seed4_epoch280.npz \
        --out logs/f3_tail_replay_parts_seed4.log
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from f3_bn_replay import (canonical_data, card_variation,  # noqa: E402
                          jax_model, port_model)
from pde_surrogate_torch.data.pipeline import DeviceDataset  # noqa: E402
from pde_surrogate_torch.ops.darcy import \
    mixed_residual_loss as t_mixed_residual_loss  # noqa: E402
from pde_surrogate_torch.ops.filters import SobelFilter as TSobel  # noqa: E402
from pde_surrogate_torch.ops.filters import _sobel_operators  # noqa: E402
from pde_surrogate_torch.tools.f3_bn_split import (  # noqa: E402
    load_export, restore_export)
from pde_surrogate_torch.train import codec_trainer as ttr  # noqa: E402
from pde_surrogate_torch.train.schedules import \
    one_cycle_schedule as t_one_cycle  # noqa: E402
from pde_surrogate_torch.utils.from_jax import \
    codec_state_dict_from_jax  # noqa: E402
from pde_surrogate_torch.utils.metrics import \
    r2_score as t_r2_score  # noqa: E402
from pde_surrogate_tpu.ops.darcy import \
    mixed_residual_loss as j_mixed_residual_loss  # noqa: E402
from pde_surrogate_tpu.ops.filters import SobelFilter as JSobel  # noqa: E402
from pde_surrogate_tpu.train import codec_trainer as jtr  # noqa: E402
from pde_surrogate_tpu.train.schedules import \
    one_cycle_schedule as j_one_cycle  # noqa: E402
from pde_surrogate_tpu.utils.metrics import \
    r2_score as j_r2_score  # noqa: E402
from pde_surrogate_tpu.utils.torch_import import \
    convert_codec_state_dict  # noqa: E402

# tests/test_torch_codec_recipe.py's bounds, the JAX package against the
# port's float64
BOUNDS = {"steps": 3e-5, "evals": 5e-6, "params": 7e-5, "stats": 4e-6}
SNAP_STEPS = (1, 8, 32, 128)
LR_TOL = 1e-7
WEIGHT_BOUND = 10.0
TEST_BATCH = 64
LOSSES = ("loss", "loss_pde", "loss_dirichlet", "loss_neumann")
MODEL_KEYS = ("imsize", "blocks", "growth_rate", "init_features",
              "drop_rate", "upsample")
# name: (package, float64, the JAX DenseED's shared_stats)
CASES = {"port64": ("port", True, None), "port32": ("port", False, None),
         "jax32": ("jax", False, True), "jax64": ("jax", True, False)}
REFERENCE = "port64"


def _model_kw(meta: dict) -> dict:
    return {k: meta["model"][k] for k in MODEL_KEYS}


def total_steps(run: dict) -> int:
    """The OneCycle length as both CLIs compute it."""
    return run["epochs"] * (run["ntrain"] // run["batch_size"])


def _opt_kw(run: dict) -> dict:
    return dict(lr_max=run["lr"], total_steps=total_steps(run),
                div_factor=run["lr_div"], pct_start=run["lr_pct"],
                weight_decay=run["weight_decay"])


def batch_order(n_train: int, run: dict, epoch: int) -> np.ndarray:
    """(steps, batch) indices of ``epoch``: the codec CLI's
    ``DeviceDataset`` order for the run's seed and batch size."""
    ds = DeviceDataset(np.zeros(n_train, np.float32),
                       batch_size=run["batch_size"], seed=run["seed"],
                       device="cpu")
    return ds.epoch_indices(epoch).numpy()


def lr_check(run: dict, steps) -> list[dict]:
    """Each package's scheduled lr at ``steps`` (updates taken before),
    and their relative difference; raises beyond ``LR_TOL``."""
    args = (run["lr"], total_steps(run), run["lr_div"], run["lr_pct"])
    port, jax_fn = t_one_cycle(*args), j_one_cycle(*args)
    rows = []
    for s in steps:
        a, b = float(port(s)), float(jax_fn(jnp.asarray(s, jnp.int32)))
        rel = abs(a - b) / abs(b)
        rows.append({"step": s, "port": a, "jax": b, "rel": rel})
        if not rel <= LR_TOL:
            raise ValueError(f"step {s}: the lrs {a} and {b} differ by "
                             f"{rel:.2e} relative")
    return rows


class PortCase:
    """The port's training state from the export, its step and eval."""

    def __init__(self, path: str, float64: bool):
        sd, adam, meta = load_export(path)
        self.dtype = torch.float64 if float64 else torch.float32
        self.run = adam["meta"]
        model = port_model(sd, self.dtype, _model_kw(meta))
        self.state = ttr.create_state(model, **_opt_kw(self.run))
        restore_export(path, self.state)
        sobel = TSobel(meta["model"]["imsize"], correct=True, filter_size=3)
        self._step = ttr.make_mixed_residual_step(
            self.state, sobel, WEIGHT_BOUND, dropout_seed=self.run["seed"])
        self._eval = ttr.make_eval_step(self.state, sobel, WEIGHT_BOUND)

    @property
    def step_count(self) -> int:
        return self.state.step

    def lr(self) -> float:
        return float(self.state.schedule(self.state.step))

    def step(self, xb: np.ndarray) -> list[float]:
        m = self._step(torch.from_numpy(xb).to(self.dtype))
        return [float(m[k]) for k in LOSSES]

    def snapshot(self) -> dict:
        return {k: v.detach().double().numpy().copy()
                for k, v in self.state.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    def evaluate(self, val) -> np.ndarray:
        x_val, y_val, y_var = (torch.from_numpy(a).to(self.dtype)
                               for a in (val[0], val[1],
                                         np.asarray(val[2])))
        outs = [self._eval(x_val[i:i + TEST_BATCH], y_val[i:i + TEST_BATCH])
                for i in range(0, len(x_val), TEST_BATCH)]
        r2 = t_r2_score(torch.cat([o["sse"] for o in outs]).sum(0), y_var)
        rel = torch.cat([o["rel_l2"] for o in outs]).mean(0)
        cons = torch.stack([o["consistency"] for o in outs]).mean()
        return np.concatenate([r2.numpy(), rel.numpy(), [float(cons)]])


class _Given:
    """Stands for the flax model in ``create_state``: its ``init`` gives
    the imported variables."""

    def __init__(self, variables):
        self.variables = variables

    def init(self, key, sample, train):
        return self.variables


def _with_adam(opt_state, step: int, mu, nu):
    """``opt_state`` with its one ``ScaleByAdamState``'s moments replaced
    and every count (the injected schedule's and Adam's) set to
    ``step``."""
    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
            return node._replace(mu=mu, nu=nu)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*map(walk, node))
        if isinstance(node, tuple):
            return tuple(map(walk, node))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    out = walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"{len(found)} Adam states in the optax state")
    counts = []

    def count(a):
        if jnp.issubdtype(a.dtype, jnp.integer):
            counts.append(a)
            return jnp.full_like(a, step)
        return a

    out = jax.tree_util.tree_map(count, out)
    if len(counts) < 2:
        raise ValueError("the optax state holds no schedule count")
    return out


def jax_moments(adam: dict, dtype) -> tuple:
    """Adam's ``exp_avg`` and ``exp_avg_sq`` of the export as optax's
    ``mu`` and ``nu`` trees (``convert_codec_state_dict``'s layout map)."""
    trees = []
    for entry in ("exp_avg", "exp_avg_sq"):
        params, _ = convert_codec_state_dict(
            {name: v[entry] for name, v in adam["params"].items()})
        trees.append(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                            params))
    return tuple(trees)


class JaxCase:
    """The JAX package's training state from the export, its step and
    eval (call under ``jax.enable_x64`` for float64)."""

    def __init__(self, path: str, float64: bool, shared_stats: bool):
        sd, adam, meta = load_export(path)
        self.dtype = np.float64 if float64 else np.float32
        self.run = adam["meta"]
        jdtype = jnp.float64 if float64 else jnp.float32
        jm, params, stats = jax_model(sd, shared_stats, _model_kw(meta),
                                      jdtype)
        state, self.tx = jtr.create_state(
            _Given({"params": params, "batch_stats": stats}), None, None,
            **_opt_kw(self.run))
        mu, nu = jax_moments(adam, jdtype)
        step = adam["state_step"]
        self.state = state._replace(
            step=jnp.asarray(step, jnp.int32),
            opt_state=_with_adam(state.opt_state, step, mu, nu))
        sobel = JSobel(meta["model"]["imsize"], correct=True, filter_size=3)
        self._step = jtr.make_mixed_residual_step(
            jm, self.tx, sobel, WEIGHT_BOUND, dropout_seed=self.run["seed"])
        self._eval = jax.jit(jtr.make_eval_step(jm, sobel, WEIGHT_BOUND))
        self._schedule = j_one_cycle(self.run["lr"], total_steps(self.run),
                                     self.run["lr_div"], self.run["lr_pct"])

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def lr(self) -> float:
        return float(self._schedule(self.state.step))

    def step(self, xb: np.ndarray) -> list[float]:
        self.state, m = self._step(self.state, jnp.asarray(
            np.moveaxis(xb, 1, -1), self.dtype))
        return [float(m[k]) for k in LOSSES]

    def snapshot(self) -> dict:
        sd = codec_state_dict_from_jax(jax.device_get(self.state.params),
                                       jax.device_get(self.state.batch_stats))
        return {k: v.double().numpy() for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}

    def evaluate(self, val) -> np.ndarray:
        x_val = np.moveaxis(val[0], 1, -1).astype(self.dtype)
        y_val = np.moveaxis(val[1], 1, -1).astype(self.dtype)
        outs = [self._eval(self.state, jnp.asarray(x_val[i:i + TEST_BATCH]),
                           jnp.asarray(y_val[i:i + TEST_BATCH]))
                for i in range(0, len(x_val), TEST_BATCH)]
        r2 = j_r2_score(jnp.concatenate([o["sse"] for o in outs]).sum(0),
                        jnp.asarray(val[2], self.dtype))
        rel = jnp.concatenate([o["rel_l2"] for o in outs]).mean(0)
        cons = jnp.mean(jnp.stack([o["consistency"] for o in outs]))
        return np.concatenate([np.asarray(r2), np.asarray(rel),
                               [float(cons)]])


def run_case(case: str, path: str, x_train: np.ndarray, val, epochs,
             snap_steps=(), log=print) -> dict:
    """Train ``case`` from the export ``path`` over ``epochs``: per epoch
    the mean loss, the eval, the lr and the seconds; the losses of every
    step; the state after each of ``snap_steps`` (counted from the
    state's step)."""
    pkg, float64, shared = CASES[case]
    x64 = jax.enable_x64(True) if case == "jax64" else contextlib.nullcontext()
    with x64:
        tic = time.time()
        model = (PortCase(path, float64) if pkg == "port"
                 else JaxCase(path, float64, shared))
        start = model.step_count
        out = {"case": case, "start_step": start, "losses": [],
               "snapshots": {}, "epochs": [],
               "setup_seconds": time.time() - tic}
        for epoch in epochs:
            tic = time.time()
            lr_first = model.lr()
            losses = []
            for idx in batch_order(len(x_train), model.run, epoch):
                losses.append(model.step(x_train[idx]))
                done = model.step_count - start
                if done in snap_steps:
                    out["snapshots"][done] = model.snapshot()
            train_s = time.time() - tic
            ev = model.evaluate(val)
            row = {"epoch": epoch, "step": model.step_count,
                   "loss_train": float(np.mean([v[0] for v in losses])),
                   "lr_first": lr_first, "r2": ev[:3].tolist(),
                   "rel_l2": ev[3:6].tolist(), "consistency": float(ev[6]),
                   "train_seconds": train_s,
                   "seconds": time.time() - tic}
            out["losses"].extend(losses)
            out["epochs"].append(row)
            log(json.dumps({"f3_tail_epoch": {"case": case, **row}}))
    out["losses"] = np.array(out["losses"])
    return out


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))


def tensor_errs(got: dict, want: dict) -> dict:
    """Per tensor, the largest difference relative to the tensor's
    largest value (absolute where that is 0), split into parameters and
    running statistics: ``{kind: (largest, its tensor)}``."""
    out = {"params": (0.0, None), "stats": (0.0, None)}
    for k, w in want.items():
        scale = np.max(np.abs(w)) or 1.0
        e = float(np.max(np.abs(got[k] - w)) / scale)
        kind = "stats" if "running" in k else "params"
        if e >= out[kind][0]:
            out[kind] = (e, k)
    return out


def distances(got: dict, ref: dict, steps=SNAP_STEPS) -> dict:
    """``got``'s distances from ``ref`` at each of ``steps``: the losses
    of that step (relative), the parameters and the running statistics;
    and the first epoch's eval (relative)."""
    rows = {}
    for s in steps:
        errs = tensor_errs(got["snapshots"][s], ref["snapshots"][s])
        rows[s] = {"steps": _rel(got["losses"][s - 1], ref["losses"][s - 1]),
                   "params": errs["params"][0],
                   "params_at": errs["params"][1],
                   "stats": errs["stats"][0], "stats_at": errs["stats"][1]}
    def first_eval(res):
        row = res["epochs"][0]
        return np.array(row["r2"] + row["rel_l2"] + [row["consistency"]])

    return {"at": rows, "evals": _rel(first_eval(got), first_eval(ref))}


def holds(dist: dict, bounds: dict = BOUNDS, steps=SNAP_STEPS) -> bool:
    """Every recorded distance within its bound."""
    return dist["evals"] <= bounds["evals"] and all(
        dist["at"][s][k] <= bounds[k] for s in steps
        for k in ("steps", "params", "stats"))


def compare_phase_a(results: dict, log=print, steps=SNAP_STEPS) -> dict:
    """Every case's distances from the port's float64 run; phase A holds
    where the JAX package's float64 lies within ``BOUNDS`` at every
    recorded step."""
    ref = results[REFERENCE]
    out = {"bounds": BOUNDS, "cases": {}}
    for name, res in results.items():
        if name == REFERENCE:
            continue
        d = distances(res, ref, steps)
        out["cases"][name] = d
        for s in steps:
            r = d["at"][s]
            log(f"[f3_tail_replay] {name} vs {REFERENCE}, step {s}: loss "
                f"{r['steps']:.3e}, params {r['params']:.3e} "
                f"({r['params_at']}), stats {r['stats']:.3e} "
                f"({r['stats_at']})")
        log(f"[f3_tail_replay] {name} vs {REFERENCE}, epoch-end eval: "
            f"{d['evals']:.3e}")
    out["holds"] = holds(out["cases"]["jax64"], BOUNDS, steps)
    log(f"[f3_tail_replay] phase A {'holds' if out['holds'] else 'FAILS'}: "
        f"jax64 against {REFERENCE} at steps {list(steps)} within "
        f"{json.dumps(BOUNDS)}")
    return out


def first_parts(path: str, xb: np.ndarray) -> dict:
    """Where the JAX package's float64 step parts from the port's, on one
    batch ``xb`` from the state ``path`` before any update: the
    train-mode outputs (relative to the largest value; the JAX DenseED
    returns float32 whatever its compute dtype, so also against the
    port's output rounded to float32), each package's Sobel gradients of
    the port's output against numpy's float64 ones (the operators of
    ``SobelFilter``, exact in float32 for the 3x3 filter), and the four
    losses (relative)."""
    sd, _, meta = load_export(path)
    kw = _model_kw(meta)
    n = kw["imsize"]
    model = port_model(sd, torch.float64, kw).train()
    x = torch.from_numpy(xb).double()
    with torch.no_grad():
        out = model(x)
    t_sobel = TSobel(n, correct=True, filter_size=3)
    lh, rh, lv, rv = (a.astype(np.float64)[0]
                      for a in _sobel_operators(n, 3, True))
    u = out.numpy()
    want = {"grad_h": lh @ u @ rh, "grad_v": lv @ u @ rv}
    port = {"grad_h": t_sobel.grad_h(out).numpy(),
            "grad_v": t_sobel.grad_v(out).numpy()}
    t_losses = t_mixed_residual_loss(x, out, t_sobel, WEIGHT_BOUND)
    with jax.enable_x64(True):
        jm, params, stats = jax_model(sd, False, kw, jnp.float64)
        j_out, _ = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(np.moveaxis(xb, 1, -1), jnp.float64),
                            train=True, mutable=["batch_stats"])
        j_sobel = JSobel(n, correct=True, filter_size=3)
        o = jnp.asarray(np.moveaxis(u, 1, -1))
        grads = {k: getattr(j_sobel, k)(o) for k in want}
        dtype = str(grads["grad_h"].dtype)
        jax_g = {k: np.moveaxis(np.asarray(v, np.float64), -1, 1)
                 for k, v in grads.items()}
        j_losses = j_mixed_residual_loss(
            jnp.asarray(np.moveaxis(xb, 1, -1), jnp.float64), o, j_sobel,
            WEIGHT_BOUND)
        out_dtype = str(j_out.dtype)
        j_out = np.moveaxis(np.asarray(j_out, np.float64), -1, 1)
    scale = lambda a: float(np.max(np.abs(a)))  # noqa: E731
    flat = lambda ls: [float(ls[0]), *map(float, ls[1])]  # noqa: E731
    return {"output": scale(j_out - u) / scale(u), "output_dtype": out_dtype,
            "output_vs_rounded": scale(j_out - u.astype(np.float32))
            / scale(u),
            "sobel_port": {k: scale(port[k] - w) / scale(w)
                           for k, w in want.items()},
            "sobel_jax": {k: scale(jax_g[k] - w) / scale(w)
                          for k, w in want.items()},
            "sobel_jax_dtype": dtype,
            "losses": dict(zip(LOSSES, (abs(a - b) / abs(b) for a, b in zip(
                flat(j_losses), flat(t_losses)))))}


def card_r2(path: str, epochs) -> dict:
    """The card run's logged R² per epoch of ``epochs``, and ``R_card``,
    the range of u's over them."""
    with open(path) as f:
        text = f.read().partition("Finished training")[0]
    r2 = {int(e): [float(v) for v in vec.split()] for e, vec in re.findall(
        r"Epoch (\d+): test r2-score: \[([^\]]+)\]", text)}
    rows = {e: r2[e] for e in epochs if e in r2}
    u = [v[0] for v in rows.values()]
    return {"r2": rows, "R_card": max(u) - min(u) if u else None}


def summary(res: dict, card: dict | None) -> dict:
    """A tail's ``R_tail`` (the range of u's R² over its epochs), its
    per-epoch R², and the card's beside them."""
    u = [r["r2"][0] for r in res["epochs"]]
    return {"case": res["case"], "start_step": res["start_step"],
            "epochs": [res["epochs"][0]["epoch"], res["epochs"][-1]["epoch"]],
            "r2": {r["epoch"]: r["r2"] for r in res["epochs"]},
            "R_tail": max(u) - min(u), "u_r2": [min(u), max(u)],
            "R_card": None if card is None else card["R_card"],
            "card_r2": None if card is None else card["r2"],
            "seconds_per_epoch": float(np.median(
                [r["seconds"] for r in res["epochs"]]))}


def parse_log(path: str) -> dict:
    """The epoch rows and the closing summary of a tail's log."""
    rows, summ = [], None
    with open(path) as f:
        for line in f:
            if line.startswith('{"f3_tail_epoch"'):
                rows.append(json.loads(line)["f3_tail_epoch"])
            elif line.startswith('{"f3_tail_summary"'):
                summ = json.loads(line)["f3_tail_summary"]
    return {"epochs": rows, "summary": summ}


def data(data_dir: str, card_log: str | None, log=print) -> tuple:
    """The canonical splits, checked against the card log's variation."""
    x_train, val = canonical_data(data_dir)
    if card_log:
        card = card_variation(card_log)
        diff = float(np.max(np.abs(val[2] - card) / card))
        log(f"[f3_tail_replay] val output variation {val[2].tolist()}, the "
            f"card's {card.tolist()} ({card_log}): {diff:.2e} relative")
        if diff > 1e-6:
            raise ValueError("the CPU's val split is not the card's")
    return x_train, val


def _epochs(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def _save(res: dict, path: str):
    arrays = {"losses": res["losses"]}
    for s, snap in res["snapshots"].items():
        arrays.update({f"s{s}__{k}": v for k, v in snap.items()})
    np.savez(path, meta=np.array(json.dumps(
        {k: res[k] for k in ("case", "start_step", "epochs",
                             "setup_seconds")})), **arrays)


def _load(path: str) -> dict:
    with np.load(path) as z:
        res = json.loads(str(z["meta"]))
        res["losses"] = z["losses"]
        res["snapshots"] = {}
        for key in z.files:
            if key.startswith("s") and "__" in key:
                s, _, name = key.partition("__")
                res["snapshots"].setdefault(int(s[1:]), {})[name] = z[key]
    return res


def _spawn(argv: list[str], cores, log_path: str):
    """This script with ``argv`` on ``cores``, its output into
    ``log_path``."""
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv],
        stdout=out, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.sched_setaffinity(0, cores))
    return proc, out


def run_jobs(jobs: list, cores, at_once: int = 2) -> list[int]:
    """Run ``jobs`` ((argv, log path) each) from a queue, at most
    ``at_once`` at a time, each on its own share of ``cores`` (a job
    started when another ends takes that one's share); their exit
    codes, in the jobs' order."""
    cores = sorted(cores)
    at_once = max(1, min(at_once, len(jobs), len(cores)))
    share = len(cores) // at_once
    free = [cores[i * share:(i + 1) * share] for i in range(at_once)]
    queue, running, rcs = list(enumerate(jobs)), {}, {}
    while queue or running:
        while queue and free:
            i, (argv, path) = queue.pop(0)
            slot = free.pop(0)
            running[i] = (*_spawn(argv, slot, path), slot)
        time.sleep(2)
        for i, (proc, out, slot) in list(running.items()):
            if proc.poll() is not None:
                out.close()
                rcs[i] = proc.returncode
                free.append(slot)
                del running[i]
    return [rcs[i] for i in range(len(jobs))]


def phase_a(args, log) -> int:
    _, adam, meta = load_export(args.state)
    run = adam["meta"]
    log(f"[f3_tail_replay] phase A: {args.state} ({json.dumps(meta)}; "
        f"Adam {json.dumps(run)})")
    log(f"[f3_tail_replay] bounds, jax64 against {REFERENCE} at steps "
        f"{list(SNAP_STEPS)} and the epoch-end eval: {json.dumps(BOUNDS)}; "
        f"port32 and jax32 against {REFERENCE} recorded, bounded nowhere")
    data(args.data_dir, args.card_log, log)     # made before the cases
    first = run["epoch"] + 1
    os.makedirs(args.work, exist_ok=True)
    jobs = []
    # the float64 JAX case is the longest: it starts first
    for case in ("jax64", "port64", "port32", "jax32"):
        jobs.append((["--case", case, "--state", args.state, "--epochs",
                      str(first), "--snap", os.path.join(
                          args.work, f"{case}.npz"), "--data-dir",
                      args.data_dir], os.path.join(args.work,
                                                   f"{case}.log")))
    rcs = run_jobs(jobs, os.sched_getaffinity(0), args.at_once)
    results = {}
    for (argv, path), rc in zip(jobs, rcs):
        with open(path) as f:
            for line in f:
                if line.startswith("{") or "[f3_tail_replay]" in line:
                    log(line.rstrip())
        if rc != 0:
            log(f"[f3_tail_replay] {argv[1]} failed (rc {rc}), {path}")
            return 1
        results[argv[1]] = _load(argv[argv.index("--snap") + 1])
    out = compare_phase_a(results, log)
    out["seconds"] = {k: r["epochs"][0]["seconds"] for k, r in
                      results.items()}
    out["u_r2"] = {k: r["epochs"][0]["r2"][0] for k, r in results.items()}
    log(json.dumps({"f3_tail_phase_a": out}))
    return 0 if out["holds"] else 1


def phase_b(args, log) -> int:
    jobs = []
    for tail in args.tails:
        case, _, state = tail.partition(":")
        seed = load_export(state)[1]["meta"]["seed"]
        card = args.card_log_pattern.format(seed=seed)
        name = f"f3_tail_replay_{case}_seed{seed}"
        jobs.append((["--case", case, "--state", state, "--epochs",
                      args.epochs, "--data-dir", args.data_dir,
                      "--card-log", card, "--out",
                      os.path.join(args.out_dir, f"{name}.log")],
                     os.path.join(args.work, f"{name}.out")))
    os.makedirs(args.work, exist_ok=True)
    for argv, path in jobs:
        log(f"[f3_tail_replay] phase B: {' '.join(argv)}")
    rcs = run_jobs(jobs, os.sched_getaffinity(0), args.at_once)
    for (argv, _), rc in zip(jobs, rcs):
        res = parse_log(argv[argv.index("--out") + 1])["summary"]
        log(json.dumps({"f3_tail_phase_b": {"argv": argv, "rc": rc,
                                            "summary": res}}))
    return max(rcs)


def one_case(args, log) -> int:
    """``--case``: one case, its epochs logged; ``--snap`` keeps its
    losses and snapshots."""
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    sd, adam, meta = load_export(args.state)
    log(f"[f3_tail_replay] {args.case} from {args.state} on "
        f"{len(os.sched_getaffinity(0))} cores: {json.dumps(adam['meta'])}")
    x_train, val = data(args.data_dir, args.card_log, log)
    epochs = _epochs(args.epochs)
    run = adam["meta"]
    last = total_steps(run) - 1
    for row in lr_check(run, [adam["state_step"], last]):
        log(f"[f3_tail_replay] lr at step {row['step']}: port "
            f"{row['port']:.9e}, JAX {row['jax']:.9e} ({row['rel']:.1e})")
    res = run_case(args.case, args.state, x_train, val, epochs,
                   SNAP_STEPS if args.snap else (), log)
    log(f"[f3_tail_replay] {args.case}: set-up {res['setup_seconds']:.1f} "
        f"s, first epoch {res['epochs'][0]['seconds']:.1f} s")
    if args.snap:
        _save(res, args.snap)
    card = card_r2(args.card_log, epochs) if args.card_log else None
    summ = summary(res, card)
    log(f"[f3_tail_replay] {args.case}: R_tail {summ['R_tail']:.6f} over "
        f"epochs {summ['epochs']}, u R2 {summ['u_r2']}; R_card "
        f"{summ['R_card']}")
    log(json.dumps({"f3_tail_summary": summ}))
    return 0


def parts(args, log) -> int:
    """``--parts``: ``first_parts`` on the first batch after the state."""
    _, adam, _ = load_export(args.state)
    x_train, _ = data(args.data_dir, args.card_log, log)
    epoch = adam["meta"]["epoch"] + 1
    idx = batch_order(len(x_train), adam["meta"], epoch)[0]
    res = first_parts(args.state, x_train[idx])
    log(f"[f3_tail_replay] {args.state}, epoch {epoch}'s first batch, "
        f"before any update: JAX float64 (plain BatchNorm) against the "
        f"port's float64: outputs {res['output']:.3e} (the JAX DenseED's "
        f"are {res['output_dtype']}, {res['output_vs_rounded']:.3e} from "
        f"the port's rounded to float32); Sobel gradients of "
        f"the port's output against numpy float64: the port's "
        f"{json.dumps(res['sobel_port'])}, the JAX package's "
        f"{json.dumps(res['sobel_jax'])} ({res['sobel_jax_dtype']}); "
        f"losses {json.dumps(res['losses'])}")
    log(json.dumps({"f3_tail_parts": res}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phase", choices=["a", "b"], default=None)
    p.add_argument("--case", choices=list(CASES), default=None)
    p.add_argument("--parts", action="store_true",
                   help="where the JAX float64 step first parts from the "
                        "port's, on the first batch after the state")
    p.add_argument("--state", default="logs/f3_tail_seed4_epoch280.npz")
    p.add_argument("--tails", nargs="*", default=[],
                   help="phase B: <case>:<state> entries")
    p.add_argument("--epochs", default="281-300")
    p.add_argument("--data-dir", default="datasets/f3_replay")
    p.add_argument("--card-log", default=None)
    p.add_argument("--card-log-pattern",
                   default="logs/f3_tail_port_f32_seed{seed}.log",
                   help="phase B: each tail's card log, by the state's seed")
    p.add_argument("--work", default="datasets/f3_tail_work",
                   help="the cases' own outputs (phase A's snapshots)")
    p.add_argument("--snap", default=None,
                   help="--case: keep the losses and the snapshots here")
    p.add_argument("--at-once", type=int, default=2,
                   help="the phases' cases running at once, each on an "
                        "equal share of this process's cores")
    p.add_argument("--out", default=None)
    p.add_argument("--out-dir", default="logs")
    args = p.parse_args(argv)
    out = open(args.out, "w") if args.out else None

    def log(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        if args.phase == "a":
            return phase_a(args, log)
        if args.phase == "b":
            return phase_b(args, log)
        if args.parts:
            return parts(args, log)
        if args.case:
            return one_case(args, log)
        p.error("give --phase or --case")
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    sys.exit(main())

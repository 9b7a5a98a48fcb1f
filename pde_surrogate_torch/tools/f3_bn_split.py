"""Split a codec run's late-epoch val R² flap into the BatchNorm running
statistics and the weights (ROADMAP F3).

For each checkpoint of ``--epochs`` (by default the run's last 20
epochs, from epoch 2 at the earliest) of a run made by
``cli.train_codec_mixed_residual`` (``--ckpt-freq 1``), this prints a row:

* (a) the val R² under the checkpoint's own running statistics, from the
  CLI's eval step over the run's val split in the CLI's batches (as
  ``tools/r2_breakdown.py`` runs it); it must reproduce the R² the CLI
  logged for that epoch within ``R2_TOL`` relative, else the tool raises;
* (b) the val R² under precise statistics (PreciseBN: Wu & Johnson,
  "Rethinking 'Batch' in BatchNorm", 2021, §3): on a copy of the model, a
  train-mode forward over the whole train split in that epoch's batches
  of the CLI, under ``torch.no_grad`` with every BatchNorm's fold off,
  whose hooks take each BatchNorm's input moments; each running mean
  becomes the mean of the batch means and each running variance the mean
  of (biased batch variance + batch mean²) minus that mean², i.e. the
  population's biased moments in the training batches' normalisation;
  the checkpoint file and the model handed in stay bit-equal (checked);
* (c) how far the parameters and the running statistics moved from the
  previous epoch's checkpoint, ‖θₑ − θₑ₋₁‖ / ‖θₑ‖ over all tensors, and
  the tensor that moved most by the same measure;
* (d) the share of u's val SSE carried by val fields 138, 38 and 28 (the
  three lowest-permeability fields of the canonical split) under (a) and
  under (b);

then a summary of their ranges and one JSON line with every row and
``R_run`` / ``R_pre``, the range (max − min) of u's R² over the rows under
(a) and under (b); ``--parse`` prints the summary of split logs' JSON
lines.
``--export EPOCH:PATH`` also writes that epoch's model state (parameters
and BatchNorm buffers, float32) to an ``.npz`` whose ``meta`` entry (a
JSON string) names the run, the epoch and the card (``nvidia-smi``'s name
and power limit), and beside it ``<stem>_adam.npz``, the rest of the
training state: Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` of every
parameter, keyed ``<parameter's state-dict name>.<entry>``, the
``CodecState`` step and the epoch, and a ``meta`` entry with what the
schedule and the batch order need (the run's ``seed``, ``batch_size``,
``lr``, ``lr_div``, ``lr_pct``, ``weight_decay``, ``epochs``,
``ntrain``).  The exported model, loaded back, must reproduce the CLI's
logged R² of that epoch within ``R2_TOL`` relative, else the tool raises.
``load_export`` reads both files (an export without the Adam file too);
``restore_export`` puts them into a ``CodecState``, which then steps as
the uninterrupted run does.

Run:  python3 -m pde_surrogate_torch.tools.f3_bn_split --run-dir <run dir> \
          --epochs 281-300 [--export 280:f3_tail_seed4_epoch280.npz] \
          [--device cuda]
      python3 -m pde_surrogate_torch.tools.f3_bn_split --parse \
          logs/f3_port_f32_seed4_split.log
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import subprocess

import numpy as np
import torch

from ..cli._codec_common import build_model, resolve_dataset_files
from ..data.hdf5 import load_args, load_data
from ..data.pipeline import DeviceDataset
from ..models.codec import BatchNorm2d
from ..ops.filters import SobelFilter
from ..train.checkpoint import checkpoint_file
from ..train.codec_trainer import create_state, make_eval_step
from ..utils.config import select_device
from ..utils.metrics import r2_score
from .r2_breakdown import _cli_r2

__all__ = ["precise_statistics", "with_statistics", "movement",
           "check_logged", "split_run", "export_state", "adam_path",
           "load_export", "restore_export", "check_export", "main"]

FIELDS = (138, 38, 28)
R2_TOL = 1e-5
LAST = 20       # the epochs whose u R^2 range r1_seeds.parse_log reports
# the run's settings that the schedule and the batch order need
RUN_KEYS = ("seed", "batch_size", "lr", "lr_div", "lr_pct", "weight_decay",
            "epochs", "ntrain")
ADAM = ("exp_avg", "exp_avg_sq", "step")


def _state_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def precise_statistics(model: torch.nn.Module, batches) -> dict:
    """Each BatchNorm's population moments over ``batches`` (an iterable of
    input tensors, or of tuples whose first item is the input), as
    ``{module name: (mean, biased var)}`` in float64, from a train-mode
    forward of a copy of ``model`` with every fold off; ``model`` is left
    as it was."""
    before = {k: v.clone() for k, v in model.state_dict().items()}
    work = copy.deepcopy(model).train()
    norms = {name: m for name, m in work.named_modules()
             if isinstance(m, BatchNorm2d)}
    sums = {name: [0.0, 0.0, 0] for name in norms}

    def hook(name):
        def take(module, inputs):
            x = inputs[0].double()
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            acc = sums[name]
            acc[0] = acc[0] + mean
            acc[1] = acc[1] + var + mean ** 2
            acc[2] += 1
        return take

    for name, m in norms.items():
        if m.stats_group is not None:
            raise ValueError("precise statistics take a one-process model")
        m.fold_stats = False
        m.register_forward_pre_hook(hook(name))
    n = 0
    with torch.no_grad():
        for batch in batches:
            work(batch[0] if isinstance(batch, (tuple, list)) else batch)
            n += 1
    stats = {}
    for name, (s1, s2, count) in sums.items():
        if count != n:
            raise RuntimeError(f"{name} saw {count} of {n} batches")
        mean = s1 / n
        stats[name] = (mean, s2 / n - mean ** 2)
    if not _state_equal(before, model.state_dict()):
        raise RuntimeError("the precise statistics changed the model")
    return stats


def with_statistics(model: torch.nn.Module, stats: dict) -> torch.nn.Module:
    """A copy of ``model`` whose BatchNorms' running buffers hold
    ``stats`` (``precise_statistics``'s), cast to the buffers' dtype."""
    out = copy.deepcopy(model)
    modules = dict(out.named_modules())
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            bn = modules[name]
            bn.running_mean.copy_(mean.to(bn.running_mean.dtype))
            bn.running_var.copy_(var.to(bn.running_var.dtype))
    return out


def movement(prev: dict, cur: dict) -> dict:
    """‖cur − prev‖ / ‖cur‖ over all parameters and over all running
    statistics of two state dicts, each with the tensor of the largest
    such ratio of its own."""
    out = {}
    for kind in ("params", "stats"):
        keys = [k for k in cur if not k.endswith("num_batches_tracked")
                and ("running" in k) == (kind == "stats")]
        d2 = {k: float(((cur[k].double() - prev[k].double()) ** 2).sum())
              for k in keys}
        n2 = {k: float((cur[k].double() ** 2).sum()) for k in keys}
        ratio = {k: (d2[k] / n2[k]) ** 0.5 if n2[k] else 0.0 for k in keys}
        top = max(ratio, key=ratio.get)
        out[kind] = {"rel": (sum(d2.values()) / sum(n2.values())) ** 0.5,
                     "largest": top, "largest_rel": ratio[top]}
    return out


def check_logged(r2, logged, epoch: int, tol: float = R2_TOL) -> float:
    """The largest relative difference of ``r2`` from the CLI's ``logged``
    R² of ``epoch``; raises where it exceeds ``tol`` or nothing was
    logged."""
    if logged is None:
        raise ValueError(f"epoch {epoch}: the run logged no R²")
    logged = np.asarray(logged, np.float64)
    diff = float(np.max(np.abs(np.asarray(r2) - logged) / np.abs(logged)))
    if not diff <= tol:
        raise ValueError(f"epoch {epoch}: R² {list(r2)} does not reproduce "
                         f"the CLI's {logged.tolist()} (relative "
                         f"{diff:.3e} > {tol:g})")
    return diff


def _evaluate(model, run_args, val_ds, y_variation) -> tuple:
    """(R² per channel, per-sample SSE (N, 3) as float64 numpy) of the
    CLI's eval step over the val batches."""
    state = create_state(model, lr_max=1e-3, total_steps=1)
    sobel = SobelFilter(run_args.imsize, correct=True,
                        filter_size=getattr(run_args, "sobel_size", 3))
    eval_step = make_eval_step(state, sobel, run_args.weight_bound,
                               physics=getattr(run_args, "physics", "sobel"))
    sse = torch.cat([eval_step(xb, yb)["sse"] for xb, yb in val_ds.batches(0)])
    r2 = r2_score(sse.sum(0), y_variation).cpu().numpy()
    return r2, sse.cpu().numpy().astype(np.float64)


def _fmt(r2) -> str:
    return " / ".join(f"{v:.6f}" for v in r2)


def _share(sse: np.ndarray) -> float:
    return float(sse[list(FIELDS), 0].sum() / sse[:, 0].sum())


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _load_model(path: str, model) -> dict:
    sd = torch.load(path, map_location=next(model.parameters()).device,
                    weights_only=True)["model"]
    model.load_state_dict(sd)
    return {k: v.clone() for k, v in model.state_dict().items()}


def card_name_power() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def adam_path(path: str) -> str:
    """The Adam file beside the model export ``path``:
    ``<stem>_adam.npz``."""
    return (path[:-4] if path.endswith(".npz") else path) + "_adam.npz"


def export_state(run_dir: str, epoch: int, path: str) -> dict:
    """Write the model state of ``run_dir``'s checkpoint ``epoch`` to
    ``path`` (float32 tensors, ``num_batches_tracked`` int64) with a
    ``meta`` JSON string, and its Adam state to ``adam_path(path)``;
    returns the model file's meta."""
    ckpt = torch.load(checkpoint_file(os.path.join(run_dir, "checkpoints"),
                                      epoch), map_location="cpu",
                      weights_only=True)
    sd = ckpt["model"]
    run_args = load_args(run_dir)
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked")))
    meta = {"run": os.path.basename(os.path.normpath(run_dir)),
            "epoch": epoch, "seed": run_args.seed, "n_params": n_params,
            "card": card_name_power(),
            "model": {k: getattr(run_args, k) for k in
                      ("imsize", "blocks", "growth_rate", "init_features",
                       "drop_rate", "upsample")}}
    arrays = {k: v.numpy() if v.dtype == torch.int64
              else v.float().numpy() for k, v in sd.items()}
    np.savez(path, meta=np.array(json.dumps(meta)), **arrays)

    # the optimizer's state is keyed by the parameters' order in
    # model.parameters(), which is named_parameters()'s
    names = [n for n, _ in build_model(run_args, "cpu").named_parameters()]
    (group,) = ckpt["optimizer"]["param_groups"]
    if len(group["params"]) != len(names):
        raise ValueError(f"{len(group['params'])} optimizer entries for "
                         f"{len(names)} parameters")
    adam = {}
    for index, name in zip(group["params"], names):
        entry = ckpt["optimizer"]["state"][index]
        if entry["exp_avg"].shape != sd[name].shape:
            raise ValueError(f"{name}: Adam's moments have shape "
                             f"{tuple(entry['exp_avg'].shape)}")
        for key in ADAM:
            adam[f"{name}.{key}"] = entry[key].numpy()
    adam_meta = {**{k: getattr(run_args, k) for k in RUN_KEYS},
                 "run": meta["run"], "epoch": epoch,
                 "state_step": int(ckpt["step"]),
                 "betas": list(group["betas"]), "eps": group["eps"],
                 "card": meta["card"]}
    np.savez(adam_path(path), meta=np.array(json.dumps(adam_meta)),
             state_step=np.array(int(ckpt["step"]), np.int64),
             epoch=np.array(epoch, np.int64), **adam)
    return meta


def load_export(path: str) -> tuple[dict, dict | None, dict]:
    """(model state dict of numpy arrays, Adam state or None, meta) of an
    ``export_state`` file; the Adam state, where ``adam_path(path)``
    exists, is ``{"params": {name: {entry: array}}, "state_step",
    "epoch", "meta"}``."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        sd = {k: z[k] for k in z.files if k != "meta"}
    if not os.path.isfile(adam_path(path)):
        return sd, None, meta
    with np.load(adam_path(path)) as z:
        params = {}
        for key in z.files:
            name, _, entry = key.rpartition(".")
            if entry in ADAM:
                params.setdefault(name, {})[entry] = z[key]
        adam = {"params": params, "state_step": int(z["state_step"]),
                "epoch": int(z["epoch"]),
                "meta": json.loads(str(z["meta"]))}
    return sd, adam, meta


def restore_export(path: str, state) -> dict:
    """Load the export ``path`` into ``state`` (a ``CodecState`` around a
    model of the export's shape, in any float dtype): the model state,
    Adam's moments and step per parameter, and ``state.step``.  Returns
    the Adam file's meta; raises where the export has no Adam file."""
    sd, adam, _ = load_export(path)
    if adam is None:
        raise FileNotFoundError(f"{adam_path(path)}: no Adam state beside "
                                f"{path}")
    state.model.load_state_dict({k: torch.from_numpy(np.array(v))
                                 for k, v in sd.items()})
    names = [n for n, _ in state.model.named_parameters()]
    if sorted(names) != sorted(adam["params"]):
        raise ValueError("the Adam file does not hold the model's "
                         "parameters")
    opt = state.optimizer.state_dict()
    (group,) = opt["param_groups"]
    opt["state"] = {index: {k: torch.from_numpy(np.array(v))
                            for k, v in adam["params"][name].items()}
                    for index, name in zip(group["params"], names)}
    state.optimizer.load_state_dict(opt)
    state.step = adam["state_step"]
    return adam["meta"]


def _run_data(run_dir: str, device) -> tuple:
    """(run args, val file, val DeviceDataset, y_variation, train
    DeviceDataset) of a run as its CLI made them."""
    run_args = load_args(run_dir)
    run_args.device = str(device)
    train_file, val_file = resolve_dataset_files(run_args)
    x_val, y_val, stats = load_data(val_file, run_args.ntest,
                                    only_input=False, return_stats=True)
    val_ds = DeviceDataset(x_val, y_val, batch_size=run_args.test_batch_size,
                           seed=run_args.seed + 1, device=device,
                           shuffle=False)
    x_train, _, _ = load_data(train_file, run_args.ntrain)
    train_ds = DeviceDataset(x_train, batch_size=run_args.batch_size,
                             seed=run_args.seed, device=device)
    y_variation = torch.as_tensor(stats["y_variation"], device=device)
    return run_args, val_file, val_ds, y_variation, train_ds


def check_export(run_dir: str, epoch: int, path: str, device="cuda") -> dict:
    """The val R² of the model export ``path`` loaded back into the run's
    DenseED, and its largest relative difference from the R² the CLI
    logged for ``epoch``; raises beyond ``R2_TOL``."""
    device = select_device(device) if isinstance(device, str) else device
    run_args, _, val_ds, y_variation, _ = _run_data(run_dir, device)
    sd, _, _ = load_export(path)
    model = build_model(run_args, device)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    r2, _ = _evaluate(model, run_args, val_ds, y_variation)
    logged = _cli_r2(os.path.join(run_dir, "checkpoints"), epoch,
                     getattr(run_args, "log_freq", 1))
    return {"epoch": epoch, "r2": r2.tolist(), "logged": logged,
            "rel_diff": check_logged(r2, logged, epoch)}


def split_run(run_dir: str, epochs, device="cuda", log=print) -> dict:
    """The rows of ``main`` for ``epochs`` of ``run_dir``, and the ranges
    ``R_run`` and ``R_pre`` of u's R² over them."""
    device = select_device(device) if isinstance(device, str) else device
    run_args, val_file, val_ds, y_variation, train_ds = _run_data(run_dir,
                                                                  device)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if val_ds.n <= max(FIELDS):
        raise ValueError(f"{val_file}: {val_ds.n} val fields, fewer than "
                         f"field {max(FIELDS)} needs")
    model = build_model(run_args, device)
    log(f"[f3_bn_split] {run_dir}: seed {run_args.seed}, {val_ds.n} val "
        f"fields of {val_file}, {len(train_ds)} train batches of "
        f"{run_args.batch_size}; u SSE share of val fields "
        f"{'/'.join(map(str, FIELDS))}")
    rows = []
    for epoch in epochs:
        path = checkpoint_file(ckpt_dir, epoch)
        digest = _sha256(path)
        prev_path = checkpoint_file(ckpt_dir, epoch - 1)
        prev = (_load_model(prev_path, model) if os.path.isfile(prev_path)
                else None)
        cur = _load_model(path, model)
        r2_a, sse_a = _evaluate(model, run_args, val_ds, y_variation)
        logged = _cli_r2(ckpt_dir, epoch, getattr(run_args, "log_freq", 1))
        diff = check_logged(r2_a, logged, epoch)
        precise = precise_statistics(model, train_ds.batches(epoch))
        r2_b, sse_b = _evaluate(with_statistics(model, precise), run_args,
                                val_ds, y_variation)
        if not _state_equal(cur, model.state_dict()):
            raise RuntimeError(f"epoch {epoch}: the model was changed")
        if _sha256(path) != digest:
            raise RuntimeError(f"epoch {epoch}: {path} was changed")
        move = None if prev is None else movement(prev, cur)
        row = {"epoch": epoch, "r2_run": r2_a.tolist(),
               "r2_logged_rel_diff": diff, "r2_precise": r2_b.tolist(),
               "movement": move, "fields_share_run": _share(sse_a),
               "fields_share_precise": _share(sse_b)}
        rows.append(row)
        moved = ("no previous checkpoint" if move is None else
                 f"params {move['params']['rel']:.3e} (most "
                 f"{move['params']['largest']} {move['params']['largest_rel']:.3e}), "
                 f"stats {move['stats']['rel']:.3e} (most "
                 f"{move['stats']['largest']} {move['stats']['largest_rel']:.3e})")
        log(f"[f3_bn_split] epoch {epoch}: R2 run {_fmt(r2_a)} (CLI's "
            f"within {diff:.1e}), precise {_fmt(r2_b)}; moved {moved}; "
            f"u SSE share "
            f"run {100 * row['fields_share_run']:.2f} %, precise "
            f"{100 * row['fields_share_precise']:.2f} %")
    u_a = [r["r2_run"][0] for r in rows]
    u_b = [r["r2_precise"][0] for r in rows]
    return {"run_dir": run_dir, "seed": run_args.seed, "fields": FIELDS,
            "rows": rows, "R_run": max(u_a) - min(u_a),
            "R_pre": max(u_b) - min(u_b), "card": card_name_power()}


def summarize(res: dict) -> dict:
    """The ranges over the rows of ``split_run``'s result: u's R² under
    (a) and (b), the moves of (c) (rows with a previous checkpoint) and
    the three fields' shares of (d), each as [min, max]."""
    rows = res["rows"]
    moved = [r["movement"] for r in rows if r["movement"]]

    def span(vals):
        return [min(vals), max(vals)] if vals else None

    return {"seed": res["seed"], "epochs": [rows[0]["epoch"],
                                            rows[-1]["epoch"]],
            "R_run": res["R_run"], "R_pre": res["R_pre"],
            "u_r2_run": span([r["r2_run"][0] for r in rows]),
            "u_r2_precise": span([r["r2_precise"][0] for r in rows]),
            "last": {"r2_run": rows[-1]["r2_run"],
                     "r2_precise": rows[-1]["r2_precise"]},
            "params_move": span([m["params"]["rel"] for m in moved]),
            "stats_move": span([m["stats"]["rel"] for m in moved]),
            "stats_largest": sorted({m["stats"]["largest"] for m in moved}),
            "share_run": span([r["fields_share_run"] for r in rows]),
            "share_precise": span([r["fields_share_precise"]
                                   for r in rows])}


def _epoch_range(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run-dir", default=None)
    p.add_argument("--parse", nargs="*", default=[],
                   help="only summarize these split logs' JSON lines")
    p.add_argument("--epochs", type=_epoch_range, default=None,
                   help="checkpoint epochs, 'A-B' or 'A' (default: the "
                        f"run's last {LAST}, from epoch 2 at the earliest)")
    p.add_argument("--export", default=None,
                   help="EPOCH:PATH: write that epoch's model state as .npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.parse:
        out = {}
        for path in args.parse:
            with open(path) as f:
                line = [ln for ln in f if ln.startswith('{"f3_bn_split"')][-1]
            out[os.path.basename(path)] = summarize(
                json.loads(line)["f3_bn_split"])
        print(json.dumps({"f3_bn_split_summary": out}))
        return out
    if args.run_dir is None:
        p.error("--run-dir is required unless --parse is given")
    if args.export:
        epoch, _, path = args.export.partition(":")
        meta = export_state(args.run_dir, int(epoch), path)
        print(f"[f3_bn_split] wrote {path} and {adam_path(path)}: "
              f"{json.dumps(meta)}")
        check = check_export(args.run_dir, int(epoch), path, args.device)
        print(f"[f3_bn_split] the export reproduces epoch {epoch}'s logged "
              f"R2 {check['logged']} within {check['rel_diff']:.1e} "
              f"relative: {json.dumps(check)}")
    if args.epochs is None:
        last = load_args(args.run_dir).epochs
        args.epochs = list(range(max(last - LAST + 1, 2), last + 1))
    res = split_run(args.run_dir, args.epochs, args.device)
    print(f"[f3_bn_split] u R2 range over epochs {args.epochs[0]}-"
          f"{args.epochs[-1]}: R_run {res['R_run']:.6f} (running "
          f"statistics), R_pre {res['R_pre']:.6f} (precise statistics)")
    print(f"[f3_bn_split] summary: {json.dumps(summarize(res))}")
    print(json.dumps({"f3_bn_split": res}))
    return res


if __name__ == "__main__":
    main()

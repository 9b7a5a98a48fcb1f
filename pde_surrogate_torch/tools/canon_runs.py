"""The recommended fvcg codec recipe (R2) and the canonical 64² cGlow with
its UQ suite (R3) from given seeds, side by side on one card, stopped and
resumed across calls, and what each log says.

Kinds of ``--runs <kind>:<seed>``:

* ``fvcg``: ``cli.train_codec_mixed_residual`` with its defaults (DenseED
  [6,8,6]/16/48, 64², kle512, ntrain 4096, batch 32, 300 epochs) and
  ``--physics fvcg`` (64 CG iterations, the grid size); log
  ``<out>/r2_port_fvcg_seed<seed>.log``.  For an entry also in
  ``--breakdown``, ``tools/r2_breakdown.py`` then splits the val SSE of
  the last epoch's checkpoint (``..._breakdown.log``).
* ``cglow``: ``cli.train_cglow_reverse_kl`` with the JAX package's
  canonical flags (``CGLOW``), then ``cli.post_cglow`` with ``POST`` on
  its last checkpoint, then ``tools/glow_check.py --checkpoint`` on it
  (ROADMAP F2: the trained heads, the card against the CPU and float64);
  logs ``r3_port_cglow_seed<seed>.log`` (its ``training/metrics.jsonl``
  beside it as ``..._metrics.jsonl``), ``r3_port_post_cglow_seed<seed>.log``
  and ``r3_port_glow_check_seed<seed>.log``.

``--tag T`` ends every log name of the call in ``_T``
(``r3_port_cglow_seed1_full.log``).

On the card, ``nvidia-smi`` samples the card every ``MONITOR_S`` seconds
while the runs last: each sample, with the host's ``/proc/loadavg`` and
the run's phase and epoch, is appended to ``<out>/<run>_monitor.csv``
(``MONITOR_HEADER``), and ``parse_log`` reads it per range of 25 epochs
beside the samples/s.  A failing ``nvidia-smi`` ends the call with an
error.

Only ``--seed`` is added to a recipe.  The codec runs share one data dir
and the cGlow runs another (the cGlow's 8192-field train split is another
LHS design than the codec's 4096); every split is generated, its labels
solved by K1, before the runs start.

Stop and resume.  Each run's exp dir lives in ``--work`` (a copy of an
earlier call's ``--work`` comes in by ``--resume-from``).  A run whose
exp dir holds a checkpoint resumes from the latest (the codec by
``--ckpt-epoch``, the cGlow by ``--resume``) and appends to its log.  With
``--deadline-min M`` a run stops right after a checkpoint that its CLI
writes under its ``--ckpt-freq`` (by default 100 for the codec, 25 for
the cGlow) when, at its pace so far, the next one would come after M minutes
of this call; what still runs at M minutes is stopped there and resumes
from its last checkpoint (``--stop-after E`` stops each run after its
first checkpoint at or after epoch E instead).  A stopped part ends its
log with ``[canon_runs] stopped after epoch E; epochs A-E took X min``,
which ``parse_log`` adds to the minutes of the run. An unfinished cGlow
run keeps only its latest checkpoint, a finished run of either kind none,
so ``--work`` stays small enough to carry between calls.

One JSON line at the end holds ``parse_log`` of every run,
``parse_post_log`` of every UQ suite and glow_check's numbers; ``--parse``
only reads logs (the JAX package's too: a ``post_cglow`` or
``glow_check`` log by its name) and prints that line.

Run:  python3 -m pde_surrogate_torch.tools.canon_runs --runs fvcg:1 fvcg:2 \
          cglow:1 --breakdown fvcg:1 fvcg:2 --out canon --work canon/work \
          --deadline-min 55
      python3 -m pde_surrogate_torch.tools.canon_runs --parse \
          logs/fvcg2_kle512_300ep.log logs/post_cglow_kle512_canonical.log
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import os
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from .r1_seeds import _NUM, _vec
from .r1_seeds import parse_log as parse_codec_log

CODEC = "pde_surrogate_torch.cli.train_codec_mixed_residual"
GLOW = "pde_surrogate_torch.cli.train_cglow_reverse_kl"
# tools/run_campaign_r5e.sh:22-25 and :32-34, the JAX package's R3
CGLOW = ["--beta", "150", "--ntrain", "8192", "--kle", "512", "--imsize",
         "64", "--lr", "0.001", "--enc-blocks", "3,3,3,3", "--flow-blocks",
         "4,4,4,4", "--epochs", "200", "--ntest", "512"]
POST = ["--n-monte-carlo", "10000", "--ntest", "512", "--batch-size", "64"]
KINDS = {"fvcg": ("r2_port_fvcg", CODEC, ["--physics", "fvcg"]),
         "cglow": ("r3_port_cglow", GLOW, CGLOW)}
POLL_S = 0.5            # seconds between looks at the runs' logs
MONITOR_S = 30.0        # seconds between samples of the card
SMI_FIELDS = ("timestamp,clocks.sm,clocks.mem,power.draw,utilization.gpu,"
              "temperature.gpu,clocks_throttle_reasons.active")
MONITOR_HEADER = ("phase,epoch," + SMI_FIELDS
                  + ",load1,load5,load15,tasks,last_pid")
EPOCH_RANGE = 25        # epochs per range of the monitor's medians
STOPPED = re.compile(rf"\[canon_runs\] stopped after epoch (\d+); epochs "
                     rf"\d+-\d+ took ({_NUM}) min")


def _lead_number(field: str) -> float | None:
    """``1980 MHz`` -> 1980.0; ``[N/A]`` -> None."""
    m = re.match(_NUM, field.strip())
    return float(m.group(0)) if m else None


def _epoch_range(epoch: int) -> str:
    lo = (epoch - 1) // EPOCH_RANGE * EPOCH_RANGE + 1
    return f"{lo}-{lo + EPOCH_RANGE - 1}"


def parse_monitor(text: str, metrics: list[dict] | None = None) -> dict:
    """From a ``<run>_monitor.csv``: per range of 25 training epochs (and
    per follow-up phase), the median SM clock (MHz), GPU utilisation (%),
    power (W) and host 1-minute load, the throttle reasons seen (hex masks
    other than 0) and the number of samples; with ``metrics`` (the cGlow's
    records) the range's median samples/s too."""
    groups: dict[str, list[list[str]]] = {}
    for row in csv.reader(io.StringIO(text), skipinitialspace=True):
        if len(row) < 10 or row[0] == "phase":
            continue
        phase, epoch = row[0], int(row[1])
        groups.setdefault(_epoch_range(epoch) if phase == "train" else phase,
                          []).append(row)

    def med(rows, i):
        vals = [v for r in rows if (v := _lead_number(r[i])) is not None]
        return float(np.median(vals)) if vals else None
    out = {key: {"sm_mhz": med(rows, 3), "util_pct": med(rows, 6),
                 "power_w": med(rows, 5), "load1": med(rows, 9),
                 "throttle": sorted({r[8] for r in rows
                                     if r[8].startswith("0x")
                                     and int(r[8], 16)}),
                 "samples": len(rows)}
           for key, rows in groups.items()}
    if metrics is not None:
        rates: dict[str, list[float]] = {}
        for m in metrics:
            rates.setdefault(_epoch_range(m["epoch"]), []).append(
                m["samples_per_sec"])
        for key, v in out.items():
            v["samples_per_s"] = (float(np.median(rates[key])) if key in rates
                                  else None)
    return out


def parse_log(text: str, metrics: list[dict] | None = None,
              monitor: str | None = None) -> dict:
    """From a codec or cGlow training log of either package (a resumed
    run's parts too): R^2 and rel-L2 at the last epoch, with the codec's
    flux-pressure consistency or the cGlow's neg entropy; the selected
    epoch (the codec's label-free selection; the cGlow's last); u's R^2
    range over the last 20 epochs; the training loss at two fixed epochs
    (codec 200, 300; cGlow 100, 200) and at the last; the epochs whose loss
    rose above 1.5x the epoch before; the cGlow's skipped non-finite steps
    and non-finite epoch losses; the minutes of training over every part
    and the median samples/s (the codec's log lines; the cGlow's
    ``metrics``, its ``training/metrics.jsonl`` records); with
    ``monitor``, the text of its ``_monitor.csv``, ``parse_monitor``."""
    out = _parse_log(text, metrics)
    if monitor is not None:
        out["monitor"] = parse_monitor(monitor, metrics)
    return out


def _parse_log(text: str, metrics: list[dict] | None) -> dict:
    if "neg entropy" not in text:
        out = parse_codec_log(text)
        parts = [float(m) for _, m in STOPPED.findall(text)]
        if parts and out.get("epochs"):
            out["minutes"] = sum(parts) + (out["minutes"] or 0.0)
            out["parts"] = len(parts) + ("Finished training" in text)
        return out
    body, _, tail = text.partition("Finished training")
    loss = {int(e): (float(v), float(n), int(s or 0)) for e, v, n, s in
            re.findall(rf"Epoch (\d+): training loss: ({_NUM}), neg entropy "
                       rf"({_NUM}), lr {_NUM}(?:, (\d+) non-finite)?", body)}
    r2 = {int(e): _vec(v) for e, v in
          re.findall(r"Epoch (\d+): test r2-score: \[([^\]]+)\]", body)}
    rel = {int(e): _vec(v) for e, v in
           re.findall(r"Epoch (\d+): test relative l2: \[([^\]]+)\]", body)}
    if not loss:
        return {"epochs": 0}
    last = max(loss)
    seq = [loss[e][0] for e in sorted(loss)]
    window = [r2[e][0] for e in range(last - 19, last + 1) if e in r2]
    final = re.search(rf" using ({_NUM}) mins", tail)
    parts = [float(m) for _, m in STOPPED.findall(text)]
    if final:
        parts.append(float(final.group(1)))
    rates = [m["samples_per_sec"] for m in metrics or [] if m["epoch"] > 1]
    return {"epochs": last, "r2": r2.get(last), "rel_l2": rel.get(last),
            "neg_entropy": loss[last][1],
            "u_r2_last20": [min(window), max(window)] if window else None,
            "loss_at": {e: loss[e][0] if e in loss else None
                        for e in (100, 200, last)},
            "rises_1p5": sum(b > 1.5 * a for a, b in zip(seq, seq[1:])),
            "skipped_steps": sum(v[2] for v in loss.values()),
            "nonfinite_epochs": sum(not np.isfinite(v[0])
                                    for v in loss.values()),
            "selected_epoch": last,
            "minutes": sum(parts) if parts else None, "parts": len(parts),
            "median_samples_per_s": (float(np.median(rates)) if rates
                                     else None)}


def parse_post_log(text: str) -> dict:
    """From a ``post_cglow`` log of either package: the predictive mean's
    rel-L2 and R^2 over the test split, ``num_nan_inf``, the abnormal rate
    and (the port's) seconds of each UQ task."""
    vecs = re.findall(r"^\[([-+\d.eE\s]+)\]$", text, re.M)
    nan = re.search(r"num_nan_inf: (\d+)", text)
    rate = re.search(rf"abnormal rate: ({_NUM})", text)
    return {"rel_l2": _vec(vecs[0]) if vecs else None,
            "r2": _vec(vecs[1]) if len(vecs) > 1 else None,
            "num_nan_inf": int(nan.group(1)) if nan else None,
            "abnormal_rate": float(rate.group(1)) if rate else None,
            "seconds": {k: float(v) for k, v in re.findall(
                rf"\[post\] (\w+): ({_NUM}) s", text)}}


def parse_file(path: str) -> dict:
    """``parse_post_log`` for a file named ``*post_cglow*``; the last JSON
    line of a ``*glow_check*`` log; else ``parse_log`` with the
    ``<stem>_metrics.jsonl`` and ``<stem>_monitor.csv`` beside it, if
    any."""
    with open(path) as f:
        text = f.read()
    name = os.path.basename(path)
    if "post_cglow" in name:
        return parse_post_log(text)
    if "glow_check" in name:
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1])["glow_check"] if lines else {}
    stem = os.path.splitext(path)[0]
    metrics = None
    if os.path.isfile(stem + "_metrics.jsonl"):
        with open(stem + "_metrics.jsonl") as f:
            metrics = [json.loads(line) for line in f if line.strip()]
    monitor = None
    if os.path.isfile(stem + "_monitor.csv"):
        with open(stem + "_monitor.csv") as f:
            monitor = f.read()
    return parse_log(text, metrics, monitor)


def _epochs(ckpt_dir: str) -> list[int]:
    """Epochs whose checkpoint and meta are both written (no glob: a
    cGlow run dir's name holds brackets)."""
    names = set(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else set()
    return sorted(int(m.group(1)) for n in names
                  if (m := re.fullmatch(r"model_epoch(\d+)\.json", n))
                  and f"model_epoch{m.group(1)}.pt" in names)


class Run:
    """One training run, its stop and resume, then its breakdown or UQ
    suite, each a process of its own."""

    def __init__(self, entry: str, args, data: dict[str, str]):
        kind, _, seed = entry.partition(":")
        if kind not in KINDS or not seed.isdigit():
            raise SystemExit(f"a run is <fvcg|cglow>:<seed>, not {entry!r}")
        prefix, module, recipe = KINDS[kind]
        tag = f"_{args.tag}" if args.tag else ""
        self.kind, self.name = kind, f"{prefix}_seed{seed}{tag}"
        self.out, self.device = args.out, args.device
        self.log_path = os.path.join(args.out, f"{self.name}.log")
        self.argv = [*recipe, "--seed", seed, "--device", args.device,
                     "--no-plot", "--data-dir", data[kind], "--exp-dir",
                     os.path.join(args.work, self.name),
                     *(args.codec_extra if kind == "fvcg"
                       else args.cglow_extra)]
        if kind == "fvcg":
            from ..cli.train_codec_mixed_residual import Parser
        else:
            from ..cli.train_cglow_reverse_kl import Parser
        parsed = Parser().parse(self.argv)
        self.run_dir, self.ckpt_dir = parsed.run_dir, parsed.ckpt_dir
        self.epochs, self.freq = parsed.epochs, parsed.ckpt_freq
        self.marker = os.path.join(args.work, self.name, "DONE")
        self.stop_after = args.stop_after
        self.follow = []    # (phase, log name, module argv) after training
        if kind == "fvcg" and entry in args.breakdown:
            self.follow.append(("breakdown", f"{self.name}_breakdown", [
                "pde_surrogate_torch.tools.r2_breakdown", "--run-dir",
                self.run_dir, "--epoch", str(self.epochs)]))
        if kind == "cglow":
            self.follow.append(("post", self.name.replace("_cglow",
                                                          "_post_cglow"), [
                "pde_surrogate_torch.cli.post_cglow", "--run-dir",
                self.run_dir, *POST, *args.post_extra]))
            self.follow.append(("glow_check", self.name.replace(
                "_cglow", "_glow_check"), [
                "pde_surrogate_torch.tools.glow_check", "--checkpoint",
                os.path.join(self.ckpt_dir,
                             f"model_epoch{self.epochs}.pt")]))
        self.train_cmd = [module, *self.argv]
        self.monitor_path = os.path.join(args.out, f"{self.name}_monitor.csv")
        self.epoch = 0                # the epoch training is in
        self.proc = self.log = None
        self.ok = True
        self.result: dict = {}

    def start(self) -> bool:
        """Start (or resume) training, or what follows a finished training;
        False if nothing is left to do."""
        if os.path.isfile(self.marker):
            return False
        done = _epochs(self.ckpt_dir)
        self.first = (done[-1] if done else 0) + 1
        if self.first > self.epochs:
            return self._next_follow()
        resume = []
        if done:
            resume = (["--ckpt-epoch", str(done[-1])] if self.kind == "fvcg"
                      else ["--resume"])
        self.offset = (os.path.getsize(self.log_path) if done
                       and os.path.isfile(self.log_path) else 0)
        self.log = open(self.log_path, "a" if self.offset else "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *self.train_cmd, *resume],
            stdout=self.log, stderr=subprocess.STDOUT)
        self.phase, self.epoch = "train", self.first
        self.t_train = None           # when the log says training started
        self.seen = set(done)
        self.last_ckpt = (done[-1] if done else 0, None)
        return True

    def _next_follow(self) -> bool:
        if not self.follow:
            shutil.rmtree(self.ckpt_dir, ignore_errors=True)
            with open(self.marker, "w") as f:
                f.write("training and what follows it are done\n")
            return False
        self._copy_metrics()
        self.phase, name, cmd = self.follow.pop(0)
        self.epoch = self.epochs
        self.log = open(os.path.join(self.out, f"{name}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *cmd, "--device", self.device],
            stdout=self.log, stderr=subprocess.STDOUT)
        return True

    def _copy_metrics(self) -> None:
        """The cGlow's ``training/metrics.jsonl`` beside its log: its
        stdout has no samples/s."""
        if self.kind == "cglow":
            shutil.copy(os.path.join(self.run_dir, "training",
                                     "metrics.jsonl"),
                        os.path.join(self.out, f"{self.name}_metrics.jsonl"))

    def _text(self) -> str:
        with open(self.log_path) as f:
            f.seek(self.offset)
            return f.read()

    def poll(self, now: float, deadline: float | None) -> bool:
        """Watch the running process; False once nothing is left to run."""
        rc = self.proc.poll()
        if rc is not None:
            self.log.close()
            self.result[f"{self.phase}_rc"] = rc
            if rc != 0:
                self.ok = False
                return False
            return self._next_follow()
        if self.phase != "train":
            if deadline is not None and now >= deadline:
                self.stop(now)
                return False
            return True
        text = self._text()
        if self.t_train is None and "Start training" in text:
            self.t_train = now
        if ends := re.findall(r"Epoch (\d+): training loss", text):
            self.epoch = int(ends[-1]) + 1
        # the newest checkpoint (the cGlow's once its eval is logged: it
        # checkpoints before its eval)
        new = [e for e in _epochs(self.ckpt_dir) if e not in self.seen and (
            self.kind != "cglow" or f"Epoch {e}: test relative l2" in text)]
        if not new:
            if deadline is not None and now >= deadline:
                self.stop(now)
                return False
            return True
        e = new[-1]
        self.seen.update(new)
        self.last_ckpt = (e, now)
        if self.kind == "cglow":
            for old in self.seen - {e}:
                for ext in ("pt", "json"):
                    path = os.path.join(self.ckpt_dir,
                                        f"model_epoch{old}.{ext}")
                    if os.path.isfile(path):
                        os.remove(path)
        if e >= self.epochs:
            return True
        if self.stop_after is not None and e >= self.stop_after \
                or deadline is not None and now >= deadline:
            self.stop(now)
            return False
        if deadline is not None and self.t_train is not None:
            pace = (now - self.t_train) / (e - self.first + 1)
            upcoming = min(e + self.freq, self.epochs) - e
            if now + 1.05 * pace * upcoming > deadline:
                self.stop(now)
                return False
        return True

    def sample(self, row: str) -> None:
        """Append one sample of the card (``sample_card``) with this run's
        phase and epoch to its monitor CSV."""
        new = not os.path.isfile(self.monitor_path)
        with open(self.monitor_path, "a") as f:
            if new:
                f.write(MONITOR_HEADER + "\n")
            f.write(f"{self.phase}, {self.epoch}, {row}\n")

    def stop(self, now: float) -> None:
        """Stop the running process; a stopped training resumes from its
        last checkpoint in the next call, a stopped follow-up reruns."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.result["stopped"] = self.phase
        if self.phase == "train":
            e, t = self.last_ckpt
            # a checkpoint written after the one seen last goes, so the
            # next call resumes where this part's log says it stopped
            for late in _epochs(self.ckpt_dir):
                for ext in ("pt", "json") if late > e else ():
                    os.remove(os.path.join(self.ckpt_dir,
                                           f"model_epoch{late}.{ext}"))
            took = ((t - self.t_train) / 60 if t is not None
                    and self.t_train is not None else 0.0)
            self.log.write(f"\n[canon_runs] stopped after epoch {e}; epochs "
                           f"{self.first}-{e} took {took:.2f} min\n")
            self.result["stopped_after"] = e
            self._copy_metrics()
        self.log.close()


def sample_card() -> str:
    """One sample of the card (``nvidia-smi``) and of the host's load
    (``/proc/loadavg``) as a CSV row; raises if ``nvidia-smi`` fails."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({out.returncode}): "
                           f"{out.stdout.strip()} {out.stderr.strip()}")
    with open("/proc/loadavg") as f:
        load = f.read().split()
    return ", ".join([out.stdout.strip().splitlines()[0], *load])


def _prepare_data(runs: list[Run]) -> None:
    """Every split the runs read, generated (labels by K1) before they
    start."""
    from ..cli._codec_common import resolve_dataset_files
    from ..cli.train_cglow_reverse_kl import Parser as GlowParser
    from ..cli.train_codec_mixed_residual import Parser as CodecParser
    for kind, parser in (("fvcg", CodecParser), ("cglow", GlowParser)):
        run = next((r for r in runs if r.kind == kind), None)
        if run is not None:
            tmp = tempfile.mkdtemp(prefix="canon_parse_")
            resolve_dataset_files(parser().parse(
                [*run.argv, "--exp-dir", tmp]))
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", default=[],
                   help="<fvcg|cglow>:<seed> entries, run side by side")
    p.add_argument("--breakdown", nargs="*", default=[],
                   help="fvcg entries of --runs whose last checkpoint "
                        "tools/r2_breakdown.py splits")
    p.add_argument("--out", default="logs")
    p.add_argument("--work", default=None,
                   help="the runs' exp dirs (default: a temporary dir)")
    p.add_argument("--resume-from", default=None,
                   help="an earlier call's --work, copied into --work")
    p.add_argument("--deadline-min", type=float, default=None)
    p.add_argument("--stop-after", type=int, default=None,
                   help="stop each run right after its first checkpoint "
                        "at or after this epoch")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tag", default="",
                   help="end every log name in _<tag>")
    p.add_argument("--parse", nargs="*", default=[],
                   help="only parse these logs and print the JSON line")
    for kind in ("codec", "cglow", "post"):
        p.add_argument(f"--{kind}-extra", type=shlex.split, default=[],
                       help=f"further {kind} CLI flags in one string (a "
                            f"short try)")
    args = p.parse_args(argv)
    if args.parse:
        print(json.dumps({"canon_runs": {os.path.basename(path):
                                         parse_file(path)
                                         for path in args.parse}}))
        return 0
    clock0 = time.monotonic()
    deadline = (None if args.deadline_min is None
                else clock0 + 60 * args.deadline_min)
    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="canon_")
    args.work = args.work or os.path.join(tmp, "work")
    if args.resume_from:
        shutil.copytree(args.resume_from, args.work, dirs_exist_ok=True)
    data = {"fvcg": os.path.join(tmp, "data_codec"),
            "cglow": os.path.join(tmp, "data_cglow")}
    runs = [Run(e, args, data) for e in args.runs]
    _prepare_data(runs)
    print(f"[canon_runs] data ready in {time.monotonic() - clock0:.1f} s",
          flush=True)
    monitor, monitor_error = args.device.startswith("cuda"), None
    if monitor:
        sample_card()                 # fails before any run starts
    running = [r for r in runs if r.start()]
    next_sample = time.monotonic()
    while running:
        time.sleep(POLL_S)
        now = time.monotonic()
        if monitor and now >= next_sample:
            try:
                row = sample_card()
            except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
                # the runs go on; the call ends in an error
                monitor_error, monitor = str(e), False
                print(f"[canon_runs] monitor: {e}", file=sys.stderr,
                      flush=True)
            else:
                for r in running:
                    r.sample(row)
            next_sample = now + MONITOR_S
        running = [r for r in running if r.poll(now, deadline)]
    for r in runs:
        r.result.update(parse_file(r.log_path))
        for key, name in (("post", "_post_cglow"),
                          ("glow_check", "_glow_check")):
            path = r.log_path.replace("_cglow", name)
            if r.kind == "cglow" and os.path.isfile(path):
                r.result[key] = parse_file(path)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"canon_runs": {r.name: r.result for r in runs}}))
    if monitor_error:
        print(f"[canon_runs] the monitor failed: {monitor_error}")
    return 0 if all(r.ok for r in runs) and not monitor_error else 1


if __name__ == "__main__":
    sys.exit(main())

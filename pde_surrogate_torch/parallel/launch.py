"""Start the ranks of a data-parallel run (``--n-devices N``).

The JAX package runs one process over N devices; the port runs one process
per device.  ``run`` starts ``fn(mesh, ...)`` on N ranks however the
program was started:

* under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set), this
  process is one rank and the group meets through ``env://``;
* with N = 1, a one-rank group is built in this process;
* otherwise N ranks are spawned (``torch.multiprocessing``, the spawn
  start method) and meet through a ``file://`` store in a fresh directory
  (the run dir, for the CLIs), so that concurrent runs never race for a
  TCP port.  Each rank inherits the launcher's intra-op thread count.

The backend is NCCL on ``cuda`` (rank r on ``cuda:LOCAL_RANK``) and gloo on
``cpu``.  On ``cuda`` N may not exceed the visible GPUs: ranks never share
a GPU, and nothing falls back to gloo or the CPU.  Ranks other than 0
print nothing.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.config import seed_everything, select_device
from .mesh import data_mesh

__all__ = ["check_devices", "run", "spawn", "run_driver"]


def check_devices(n_devices: int | None, device) -> None:
    """Raise unless ``n_devices`` ranks can run on ``device``: one GPU
    each on ``cuda``."""
    if n_devices is None:
        return
    if n_devices < 1:
        raise ValueError(f"--n-devices {n_devices}: at least one device")
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if n_devices > count:
            raise RuntimeError(
                f"--n-devices {n_devices} needs {n_devices} GPUs, "
                f"{count} visible: ranks never share a GPU")


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _run_rank(fn, rank: int, world: int, device_name, init_method: str,
              fn_args: tuple):
    """Join the group as ``rank``, run ``fn(mesh, *fn_args)``, leave."""
    device = select_device(device_name,
                           int(os.environ.get("LOCAL_RANK", rank)))
    on_card = device.type == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world,
                            device_id=device if on_card else None)
    with contextlib.ExitStack() as stack:
        if rank:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        try:
            return fn(data_mesh(world, device), *fn_args)
        finally:
            dist.destroy_process_group()


def _spawned(rank: int, fn, world: int, device_name, workdir: str,
             threads: int, fn_args: tuple) -> None:
    torch.set_num_threads(threads)
    result = _run_rank(fn, rank, world, device_name,
                       "file://" + os.path.join(workdir, "store"), fn_args)
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def spawn(fn, n: int, *fn_args, device="cpu", workdir: str | None = None
          ) -> list:
    """Run ``fn(mesh, *fn_args)`` on ``n`` spawned ranks (``fn`` importable
    by name, its arguments picklable) and return their results in rank
    order; each must be a tensor, number or container of them.  The store
    and the results live in a fresh directory under ``workdir``, removed
    afterwards."""
    check_devices(n, device)
    tmp = tempfile.mkdtemp(prefix=".dist_", dir=workdir)
    try:
        mp.spawn(_spawned, args=(fn, n, device, tmp, torch.get_num_threads(),
                                 fn_args), nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(fn, n: int, *fn_args, device="cuda", workdir: str | None = None):
    """``fn(mesh, *fn_args)`` on ``n`` ranks: this process's result under
    torchrun or for n = 1, else rank 0's (``spawn``)."""
    check_devices(n, device)
    if _under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"--n-devices {n} under torchrun with "
                             f"{world} ranks")
        return _run_rank(fn, int(os.environ["RANK"]), world, device,
                         "env://", fn_args)
    if n == 1:
        tmp = tempfile.mkdtemp(prefix=".dist_", dir=workdir)
        try:
            return _run_rank(fn, 0, 1, device,
                             "file://" + os.path.join(tmp, "store"), fn_args)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return spawn(fn, n, *fn_args, device=device, workdir=workdir)[0]


def _driver_rank(mesh, body, args, out_dir: str | None):
    """One rank of a CLI run, its RNGs seeded as the CLI's parser seeds one
    process.  Spawned ranks cannot return the trained state, so with
    ``out_dir`` it is saved there as a checkpoint (rank 0 writes) and
    nothing is returned."""
    seed_everything(args.seed)
    state, logger = body(args, mesh=mesh)
    if out_dir is None:
        return state, logger
    from ..train.checkpoint import save_checkpoint
    save_checkpoint(out_dir, 0, state, meta={"logger": logger})
    return None


def run_driver(body, args, read_back):
    """A CLI's training on ``args.n_devices`` ranks: ``body(args, mesh=)``
    returns ``(state, logger)``.  Returns this process's rank's pair, or,
    when the ranks were spawned, rank 0's, read back by
    ``read_back(args, ckpt_dir)`` from the checkpoint it saved (epoch 0 of
    a scratch directory in the run dir, removed afterwards)."""
    n = args.n_devices
    if n == 1 or _under_torchrun():
        return run(_driver_rank, n, body, args, None, device=args.device,
                   workdir=args.run_dir)
    out = tempfile.mkdtemp(prefix=".dist_state_", dir=args.run_dir)
    try:
        spawn(_driver_rank, n, body, args, out, device=args.device,
              workdir=args.run_dir)
        return read_back(args, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)

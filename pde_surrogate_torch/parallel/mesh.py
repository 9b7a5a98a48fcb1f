"""Data-parallel meshes over torch.distributed ranks.

Counterpart of pde_surrogate_tpu/parallel/mesh.py.  There, a ``('data',)``
mesh of devices replicates the state and shards batches on the leading
axis, and XLA inserts the gradient ``psum`` and the global BatchNorm
reductions inside the jitted step.  Here one process drives one device:
a ``Mesh`` names the process group, this rank and its device; batches are
sliced per rank (``shard_batch``, ``DeviceDataset(mesh=...)``); the
trainers average the gradients explicitly (``all_reduce_grads``); and the
port's ``BatchNorm2d`` reduces its batch moments over the mesh once
``replicate`` has handed it the group.

The 2-D data x space mesh of the JAX package (a spatially sharded training
step) is not ported: ``dp_sp_mesh`` and ``batch_space_sharding`` raise.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "data_mesh", "shard_batch", "replicate",
           "all_reduce_grads", "all_reduce_sum", "all_mean", "all_gather",
           "rank0_first", "barrier", "is_main", "dp_sp_mesh",
           "batch_space_sharding"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``world_size`` ranks of ``group``; this process is rank
    ``rank`` and drives ``device``."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def _mesh(n_devices: int | None, device, axis: str) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(parallel.launch starts one per rank)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a process group "
                         f"of {world} ranks")
    device = torch.device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, (world,), mesh_dim_names=(axis,))
    return Mesh(dm.get_group(axis), dist.get_rank(), world, device)


def data_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The ``('data',)`` mesh over every rank of the process group; this
    rank drives ``device``."""
    return _mesh(n_devices, device, "data")


def dp_sp_mesh(n_data: int, n_space: int, *args, **kwargs):
    """The JAX package's 2-D (data x space) training mesh: not ported."""
    raise NotImplementedError("not ported yet: the data x space mesh "
                              "(a spatially sharded training step, "
                              "ROADMAP E3c)")


def batch_space_sharding(*args, **kwargs):
    """Batch on data and height on space: not ported (ROADMAP E3c)."""
    raise NotImplementedError("not ported yet: batch x space sharding "
                              "(ROADMAP E3c)")


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous ``B / world`` rows of a global batch (a tensor
    or a tuple of tensors)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    n = batch.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"batch of {n} not divisible by the mesh's "
                         f"{mesh.world_size} ranks")
    rows = n // mesh.world_size
    return batch[mesh.rank * rows:(mesh.rank + 1) * rows]


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make ``module`` a replica over ``mesh``, in place: its parameters
    and buffers take rank 0's values, and every submodule with a
    ``stats_group`` (the port's BatchNorm2d and concat-free DenseBlock)
    reduces its batch moments over the mesh from now on."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    for m in module.modules():
        if hasattr(m, "stats_group"):
            m.stats_group = mesh.group
    return module


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Average the gradients of ``params`` over the mesh in place: one
    flattened buffer per dtype, one all-reduce each.  Parameters without a
    gradient are skipped (every rank runs the same graph, so they agree)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.world_size
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)])


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM whose backward is an all-reduce SUM of the incoming
    gradient: rank r's input feeds every rank's output, so its gradient is
    the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def all_mean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of ``x`` over the mesh's ranks (``x`` itself without a
    mesh); no gradient."""
    if mesh is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y / mesh.world_size


def all_gather(x: torch.Tensor, mesh: Mesh | None, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (``x``
    without a mesh); the ranks' shapes must agree."""
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def rank0_first(mesh: Mesh | None):
    """Rank 0 runs the block first (it writes a shared file); the others
    run it after rank 0 has left it (and find the file)."""
    if mesh is not None and mesh.rank != 0:
        barrier(mesh)
    yield
    if mesh is not None and mesh.rank == 0:
        barrier(mesh)


def is_main(mesh: Mesh | None) -> bool:
    """True on the rank that prints and writes (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0

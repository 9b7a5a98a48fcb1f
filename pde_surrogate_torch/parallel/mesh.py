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

The 2-D ``('data', 'space')`` mesh (``dp_sp_mesh``) also splits each field's
rows H over the space axis (``batch_space_sharding``).  Where XLA's SPMD
partitioner inserts the conv halos, ``replicate`` hands every conv and
upsampling of the DenseED and the cGlow this rank's ``RowShard``, and the
convs exchange their halo rows point to point (``parallel/halo.py``); the
BatchNorm moments run over the whole data x space group; every loss, PCG
dot and metric is this rank's partial sum, summed over the space group
where it is used (``ops/darcy.py``, ``utils/metrics.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .halo import RowShard

__all__ = ["Mesh", "data_mesh", "shard_batch", "replicate",
           "all_reduce_grads", "all_reduce_sum", "all_mean", "all_gather",
           "rank0_first", "barrier", "is_main", "DataSpaceMesh",
           "dp_sp_mesh", "batch_space_sharding", "row_shard"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``world_size`` ranks of ``group``; this process is rank
    ``rank`` and drives ``device``."""

    group: object
    rank: int
    world_size: int
    device: torch.device

    @property
    def n_data(self) -> int:
        """The ranks that hold different samples: all of a 1-D mesh."""
        return self.world_size


@dataclass(frozen=True)
class DataSpaceMesh(Mesh):
    """A 2-D ``(data, space)`` mesh: ``group`` is the whole group (rank
    ``rank`` of ``world_size``), ``data_group`` the ranks that hold this
    rank's rows of other samples, ``space_group`` the ranks that hold the
    other rows of this rank's samples; this rank sits at ``coords``
    ``(data index, space index)`` of ``shape`` ``(n_data, n_space)``."""

    data_group: object
    space_group: object
    coords: tuple[int, int]
    shape: tuple[int, int]

    @property
    def n_data(self) -> int:
        return self.shape[0]


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


def dp_sp_mesh(n_data: int, n_space: int, device="cuda") -> DataSpaceMesh:
    """The ``('data', 'space')`` mesh of ``n_data x n_space`` ranks, the
    whole process group; this rank drives ``device``.  Rank r sits at
    ``(r // n_space, r % n_space)``."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(parallel.launch starts one per rank)")
    world = dist.get_world_size()
    if n_data * n_space != world:
        raise ValueError(f"a {n_data}x{n_space} mesh in a process group of "
                         f"{world} ranks")
    device = torch.device(device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, (n_data, n_space),
                          mesh_dim_names=("data", "space"))
    d, s = dm.get_coordinate()
    return DataSpaceMesh(dist.group.WORLD, dist.get_rank(), world, device,
                         dm.get_group("data"), dm.get_group("space"),
                         (d, s), (n_data, n_space))


def row_shard(mesh: Mesh | None) -> RowShard | None:
    """This rank's block of the rows under a 2-D mesh (None otherwise)."""
    if not isinstance(mesh, DataSpaceMesh):
        return None
    return RowShard(mesh.space_group, mesh.coords[1], mesh.shape[1])


def batch_space_sharding(mesh: DataSpaceMesh, multiple: int = 4):
    """``shard(batch)``: this rank's block ``(B / n_data, C, H / n_space,
    W)`` of a global NCHW batch (a tensor or a tuple of them), contiguous
    along both axes: space rank s holds rows ``[s H/P, (s+1) H/P)``.  Each
    rank's rows must be a multiple of ``multiple``: 4 for the DenseED,
    which halves them twice (``In_conv`` and the down transition), and
    ``2^(len(flow_blocks) - 1)`` for the cGlow, whose squeezes and
    encoder halve them once per scale (1: any rows, as for the cGlow's
    latents)."""
    (n_data, n_space), (d, s) = mesh.shape, mesh.coords

    def shard(batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(shard(b) for b in batch)
        n, h = batch.shape[0], batch.shape[-2]
        if n % n_data:
            raise ValueError(f"batch of {n} not divisible by the mesh's "
                             f"{n_data} data ranks")
        if h % (multiple * n_space):
            raise ValueError(f"H={h} over {n_space} space ranks: each "
                             f"rank's rows must be a multiple of "
                             f"{multiple}")
        b, r = n // n_data, h // n_space
        return batch[d * b:(d + 1) * b, ..., s * r:(s + 1) * r, :]

    return shard


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


def _has_row_form(conv: torch.nn.Conv2d) -> bool:
    """A conv of the port's codec (``rows``) of one group, without
    dilation, with zero padding and a square stride and padding: the
    DenseED's and the cGlow's, biased or not."""
    return (hasattr(conv, "rows") and conv.groups == 1
            and conv.dilation == (1, 1) and conv.padding_mode == "zeros"
            and len(set(conv.stride)) == 1 and len(set(conv.padding)) == 1)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make ``module`` a replica over ``mesh``, in place: its parameters
    and buffers take rank 0's values, and every submodule with a
    ``stats_group`` (the port's BatchNorm2d, the concat-free DenseBlock
    and the cGlow's ActNorm, whose data-dependent init reads the group's
    moments) reduces its batch moments over the mesh from now on (over
    data x space on a 2-D mesh).

    On a 2-D mesh every submodule with a ``rows`` attribute (the port's
    codec ``Conv2d``, which also serves the upsampling before it, and the
    cGlow's ``Squeeze``) takes this rank's ``RowShard``.  A conv without
    a row-block form raises: a plain ``nn.Conv2d``, or one with groups,
    dilation, another padding mode or a stride or padding that differs
    between H and W."""
    rows = row_shard(mesh)
    if rows is not None:
        for name, m in module.named_modules():
            if isinstance(m, torch.nn.Conv2d) and not _has_row_form(m):
                raise NotImplementedError(
                    f"{name or type(m).__name__} ({m!r}) has no row-block "
                    f"form under a space mesh: only a models.codec.Conv2d "
                    f"of one group, without dilation, with zero padding "
                    f"and a square stride and padding")
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    for m in module.modules():
        if hasattr(m, "stats_group"):
            m.stats_group = mesh.group
        if rows is not None and hasattr(m, "rows"):
            m.rows = rows
    return module


def all_reduce_grads(params, mesh: Mesh) -> None:
    """The gradient of the global loss, in place: one flattened buffer per
    dtype, summed over every rank in one all-reduce, then divided by the
    mesh's ``n_data``.  Each rank's loss is its data shard's loss (1-D)
    or this rank's partial sum of it (2-D, ``ops/darcy.py``), and its
    backward gives the gradient of the sum of every rank's loss (the
    halos' and BatchNorm's backward carry the cross-rank terms), so the
    sum over ranks over ``n_data`` is the gradient of the mean over data
    shards.  Parameters without a gradient are skipped (every rank runs
    the same graph, so they agree)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.n_data
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

"""Device-resident input pipeline.

Counterpart of pde_surrogate_tpu/data/pipeline.py.  The datasets are small
(<= 10k images of 64 x 64), so the whole dataset lives on the device and an
epoch is a gather driven by a permutation.  The permutation is a pure
function of (seed, epoch): resuming at epoch e reproduces the exact stream
without checkpointing dataloader state.  Its bits differ from the JAX
package's (another generator); the semantics do not.

Under a data mesh every rank holds the whole dataset, draws the same
permutation and yields its contiguous ``batch_size / world`` rows of every
global batch, the test set's too, as the JAX package's batch sharding
places them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..utils.observability import count, span

__all__ = ["DeviceDataset"]


class DeviceDataset:
    """Epoch-shuffled, drop-last batches of device-resident tensors.

    Args:
      arrays: one or more equal-length numpy arrays or tensors.
      batch_size: drop-last batching (reference DataLoader semantics).
      seed: base seed; epoch e draws from ``torch.Generator`` seeded by
        (seed, e).
      device: where the arrays live.
      mesh: a ``parallel.mesh.Mesh``: yield this rank's shard of every
        batch (``batch_size`` is the global batch).
    """

    def __init__(self, *arrays, batch_size: int, device: torch.device | str,
                 seed: int = 0, shuffle: bool = True, mesh=None):
        lengths = {len(a) for a in arrays}
        if len(lengths) != 1:
            raise ValueError(f"array length mismatch: {lengths}")
        self.n = lengths.pop()
        self.batch_size = int(batch_size)
        self.steps_per_epoch = self.n // self.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError("batch_size larger than dataset")
        self.shard = slice(None)
        if mesh is not None:
            if self.batch_size % mesh.world_size:
                raise ValueError(f"batch_size {self.batch_size} not divisible "
                                 f"by the mesh's {mesh.world_size} ranks")
            rows = self.batch_size // mesh.world_size
            self.shard = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        self.seed = int(seed)
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.arrays = tuple(torch.as_tensor(a).to(self.device)
                            for a in arrays)

    def epoch_indices(self, epoch: int) -> torch.Tensor:
        """(steps, batch_size) gather indices for this epoch (pure in epoch),
        drawn on the host and copied to the device (on a card the copy
        waits for the device: ``sync.epoch_indices``)."""
        with span("data.epoch"):
            if self.shuffle:
                seed = np.random.SeedSequence([self.seed, int(epoch)])
                g = torch.Generator().manual_seed(
                    int(seed.generate_state(1)[0]))
                perm = torch.randperm(self.n, generator=g)
            else:
                perm = torch.arange(self.n)
            usable = self.steps_per_epoch * self.batch_size
            if self.device.type != "cpu":
                count("sync.epoch_indices")
            return perm[:usable].view(self.steps_per_epoch,
                                      self.batch_size).to(self.device)

    def batches(self, epoch: int) -> Iterator[tuple]:
        """Iterate (arrays...) batches (this rank's shard) for one epoch."""
        idx = self.epoch_indices(epoch)[:, self.shard]
        for s in range(self.steps_per_epoch):
            with span("data.gather"):
                batch = tuple(a.index_select(0, idx[s]) for a in self.arrays)
            yield batch

    def __len__(self) -> int:
        return self.steps_per_epoch

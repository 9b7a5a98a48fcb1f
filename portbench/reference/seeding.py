"""How the program turns integers into random streams, frozen here so that
the reference draws what the timed path drew without asking the program:
the generator of (seed, counters...) (``utils/config.make_generator``)
and the epoch's batch order (``data/pipeline.DeviceDataset``)."""

from __future__ import annotations

import numpy as np
import torch


def seed_of(*entropy: int) -> int:
    """A 32-bit seed that is a pure function of the integers ``entropy``."""
    return int(np.random.SeedSequence([int(e) for e in entropy])
               .generate_state(1)[0])


def make_generator(device, *entropy: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by ``seed_of(entropy)``."""
    return torch.Generator(device=device).manual_seed(seed_of(*entropy))


def epoch_rows(seed: int, epoch: int, n: int, batch: int) -> torch.Tensor:
    """(steps, batch) CPU indices of an epoch's drop-last shuffled batches
    of ``n`` rows: a permutation drawn on the CPU from (seed, epoch)."""
    g = torch.Generator().manual_seed(seed_of(seed, epoch))
    perm = torch.randperm(n, generator=g)
    steps = n // batch
    return perm[:steps * batch].view(steps, batch)

"""Port parity: input generation, HDF5 files and the device dataset.

The LHS designs and permeability samplers are numpy copies, so the same
seed must give byte-identical arrays (designs are not prefix-stable: a
dataset name pins its exact bytes).  HDF5 files cross between the packages
in both directions.
"""

import numpy as np
import pytest
import torch

from pde_surrogate_torch.data import grf as tgrf
from pde_surrogate_torch.data import hdf5 as th5
from pde_surrogate_torch.data.pipeline import DeviceDataset
from pde_surrogate_torch.ops.lhs import lhs as t_lhs
from pde_surrogate_tpu.data import grf as jgrf
from pde_surrogate_tpu.data import hdf5 as jh5
from pde_surrogate_tpu.ops.lhs import lhs as j_lhs

torch.set_num_threads(1)


@pytest.mark.parametrize("criterion", [None, "center", "maximin",
                                       "centermaximin", "correlation"])
def test_lhs_byte_identical(criterion):
    a = t_lhs(6, 12, criterion=criterion, rng=5)
    b = j_lhs(6, 12, criterion=criterion, rng=5)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("sampler,args", [
    ("sample_kle", (5, 16, 64)),
    ("sample_channelized", (5, 16)),
    ("sample_warped_grf", (3, 16)),
])
def test_samplers_byte_identical(sampler, args):
    a = getattr(tgrf, sampler)(*args, rng=11)
    b = getattr(jgrf, sampler)(*args, rng=11)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


def test_hdf5_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.random((4, 1, 8, 8)).astype(np.float32)
    y = rng.random((4, 3, 8, 8)).astype(np.float32)

    ours = th5.dataset_path(str(tmp_path / "a"), 8, "kle512_lhs4_val")
    assert ours == jh5.dataset_path(str(tmp_path / "a"), 8, "kle512_lhs4_val")
    th5.save_dataset(ours, x, y)
    xj, yj, sj = jh5.load_data(ours, 3, only_input=False, return_stats=True)
    np.testing.assert_array_equal(xj, np.moveaxis(x[:3], 1, -1))
    np.testing.assert_array_equal(yj, np.moveaxis(y[:3], 1, -1))

    theirs = str(tmp_path / "b" / "f.hdf5")
    jh5.save_dataset(theirs, np.moveaxis(x, 1, -1), np.moveaxis(y, 1, -1))
    xt, yt, st = th5.load_data(theirs, 3, only_input=False, return_stats=True)
    np.testing.assert_array_equal(xt, x[:3])
    np.testing.assert_array_equal(yt, y[:3])
    np.testing.assert_array_equal(st["y_variation"], sj["y_variation"])
    xo, yo, _ = th5.load_data(theirs, 4)
    assert yo is None and xo.shape == (4, 1, 8, 8)


def test_device_dataset_epochs():
    """Drop-last batches, each sample at most once per epoch, and a
    permutation that depends only on (seed, epoch)."""
    x = torch.arange(10, dtype=torch.float32)[:, None] * 10
    y = torch.arange(10)
    ds = DeviceDataset(x, y, batch_size=3, seed=4, device="cpu")
    assert len(ds) == 3
    idx = ds.epoch_indices(1)
    assert idx.shape == (3, 3)
    assert len(set(idx.flatten().tolist())) == 9
    again = DeviceDataset(x, y, batch_size=3, seed=4, device="cpu")
    assert torch.equal(again.epoch_indices(1), idx)
    assert torch.equal(ds.epoch_indices(1), idx)
    assert not torch.equal(ds.epoch_indices(2), idx)
    assert not torch.equal(DeviceDataset(x, y, batch_size=3, seed=5,
                                         device="cpu").epoch_indices(1), idx)
    seen = []
    for xb, yb in ds.batches(1):
        assert torch.equal(xb[:, 0], yb.float() * 10)
        seen += yb.tolist()
    assert seen == idx.flatten().tolist()
    fixed = DeviceDataset(x, batch_size=4, shuffle=False, device="cpu")
    assert fixed.epoch_indices(3).flatten().tolist() == list(range(8))
    with pytest.raises(ValueError):
        DeviceDataset(x, y[:5], batch_size=2, device="cpu")


@pytest.mark.parametrize("kw", [
    {}, {"compression": "gzip"},
    {"compression": "gzip", "shuffle": True, "chunks": (2, 1, 3, 5)},
    {"chunks": (1, 1, 8, 8)}])
def test_h5format_reads_h5py_layouts(tmp_path, kw):
    """The numpy HDF5 reader against what h5py writes: contiguous, chunked
    (v1 chunk B-tree, ragged edge chunks), deflate and shuffle; and h5py
    reads and extends what the writer wrote."""
    import h5py

    from pde_surrogate_torch.data.h5format import (Writer, dataset_shapes,
                                                   read_rows)
    x = np.random.default_rng(1).random((300, 1, 8, 8)).astype(np.float32)
    path = str(tmp_path / "h.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("input", data=x, **kw)
    assert dataset_shapes(path) == {"input": x.shape}
    np.testing.assert_array_equal(read_rows(path, "input", 7, 250), x[7:250])

    ours = str(tmp_path / "w.hdf5")
    with Writer(ours, {"input": x.shape}) as w:
        w.write("input", 100, x[100:])
        w.write("input", 0, x[:100])
    with h5py.File(ours, "a") as f:
        np.testing.assert_array_equal(f["input"][()], x)
        f.create_dataset("output", data=x[:, 0])
    np.testing.assert_array_equal(read_rows(ours, "output"), x[:, 0])

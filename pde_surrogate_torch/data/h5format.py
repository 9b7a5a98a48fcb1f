"""The subset of the HDF5 file format the datasets use, in numpy alone.

The port runs where no HDF5 library is installed, yet its files must stay
readable by h5py (and so by the JAX package and the reference) and it must
read theirs.  A dataset file is a root group holding float32 arrays.

* Writing: HDF5 1.8-compatible "earliest" layout — superblock version 0, a
  symbol-table root group (v1 B-tree, one symbol node, local heap), and one
  version-1 object header per dataset with a contiguous, uncompressed data
  block.  ``Writer`` lays the file out up front, so rows can be written in
  any order, slice by slice; the file appears under its name (atomic
  rename) only when the writer closes cleanly.
* Reading: the same layout, plus chunked datasets (v1 chunk B-trees) with
  the deflate and shuffle filters, which is what h5py writes for
  ``compression="gzip"``.  Newer layouts (superblock 2+, link-message
  groups) raise ``ValueError``.

Format reference: "HDF5 File Format Specification Version 2.0" (The HDF
Group), sections II (superblock), III.A-C (B-trees, symbol table nodes,
local heaps) and IV (object headers and messages).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["Writer", "read_rows", "dataset_shapes"]

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _NODE_K = 4, 16          # group leaf / internal node K (defaults)
_F4 = np.dtype("<f4")


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _object_header(messages: list[bytes]) -> bytes:
    data = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(data)) + data


def _dataset_header(shape: tuple, data_addr: int) -> bytes:
    dataspace = struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(
        struct.pack("<Q", d) for d in shape)
    # IEEE float32 little-endian: class 1, version 1, implied-msb mantissa,
    # sign bit 31; offset 0, precision 32, exponent at 23 (8 bits),
    # mantissa at 0 (23 bits), bias 127
    datatype = (struct.pack("<B3BI", 0x11, 0x20, 31, 0, 4)
                + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))
    fill = struct.pack("<BBBB", 2, 1, 2, 0)    # v2, early alloc, never, none
    nbytes = int(np.prod(shape)) * 4
    layout = struct.pack("<BBQQ", 3, 1, data_addr, nbytes)   # contiguous
    return _object_header([_message(0x0001, dataspace),
                           _message(0x0003, datatype),
                           _message(0x0005, fill),
                           _message(0x0008, layout)])


class Writer:
    """A new file of float32 datasets ``{name: shape}``, written by rows.

    Use as a context manager; ``write(name, start, rows)`` fills rows
    ``start:start+len(rows)`` of a dataset.  Rows never written read as 0.
    """

    def __init__(self, path: str, shapes: dict[str, tuple]):
        self.path = path
        self._tmp = f"{path}.{os.getpid()}.tmp"
        names = sorted(shapes)
        self._shapes = {n: tuple(int(d) for d in shapes[n]) for n in names}
        # local heap data: "" at offset 0, then the names, 8-byte aligned
        heap_data, name_off = b"\0" * 8, {}
        for n in names:
            name_off[n] = len(heap_data)
            heap_data += _pad8(n.encode() + b"\0")
        root_hdr_size = len(_object_header([_message(0x0011, bytes(16))]))
        btree_size = 24 + (2 * _NODE_K + 1) * 8 + 2 * _NODE_K * 8
        snod_size = 8 + 2 * _LEAF_K * 40
        if len(names) > 2 * _LEAF_K:
            raise ValueError(f"at most {2 * _LEAF_K} datasets per file")
        addr = 96
        root_addr, addr = addr, addr + root_hdr_size
        btree_addr, addr = addr, addr + btree_size
        heap_addr, addr = addr, addr + 32
        heap_data_addr, addr = addr, addr + len(heap_data)
        snod_addr, addr = addr, addr + snod_size
        hdr_addr = {}
        for n in names:
            hdr_addr[n] = addr
            addr += len(_dataset_header(self._shapes[n], 0))
        self._data_addr = {}
        for n in names:
            self._data_addr[n] = addr
            addr += int(np.prod(self._shapes[n])) * 4
        eof = addr

        sb = (_SIG + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
              + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
              + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
              + struct.pack("<QQI4xQQ", 0, root_addr, 1, btree_addr,
                            heap_addr))
        root = _object_header([_message(
            0x0011, struct.pack("<QQ", btree_addr, heap_addr))])
        btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, _UNDEF, _UNDEF)
                 + struct.pack("<QQQ", 0, snod_addr, name_off[names[-1]]))
        btree += bytes(btree_size - len(btree))
        # free-list head 1 is the library's "no free block" (H5HL_FREE_NULL)
        heap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                     heap_data_addr)
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
            struct.pack("<QQI4x16x", name_off[n], hdr_addr[n], 0)
            for n in names)
        snod += bytes(snod_size - len(snod))
        meta = sb + root + btree + heap + heap_data + snod + b"".join(
            _dataset_header(self._shapes[n], self._data_addr[n])
            for n in names)
        self._f = open(self._tmp, "wb")
        self._f.write(meta)
        self._f.truncate(eof)

    def write(self, name: str, start: int, rows) -> None:
        shape = self._shapes[name]
        rows = np.ascontiguousarray(rows, dtype=_F4)
        if rows.shape[1:] != shape[1:] or not 0 <= start <= shape[0] - len(
                rows):
            raise ValueError(f"rows {rows.shape} at {start} do not fit "
                             f"{name} {shape}")
        row_bytes = int(np.prod(shape[1:])) * 4
        self._f.seek(self._data_addr[name] + start * row_bytes)
        self._f.write(rows.tobytes())

    def close(self) -> None:
        self._f.close()
        os.replace(self._tmp, self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._f.close()
            os.remove(self._tmp)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _File:
    def __init__(self, f):
        self.f = f

    def at(self, addr: int, n: int) -> bytes:
        self.f.seek(addr)
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("truncated HDF5 file")
        return b

    def messages(self, addr: int):
        """(type, body) of every message of the v1 object header at addr."""
        version, _, count, _, size = struct.unpack("<BBHII",
                                                   self.at(addr, 12))
        if version != 1:
            raise ValueError(f"object header version {version} unsupported")
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            data, pos = self.at(start, size), 0
            while pos + 8 <= size and len(out) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x02:
                    raise ValueError("shared header messages unsupported")
                if mtype == 0x0010:           # continuation
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, body))
        return out

    def group_entries(self, btree: int, heap: int) -> dict[str, int]:
        _, _, size, _, data_addr = struct.unpack("<4sB3xQQQ",
                                                 self.at(heap, 32))
        names = self.at(data_addr, size)
        out: dict[str, int] = {}
        sig, ntype, level, used = struct.unpack("<4sBBH", self.at(btree, 8))
        if sig != b"TREE" or ntype != 0:
            raise ValueError("bad group B-tree node")
        raw = self.at(btree + 24, used * 16 + 8)
        for i in range(used):
            child = struct.unpack_from("<Q", raw, 8 + 16 * i)[0]
            if level > 0:
                out.update(self.group_entries(child, heap))
                continue
            sig, _, _, nsym = struct.unpack("<4sBBH", self.at(child, 8))
            if sig != b"SNOD":
                raise ValueError("bad symbol table node")
            ents = self.at(child + 8, nsym * 40)
            for j in range(nsym):
                off, hdr = struct.unpack_from("<QQ", ents, 40 * j)
                end = names.index(b"\0", off)
                out[names[off:end].decode()] = hdr
        return out

    def chunks(self, btree: int, rank: int):
        """(offsets, size, filter_mask, address) of every chunk."""
        sig, ntype, level, used = struct.unpack("<4sBBH", self.at(btree, 8))
        if sig != b"TREE" or ntype != 1:
            raise ValueError("bad chunk B-tree node")
        key = 8 + 8 * (rank + 1)
        raw = self.at(btree + 24, used * (key + 8) + key)
        for i in range(used):
            pos = i * (key + 8)
            size, mask = struct.unpack_from("<II", raw, pos)
            offs = struct.unpack_from(f"<{rank}Q", raw, pos + 8)
            child = struct.unpack_from("<Q", raw, pos + key)[0]
            if level > 0:
                yield from self.chunks(child, rank)
            else:
                yield offs, size, mask, child


def _root(fh: _File) -> dict[str, int]:
    sb = fh.at(0, 96)
    if sb[:8] != _SIG:
        raise ValueError("not an HDF5 file")
    if sb[8] != 0 or sb[13] != 8 or sb[14] != 8:
        raise ValueError("only superblock version 0 with 8-byte offsets "
                         "is supported")
    root_hdr = struct.unpack_from("<Q", sb, 64)[0]
    for mtype, body in fh.messages(root_hdr):
        if mtype == 0x0011:
            return fh.group_entries(*struct.unpack_from("<QQ", body))
    raise ValueError("root group has no symbol table")


def _dataset_info(fh: _File, hdr: int) -> dict:
    info: dict = {"filters": []}
    for mtype, body in fh.messages(hdr):
        if mtype == 0x0001:
            version, rank = body[0], body[1]
            off = 8 if version == 1 else 4
            info["shape"] = struct.unpack_from(f"<{rank}Q", body, off)
        elif mtype == 0x0003:
            cls, size = body[0] & 0x0F, struct.unpack_from("<I", body, 4)[0]
            if cls != 1 or body[1] & 0x01:
                raise ValueError("only little-endian float data supported")
            info["dtype"] = np.dtype(f"<f{size}")
        elif mtype == 0x0008:
            version, cls = body[0], body[1]
            if version != 3:
                raise ValueError(f"data layout version {version} unsupported")
            if cls == 1:
                info["contiguous"] = struct.unpack_from("<Q", body, 2)[0]
            elif cls == 2:
                ndim = body[2]
                info["btree"] = struct.unpack_from("<Q", body, 3)[0]
                info["chunk"] = struct.unpack_from(f"<{ndim}I", body, 11)[:-1]
            else:
                raise ValueError(f"data layout class {cls} unsupported")
        elif mtype == 0x000B:
            info["filters"] = _filters(body)
    return info


def _filters(body: bytes) -> list[int]:
    version, count = body[0], body[1]
    pos, ids = (8 if version == 1 else 2), []
    for _ in range(count):
        fid = struct.unpack_from("<H", body, pos)[0]
        if version == 1 or fid >= 256:
            name_len, _, nvals = struct.unpack_from("<HHH", body, pos + 2)
            pos += 8 + (name_len + (-name_len % 8 if version == 1 else 0))
        else:
            _, nvals = struct.unpack_from("<HH", body, pos + 2)
            name_len, pos = 0, pos + 6
        pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (1, 2):
            raise ValueError(f"HDF5 filter {fid} unsupported (deflate and "
                             f"shuffle only)")
        ids.append(fid)
    return ids


def _decode_chunk(raw: bytes, filters: list[int], mask: int,
                  itemsize: int) -> bytes:
    for i, fid in reversed(list(enumerate(filters))):
        if mask & (1 << i):
            continue
        if fid == 1:
            raw = zlib.decompress(raw)
        else:  # shuffle: bytes were grouped by significance
            raw = np.frombuffer(raw, np.uint8).reshape(itemsize, -1).T.tobytes()
    return raw


def dataset_shapes(path: str) -> dict[str, tuple]:
    """``{name: shape}`` of the datasets in the file's root group."""
    with open(path, "rb") as f:
        fh = _File(f)
        return {n: tuple(_dataset_info(fh, h)["shape"])
                for n, h in _root(fh).items()}


def read_rows(path: str, name: str, start: int = 0,
              stop: int | None = None) -> np.ndarray:
    """Rows ``start:stop`` (along the first axis) of dataset ``name``."""
    with open(path, "rb") as f:
        fh = _File(f)
        entries = _root(fh)
        if name not in entries:
            raise KeyError(f"{path} has no dataset {name!r}")
        info = _dataset_info(fh, entries[name])
        shape, dtype = info["shape"], info["dtype"]
        stop = shape[0] if stop is None else min(stop, shape[0])
        start = min(start, stop)
        out_shape = (stop - start,) + tuple(shape[1:])
        if "contiguous" in info:
            row = int(np.prod(shape[1:])) * dtype.itemsize
            if info["contiguous"] == _UNDEF:      # never written
                return np.zeros(out_shape, dtype)
            raw = fh.at(info["contiguous"] + start * row, (stop - start) * row)
            return np.frombuffer(raw, dtype).reshape(out_shape).copy()
        out = np.zeros(out_shape, dtype)
        chunk = info["chunk"]
        for offs, size, mask, addr in fh.chunks(info["btree"], len(shape)):
            if offs[0] >= stop or offs[0] + chunk[0] <= start:
                continue
            raw = _decode_chunk(fh.at(addr, size), info["filters"], mask,
                                dtype.itemsize)
            block = np.frombuffer(raw, dtype).reshape(chunk)
            src, dst = [], []
            for d, (o, c, n) in enumerate(zip(offs, chunk, shape)):
                lo, hi = (max(o, start), min(o + c, stop)) if d == 0 else (
                    o, min(o + c, n))
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - start, hi - start) if d == 0
                           else slice(lo, hi))
            out[tuple(dst)] = block[tuple(src)]
        return out

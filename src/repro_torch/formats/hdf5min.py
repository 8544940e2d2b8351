"""Minimal, structurally faithful HDF5 writer/reader (pure Python;
benchmark baseline DESIGN.md §6).

Offline container ⇒ no h5py/libhdf5, but the paper's headline claim is
"2–3× faster than HDF5", so we implement the baseline ourselves per the
reproduction rules. This module emits *real* HDF5 (format spec v0
structures): superblock v0, root group with cached symbol-table entry,
local heap, B-tree v1 group node, SNOD symbol nodes, version-1 object
headers carrying dataspace / datatype / contiguous-layout messages.

Two deliberate fidelity choices:

* The writer performs **one seek+write per file section** (superblock,
  object headers, heap, B-tree, SNOD, each data segment) instead of
  assembling one buffer — mirroring libhdf5's scattered metadata I/O,
  which is precisely the overhead the paper attributes HDF5's slowness to.
  (A buffered variant is available as ``write_datasets(..., buffered=True)``
  to separate "format structure cost" from "syscall cost" in benchmarks.)
* Group leaf-k is sized so a single SNOD holds all links (spec-legal for
  u16 k), avoiding a full B-tree split implementation; this *favors* HDF5
  in benchmarks, keeping the measured RawArray speedup conservative.

Supported dtypes: i1..i8, u1..u8, f4, f8 (little-endian), which covers the
paper's benchmarks.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
SNOD_MAX = 32768  # symbols per SNOD (u16 count field)


def _align8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------- datatype
def _datatype_message(dtype: np.dtype) -> bytes:
    """Version-1 datatype message payload for fixed-point / IEEE float."""
    dtype = np.dtype(dtype)
    size = dtype.itemsize
    if dtype.kind in "iu":
        cls, ver = 0, 1
        bits0 = 0x08 if dtype.kind == "i" else 0x00  # signed bit
        header = ((ver << 4) | cls, bits0, 0, 0)
        props = struct.pack("<HH", 0, size * 8)  # bit offset, precision
    elif dtype.kind == "f":
        cls, ver = 1, 1
        # little-endian IEEE: byte order 0, sign location per width
        if size == 4:
            bits0, props = 0x20, struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
        elif size == 8:
            bits0, props = 0x20, struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
        else:
            raise ValueError(f"hdf5min: unsupported float width {size}")
        header = ((ver << 4) | cls, bits0 | 0x00, 0x1F if size == 8 else 0x0F, 0)
    else:
        raise ValueError(f"hdf5min: unsupported dtype {dtype}")
    return struct.pack("<BBBBI", *header, size) + props


def _parse_datatype(buf: bytes) -> np.dtype:
    b0, bits0, _, _, size = struct.unpack_from("<BBBBI", buf, 0)
    cls = b0 & 0x0F
    if cls == 0:
        return np.dtype(f"<{'i' if bits0 & 0x08 else 'u'}{size}")
    if cls == 1:
        return np.dtype(f"<f{size}")
    raise ValueError(f"hdf5min: unsupported datatype class {cls}")


# ---------------------------------------------------------------- messages
def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    body = struct.pack("<BBBB4x", 1, len(shape), 0, 0)
    body += b"".join(struct.pack("<Q", d) for d in shape)
    return body


def _layout_message(addr: int, nbytes: int) -> bytes:
    # version 3, class 1 (contiguous)
    return struct.pack("<BBQQ", 3, 1, addr, nbytes)


def _symtab_message(btree_addr: int, heap_addr: int) -> bytes:
    return struct.pack("<QQ", btree_addr, heap_addr)


def _message(mtype: int, body: bytes) -> bytes:
    body_p = body + b"\x00" * (_align8(len(body)) - len(body))
    return struct.pack("<HHBBBB", mtype, len(body_p), 0, 0, 0, 0) + body_p


def _object_header(messages: List[Tuple[int, bytes]]) -> bytes:
    msgs = b"".join(_message(t, b) for t, b in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(msgs)) + msgs


def _parse_object_header(data: bytes, off: int) -> Dict[int, bytes]:
    ver, _, nmsgs, _refcnt, hsize = struct.unpack_from("<BBHII", data, off)
    if ver != 1:
        raise ValueError("hdf5min: only v1 object headers supported")
    pos = off + 16
    out: Dict[int, bytes] = {}
    for _ in range(nmsgs):
        mtype, msize, _flags = struct.unpack_from("<HHB", data, pos)
        out[mtype] = data[pos + 8 : pos + 8 + msize]
        pos += 8 + msize
    return out


# ---------------------------------------------------------------- writer
def write_datasets(path: str, datasets: Dict[str, np.ndarray], *, buffered: bool = False) -> int:
    """Write named arrays as HDF5 datasets under the root group."""
    names = sorted(datasets)
    arrays = [np.ascontiguousarray(datasets[n]) for n in names]

    # ---- plan the file layout ------------------------------------------
    sb_size = 96
    # root group object header (symbol table message)
    root_oh = _object_header([(0x0011, _symtab_message(0, 0))])  # patched later
    root_oh_addr = sb_size
    heap_addr = _align8(root_oh_addr + len(root_oh))
    # local heap: data segment holds "" at offset 0 then each name
    heap_data = bytearray(b"\x00" * 8)
    name_offsets = []
    for n in names:
        name_offsets.append(len(heap_data))
        nb = n.encode() + b"\x00"
        heap_data += nb + b"\x00" * (_align8(len(nb)) - len(nb))
    heap_hdr_size = 32
    heap_data_addr = heap_addr + heap_hdr_size
    btree_addr = _align8(heap_data_addr + len(heap_data))
    # SNOD groups of <= SNOD_MAX symbols (u16 field); one leaf B-tree node
    # pointing at every group — how real HDF5 scales past 64k links
    groups = [list(range(i, min(i + SNOD_MAX, len(names)))) for i in range(0, max(1, len(names)), SNOD_MAX)]
    btree_size = 24 + 8 * (len(groups) + 1) + 8 * len(groups)
    snod_addrs = []
    cursor = _align8(btree_addr + btree_size)
    for g in groups:
        snod_addrs.append(cursor)
        cursor = _align8(cursor + 8 + 40 * max(1, len(g)))
    # dataset object headers
    oh_addrs, oh_blobs = [], []
    data_addrs = []
    # first pass to compute object header sizes with dummy addresses
    for arr in arrays:
        oh = _object_header(
            [
                (0x0001, _dataspace_message(arr.shape)),
                (0x0003, _datatype_message(arr.dtype)),
                (0x0008, _layout_message(0, arr.nbytes)),
            ]
        )
        oh_addrs.append(cursor)
        oh_blobs.append(oh)
        cursor = _align8(cursor + len(oh))
    for arr in arrays:
        data_addrs.append(cursor)
        cursor = _align8(cursor + max(1, arr.nbytes))
    eof = cursor

    # ---- rebuild blobs with real addresses ------------------------------
    root_oh = _object_header([(0x0011, _symtab_message(btree_addr, heap_addr))])
    for i, arr in enumerate(arrays):
        oh_blobs[i] = _object_header(
            [
                (0x0001, _dataspace_message(arr.shape)),
                (0x0003, _datatype_message(arr.dtype)),
                (0x0008, _layout_message(data_addrs[i], arr.nbytes)),
            ]
        )

    superblock = b"".join(
        [
            SIGNATURE,
            struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0),
            struct.pack("<HH", min(32767, max(4, (len(names) + 1) // 2)), 16),  # leaf k, internal k
            struct.pack("<I", 0),
            struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF),
            # root symbol table entry: name off 0, OH addr, cache type 1 + scratch
            struct.pack("<QQII", 0, root_oh_addr, 1, 0),
            struct.pack("<QQ", btree_addr, heap_addr),
        ]
    )
    assert len(superblock) == sb_size, len(superblock)

    heap_hdr = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), UNDEF, heap_data_addr)
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups), UNDEF, UNDEF)
    for gi, g in enumerate(groups):
        key = name_offsets[g[0]] if (g and name_offsets) else 0
        btree += struct.pack("<Q", key if gi else 0)
        btree += struct.pack("<Q", snod_addrs[gi])
    btree += struct.pack("<Q", name_offsets[-1] if name_offsets else 0)
    snods = []
    for g in groups:
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(g))
        for i in g:
            snod += struct.pack("<QQII16x", name_offsets[i], oh_addrs[i], 0, 0)
        snods.append(snod)

    sections: List[Tuple[int, bytes]] = [
        (0, superblock),
        (root_oh_addr, root_oh),
        (heap_addr, heap_hdr),
        (heap_data_addr, bytes(heap_data)),
        (btree_addr, btree),
    ] + list(zip(snod_addrs, snods))
    for i, arr in enumerate(arrays):
        sections.append((oh_addrs[i], oh_blobs[i]))
        sections.append((data_addrs[i], arr.tobytes()))

    with open(path, "wb") as f:
        if buffered:
            buf = bytearray(eof)
            for addr, blob in sections:
                buf[addr : addr + len(blob)] = blob
            f.write(bytes(buf))
        else:
            # libhdf5-style scattered metadata writes: seek+write per section
            for addr, blob in sections:
                f.seek(addr)
                f.write(blob)
            f.truncate(eof)
    return eof


def write(path: str, arr: np.ndarray, name: str = "data", **kw) -> int:
    return write_datasets(path, {name: arr}, **kw)


def write_datasets_incremental(path: str, datasets: Dict[str, np.ndarray]) -> int:
    """Emulates the libhdf5/h5py ``create_dataset``-in-a-loop call pattern:
    per dataset, the object header and data are appended and the group
    metadata (SNOD + superblock EOF) is rewritten — the incremental
    metadata churn that makes real HDF5 slow for many small objects.
    Together with the batch writer this brackets real libhdf5 cost."""
    names = sorted(datasets)
    # plan static sections once (heap holds all names; snod sized for all)
    sb_size = 96
    root_oh = _object_header([(0x0011, _symtab_message(0, 0))])
    root_oh_addr = sb_size
    heap_addr = _align8(root_oh_addr + len(root_oh))
    heap_data = bytearray(b"\x00" * 8)
    name_offsets = []
    for n in names:
        name_offsets.append(len(heap_data))
        nb = n.encode() + b"\x00"
        heap_data += nb + b"\x00" * (_align8(len(nb)) - len(nb))
    heap_hdr_size = 32
    heap_data_addr = heap_addr + heap_hdr_size
    btree_addr = _align8(heap_data_addr + len(heap_data))
    groups = [list(range(i, min(i + SNOD_MAX, len(names)))) for i in range(0, max(1, len(names)), SNOD_MAX)]
    btree_size = 24 + 8 * (len(groups) + 1) + 8 * len(groups)
    snod_addrs = []
    cursor = _align8(btree_addr + btree_size)
    for g in groups:
        snod_addrs.append(cursor)
        cursor = _align8(cursor + 8 + 40 * max(1, len(g)))

    root_oh = _object_header([(0x0011, _symtab_message(btree_addr, heap_addr))])
    heap_hdr = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), UNDEF, heap_data_addr)
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups), UNDEF, UNDEF)
    for gi, g in enumerate(groups):
        key = name_offsets[g[0]] if (g and name_offsets) else 0
        btree += struct.pack("<Q", key if gi else 0)
        btree += struct.pack("<Q", snod_addrs[gi])
    btree += struct.pack("<Q", name_offsets[-1] if name_offsets else 0)

    def superblock(eof):
        return b"".join([
            SIGNATURE,
            struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0),
            struct.pack("<HH", min(32767, max(4, (len(names) + 1) // 2)), 16),
            struct.pack("<I", 0),
            struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF),
            struct.pack("<QQII", 0, root_oh_addr, 1, 0),
            struct.pack("<QQ", btree_addr, heap_addr),
        ])

    with open(path, "wb") as f:
        f.seek(0); f.write(superblock(cursor))
        f.seek(root_oh_addr); f.write(root_oh)
        f.seek(heap_addr); f.write(heap_hdr)
        f.seek(heap_data_addr); f.write(bytes(heap_data))
        f.seek(btree_addr); f.write(btree)
        snod_entries = []
        gi = 0
        for i, n in enumerate(names):
            if i // SNOD_MAX != gi:  # rolled into the next SNOD group
                gi = i // SNOD_MAX
                snod_entries = []
            arr = np.ascontiguousarray(datasets[n])
            oh_addr = cursor
            oh = _object_header([
                (0x0001, _dataspace_message(arr.shape)),
                (0x0003, _datatype_message(arr.dtype)),
                (0x0008, _layout_message(0, arr.nbytes)),
            ])
            data_addr = _align8(oh_addr + len(oh))
            oh = _object_header([
                (0x0001, _dataspace_message(arr.shape)),
                (0x0003, _datatype_message(arr.dtype)),
                (0x0008, _layout_message(data_addr, arr.nbytes)),
            ])
            # per-dataset churn: header, data, current-SNOD rewrite, SB EOF
            f.seek(oh_addr); f.write(oh)
            f.seek(data_addr); f.write(arr.tobytes())
            cursor = _align8(data_addr + max(1, arr.nbytes))
            snod_entries.append(struct.pack("<QQII16x", name_offsets[i], oh_addr, 0, 0))
            snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(snod_entries)) + b"".join(snod_entries)
            f.seek(snod_addrs[gi]); f.write(snod)
            f.seek(0); f.write(superblock(cursor))
        f.truncate(cursor)
    return cursor


# ---------------------------------------------------------------- reader
class H5MinFile:
    """Parse the subset we write. Each access pattern mirrors libhdf5's:
    superblock → root entry → B-tree → SNOD → object header → data."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        d = self._data
        if d[:8] != SIGNATURE:
            raise ValueError("not an HDF5 file")
        # root symbol table entry at offset 56 within 96-byte superblock
        self._btree_addr, self._heap_addr = struct.unpack_from("<QQ", d, 80)
        # local heap data segment address
        _, heap_len, _, heap_data_addr = struct.unpack_from("<B3xQQQ", d, self._heap_addr + 4)
        self._heap = d[heap_data_addr : heap_data_addr + heap_len]
        self.names: Dict[str, int] = {}
        self._walk_btree(self._btree_addr)

    def _walk_btree(self, addr: int) -> None:
        d = self._data
        if d[addr : addr + 4] != b"TREE":
            raise ValueError("bad B-tree node")
        _ntype, level, nused = struct.unpack_from("<BBH", d, addr + 4)
        pos = addr + 24
        children = []
        for i in range(nused):
            pos += 8  # key
            (child,) = struct.unpack_from("<Q", d, pos)
            children.append(child)
            pos += 8
        for child in children:
            if level > 0:
                self._walk_btree(child)
            else:
                self._read_snod(child)

    def _read_snod(self, addr: int) -> None:
        d = self._data
        if d[addr : addr + 4] != b"SNOD":
            raise ValueError("bad SNOD")
        (nsym,) = struct.unpack_from("<H", d, addr + 6)
        pos = addr + 8
        for _ in range(nsym):
            name_off, oh_addr = struct.unpack_from("<QQ", d, pos)
            end = self._heap.index(b"\x00", name_off)
            self.names[self._heap[name_off:end].decode()] = oh_addr
            pos += 40

    def read(self, name: str) -> np.ndarray:
        msgs = _parse_object_header(self._data, self.names[name])
        ver, ndims = struct.unpack_from("<BB", msgs[0x0001], 0)
        shape = struct.unpack_from(f"<{ndims}Q", msgs[0x0001], 8)
        dtype = _parse_datatype(msgs[0x0003])
        _v, _c, addr, nbytes = struct.unpack_from("<BBQQ", msgs[0x0008], 0)
        return (
            np.frombuffer(self._data[addr : addr + nbytes], dtype=dtype)
            .reshape(shape)
            .copy()
        )

    def read_all(self) -> Dict[str, np.ndarray]:
        return {n: self.read(n) for n in self.names}


def read(path: str, name: str = "data") -> np.ndarray:
    return H5MinFile(path).read(name)

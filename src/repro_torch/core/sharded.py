"""Sharded RawArray stores — one logical array striped over N ``.ra`` files.

Beyond-paper extension (DESIGN.md §7): the paper's vision is "metadata as
human-readable markup, raw data in RawArray files, organized by a file
system directory structure". A sharded store is exactly that — a directory::

    <name>/
      index.json          {"shape": [...], "dtype": "float32",
                           "axis": 0, "offsets": [0, r0, r0+r1, ...],
                           "files": ["shard_00000.ra", ...]}
      shard_00000.ra      rows [offsets[0], offsets[1])
      shard_00001.ra      ...

Each shard is an independent, self-describing RawArray file, so shards can
be written in parallel by different hosts and read back under a *different*
slicing (elastic restore): ``read_slice`` touches only the shards that
overlap the requested row range, fanning the overlapping shards out over
the parallel I/O engine straight into one output buffer (DESIGN.md §8).

``dirpath`` may also be an ``http(s)://`` URL of a served shard directory
(DESIGN.md §9): the index is fetched over HTTP and every shard read becomes
engine-planned parallel byte-range requests through ``repro_torch.remote`` —
the same wave structure, remote sources.

Writing is streaming-capable too (DESIGN.md §11): ``ShardedWriter`` feeds
row batches of unknown total count, auto-rolls shards at a size threshold
(``RA_SHARD_BYTES``), and publishes the index atomically at finalize.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import codec as chunked_codec
from . import engine
from . import io as raio
from .io import RaWriter, is_url, join_path as _join
from .stats import stats_supported
from .spec import FLAG_CHUNKED, RawArrayError, env_int as _env_int

INDEX_NAME = "index.json"


def default_shard_bytes() -> int:
    """Auto-roll threshold for ``ShardedWriter`` in raw payload bytes
    (knob ``RA_SHARD_BYTES``, default 256 MiB)."""
    return max(1, _env_int("RA_SHARD_BYTES", 256 << 20))


@dataclass(frozen=True)
class ShardIndex:
    shape: Tuple[int, ...]
    dtype: str
    axis: int
    offsets: Tuple[int, ...]  # len = nshards + 1, offsets[0] == 0
    files: Tuple[str, ...]

    def to_json(self) -> str:
        return json.dumps(
            {
                "format": "rawarray-sharded-v1",
                "shape": list(self.shape),
                "dtype": self.dtype,
                "axis": self.axis,
                "offsets": list(self.offsets),
                "files": list(self.files),
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "ShardIndex":
        d = json.loads(text)
        if d.get("format") != "rawarray-sharded-v1":
            raise RawArrayError(f"not a sharded RawArray index: {d.get('format')}")
        return cls(
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            axis=int(d["axis"]),
            offsets=tuple(d["offsets"]),
            files=tuple(d["files"]),
        )

    def rows_per_shard(self) -> Tuple[int, ...]:
        """Row count of each shard along the sharded axis — the unit of
        distribution for the data mesh's ownership map (DESIGN.md §15)."""
        return tuple(b - a for a, b in zip(self.offsets, self.offsets[1:]))

    def row_nbytes(self) -> int:
        """Bytes one row (one index along ``axis``) occupies on disk — index
        arithmetic only, no shard is opened."""
        per = 1
        for i, d in enumerate(self.shape):
            if i != self.axis:
                per *= int(d)
        return per * np.dtype(self.dtype).itemsize


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.ra"


def _decode_rows(path: str, a: int, b: int, dst) -> None:
    """Fallback for shards that are not range-addressable (whole-file zlib,
    big-endian): decode the shard and copy rows [a, b) into ``dst``."""
    arr = np.asarray(raio.read(path))
    rows = np.ascontiguousarray(arr[a:b])
    dst[:] = memoryview(rows.view(np.uint8).reshape(-1))


def write_sharded(
    dirpath: str,
    arr: np.ndarray,
    *,
    nshards: int,
    axis: int = 0,
    workers: int = 4,
    chunked: bool = False,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    stats: Optional[bool] = None,
) -> ShardIndex:
    """Split ``arr`` along ``axis`` into ``nshards`` RawArray files.

    ``chunked=True`` (or ``codec=``/``chunk_bytes=``) writes every shard
    chunk-compressed (DESIGN.md §10); ``read_slice`` then decodes only the
    chunks overlapping the requested rows.

    ``stats`` controls the per-chunk ``rastats`` block (DESIGN.md §16);
    the default ``None`` auto-enables it for bool/int/float dtypes so
    predicate pushdown works out of the box."""
    if is_url(dirpath):
        raise RawArrayError(f"write_sharded is local-only; got URL {dirpath}")
    if stats is None:
        stats = stats_supported(np.asarray(arr).dtype)
    if axis != 0:
        arr = np.moveaxis(arr, axis, 0)
    n = arr.shape[0]
    nshards = max(1, min(nshards, n)) if n else 1
    bounds = np.linspace(0, n, nshards + 1).astype(int)
    os.makedirs(dirpath, exist_ok=True)
    files = [_shard_name(i) for i in range(nshards)]

    def _write(i: int) -> None:
        raio.write(
            os.path.join(dirpath, files[i]),
            arr[bounds[i] : bounds[i + 1]],
            chunked=chunked,
            codec=codec,
            chunk_bytes=chunk_bytes,
            stats=stats,
        )

    if workers > 1 and nshards > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_write, range(nshards)))
    else:
        for i in range(nshards):
            _write(i)

    # index records the *original* (pre-moveaxis) logical shape
    logical_shape = list(arr.shape)
    if axis != 0:
        logical_shape.insert(axis, logical_shape.pop(0))
    idx = ShardIndex(
        shape=tuple(logical_shape),
        dtype=str(arr.dtype),
        axis=axis,
        offsets=tuple(int(b) for b in bounds),
        files=tuple(files),
    )
    with open(os.path.join(dirpath, INDEX_NAME), "w") as f:
        f.write(idx.to_json())
    return idx


class ShardedWriter:
    """Streaming sharded-store writer (DESIGN.md §11): feed row batches of
    unknown total count; shards auto-roll when the current shard's RAW
    payload reaches ``shard_bytes`` (knob ``RA_SHARD_BYTES``, or pass
    ``shard_rows`` for an exact row count per shard).

    Every shard is an incremental ``RaWriter`` — written to a temp file and
    atomically renamed at its roll, so a crash mid-stream leaves only whole,
    valid shards plus one invisible temp. The ``index.json`` is written LAST
    (also temp + rename): the store does not exist as a store until finalize
    succeeds. The result is readable by ``read_slice`` / ``read_sharded``
    and byte-identical, shard by shard, to ``io.write`` of each row slab
    with matching options (``stats`` defaults ON for numeric dtypes here,
    DESIGN.md §16, so pass ``stats=True`` to the monolithic write when
    byte-comparing).
    """

    def __init__(
        self,
        dirpath: str,
        dtype,
        row_shape: Tuple[int, ...],
        *,
        shard_bytes: Optional[int] = None,
        shard_rows: Optional[int] = None,
        crc32: bool = False,
        chunked: bool = False,
        codec: Optional[str] = None,
        chunk_bytes: Optional[int] = None,
        stats: Optional[bool] = None,
    ):
        if is_url(dirpath):
            raise RawArrayError(f"ShardedWriter is local-only; got URL {dirpath}")
        self.dirpath = dirpath
        self._dtype = np.dtype(dtype)
        if stats is None:  # default-on for numeric dtypes (DESIGN.md §16)
            stats = stats_supported(self._dtype)
        self._row_shape = tuple(int(d) for d in row_shape)
        row_nbytes = self._dtype.itemsize
        for d in self._row_shape:
            row_nbytes *= d
        if shard_rows is not None:
            self._shard_rows = max(1, int(shard_rows))
        else:
            nbytes = default_shard_bytes() if shard_bytes is None else max(1, shard_bytes)
            self._shard_rows = max(1, nbytes // row_nbytes) if row_nbytes else 1 << 30
        self._wkw = dict(crc32=crc32, chunked=chunked, codec=codec,
                         chunk_bytes=chunk_bytes, stats=stats)
        self._offsets: List[int] = [0]
        self._files: List[str] = []
        self._writer: Optional[RaWriter] = None
        self._writer_rows = 0
        self._state = "open"
        os.makedirs(dirpath, exist_ok=True)

    @property
    def rows(self) -> int:
        """Total rows written so far across all shards."""
        return self._offsets[-1] + self._writer_rows

    def _open_shard(self) -> RaWriter:
        if self._writer is None:
            fname = _shard_name(len(self._files))
            self._files.append(fname)
            self._writer = RaWriter(
                os.path.join(self.dirpath, fname),
                self._dtype, self._row_shape, **self._wkw,
            )
            self._writer_rows = 0
        return self._writer

    def _roll(self) -> None:
        self._writer.finalize()
        self._offsets.append(self._offsets[-1] + self._writer_rows)
        self._writer = None
        self._writer_rows = 0

    def write_rows(self, rows: np.ndarray) -> int:
        """Append a batch shaped ``(n, *row_shape)``, splitting it across
        shard boundaries; returns total rows so far."""
        if self._state != "open":
            raise RawArrayError(f"write_rows on a {self._state} ShardedWriter")
        a = np.asarray(rows)
        pos, n = 0, a.shape[0]
        while pos < n:
            w = self._open_shard()
            take = min(n - pos, self._shard_rows - self._writer_rows)
            w.write_rows(a[pos : pos + take])
            self._writer_rows += take
            pos += take
            if self._writer_rows >= self._shard_rows:
                self._roll()
        return self.rows

    def finalize(self) -> ShardIndex:
        """Seal the last shard and atomically publish ``index.json``.
        A store that never received rows still gets one (empty) shard, the
        same layout ``write_sharded`` produces for an empty array."""
        if self._state != "open":
            raise RawArrayError(f"finalize on a {self._state} ShardedWriter")
        if self._writer is not None:
            self._roll()
        if not self._files:  # zero rows: one empty shard, like write_sharded
            self._open_shard()
            self._roll()
        idx = ShardIndex(
            shape=(self._offsets[-1],) + self._row_shape,
            dtype=str(self._dtype),
            axis=0,
            offsets=tuple(self._offsets),
            files=tuple(self._files),
        )
        tmp = os.path.join(self.dirpath, INDEX_NAME + ".tmp")
        with open(tmp, "w") as f:
            f.write(idx.to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dirpath, INDEX_NAME))
        self._state = "finalized"
        return idx

    def abort(self) -> None:
        """Drop the in-progress shard (finished shards and any existing
        index are left as they were; no index is written)."""
        if self._state == "open":
            self._state = "aborted"
            if self._writer is not None:
                self._writer.abort()
                self._writer = None

    def __enter__(self) -> "ShardedWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        elif self._state == "open":
            self.finalize()


def load_index(dirpath: str) -> ShardIndex:
    if is_url(dirpath):
        from .. import remote

        return ShardIndex.from_json(
            remote.fetch_bytes(_join(dirpath, INDEX_NAME)).decode()
        )
    with open(os.path.join(dirpath, INDEX_NAME)) as f:
        return ShardIndex.from_json(f.read())


def _stored_rest(idx: ShardIndex) -> Tuple[int, ...]:
    """Per-row shape of the on-disk (axis-moved-to-front) layout."""
    s = list(idx.shape)
    if idx.axis < len(s):
        s.pop(idx.axis)
    else:
        s = s[1:]
    return tuple(s)


def _empty_slice(idx: ShardIndex) -> np.ndarray:
    shape = list(idx.shape)
    if idx.axis < len(shape):
        shape[idx.axis] = 0
    else:
        shape = [0] + shape[1:]
    return np.empty(tuple(shape), dtype=np.dtype(idx.dtype))


def read_slice(
    dirpath: str,
    start: int,
    stop: int,
    index: Optional[ShardIndex] = None,
    *,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Read rows [start, stop) along the shard axis, touching only the shards
    that overlap — the elastic-restore primitive.

    Overlapping shards are read concurrently (one engine wave, DESIGN.md §8)
    straight into a single output buffer — no per-shard intermediate arrays
    and no ``np.concatenate``. Pass ``out`` (C-contiguous, the result's exact
    shape and dtype) to stream into a preallocated / reused destination.
    """
    idx = index or load_index(dirpath)
    start, stop = max(0, start), min(stop, idx.offsets[-1])
    if stop <= start:
        return _empty_slice(idx)
    nrows = stop - start
    rest = _stored_rest(idx)
    dtype = np.dtype(idx.dtype)
    stored_shape = (nrows,) + rest
    if idx.axis == 0 and out is not None:
        if tuple(out.shape) != stored_shape or out.dtype != dtype or not out.flags.c_contiguous:
            raise RawArrayError(
                f"read_slice: out must be C-contiguous {stored_shape} {dtype}, "
                f"got {out.shape} {out.dtype}"
            )
        stored = out
    else:
        stored = np.empty(stored_shape, dtype)
    row_nbytes = dtype.itemsize
    for d in rest:
        row_nbytes *= d
    mv = memoryview(stored.reshape(-1).view(np.uint8)).cast("B") if row_nbytes else None
    offs = idx.offsets
    overlaps = []  # (shard index, path, lo, a, b)
    for i, fname in enumerate(idx.files):
        lo, hi = offs[i], offs[i + 1]
        if hi <= start or lo >= stop:
            continue
        a, b = max(start, lo) - lo, min(stop, hi) - lo
        overlaps.append((i, _join(dirpath, fname), lo, a, b))
    # resolve shard headers (and, for chunked shards, their chunk tables +
    # sources) concurrently: remotely each one is an HTTP round trip, and
    # doing them serially would dominate wide slices' latency
    hdrs: dict = {}
    tables: dict = {}
    srcs: dict = {}  # chunked shards: fd / reader, opened once and reused
    fds: List[int] = []

    def _resolve(i: int, path: str) -> None:
        hdr = raio.header_of(path)
        hdrs[i] = hdr
        # big-endian chunked shards take the decode-and-copy fallback (the
        # chunk fast path would stream BE bytes into a native-LE buffer)
        if hdr.flags & FLAG_CHUNKED and not hdr.big_endian:
            if is_url(path):
                from .. import remote

                src = remote.get_reader(path)  # registry-pooled; not closed here
            else:
                src = os.open(path, os.O_RDONLY)
                fds.append(src)
            srcs[i] = src
            tables[i] = chunked_codec.read_table(src, hdr)

    jobs = []
    tasks = []  # chunk decodes + whole-shard decode fallbacks
    try:
        engine.run_tasks(
            [(lambda i=i, p=p: _resolve(i, p)) for i, p, _, _, _ in overlaps]
        )
        for i, path, lo, a, b in overlaps:
            hdr = hdrs[i]
            if hdr.shape[1:] != rest or hdr.shape[0] != offs[i + 1] - lo:
                raise RawArrayError(
                    f"{idx.files[i]}: shard shape {hdr.shape} inconsistent with index"
                )
            if row_nbytes == 0 or b == a:
                continue
            dst = mv[(lo + a - start) * row_nbytes : (lo + b - start) * row_nbytes]
            if i in srcs:
                tasks += chunked_codec.chunk_read_tasks(
                    srcs[i], hdr, tables[i], a * row_nbytes, b * row_nbytes, dst
                )
            elif hdr.compressed or hdr.big_endian:
                # whole-file zlib / big-endian: not range-addressable — decode
                # the shard on a pool thread and copy the requested rows
                tasks.append(lambda p=path, a=a, b=b, d=dst: _decode_rows(p, a, b, d))
            else:
                if is_url(path):
                    from .. import remote

                    src = remote.get_reader(path)  # registry-pooled; not closed here
                else:
                    src = os.open(path, os.O_RDONLY)
                    fds.append(src)
                jobs.append((src, hdr.nbytes + a * row_nbytes, dst))
        if tasks:  # one wave: slab preads + chunk decodes share the pool
            engine.run_tasks(engine.span_read_tasks(jobs) + tasks)
        else:
            engine.parallel_read_spans(jobs)
    finally:
        for fd in fds:
            os.close(fd)
    result = stored
    if idx.axis != 0:
        result = np.moveaxis(result.reshape((nrows,) + rest), 0, idx.axis)
        if out is not None:
            if tuple(out.shape) != result.shape or out.dtype != dtype:
                raise RawArrayError(
                    f"read_slice: out shape {out.shape} != result {result.shape}"
                )
            out[...] = result
            result = out
    return result


def read_slice_naive(
    dirpath: str, start: int, stop: int, index: Optional[ShardIndex] = None
) -> np.ndarray:
    """Reference single-stream implementation (mmap each overlapping shard,
    then concatenate; whole-shard reads + slicing when remote). Kept for
    equivalence tests and as the sequential baseline in
    ``benchmarks/bench_formats.py``."""
    idx = index or load_index(dirpath)
    start, stop = max(0, start), min(stop, idx.offsets[-1])
    if stop <= start:
        return _empty_slice(idx)
    pieces: List[np.ndarray] = []
    offs = idx.offsets
    for i, fname in enumerate(idx.files):
        lo, hi = offs[i], offs[i + 1]
        if hi <= start or lo >= stop:
            continue
        a, b = max(start, lo) - lo, min(stop, hi) - lo
        path = _join(dirpath, fname)
        if is_url(path) or raio.header_of(path).compressed:
            pieces.append(np.asarray(raio.read(path))[a:b])
        else:
            pieces.append(np.asarray(raio.memmap_slice(path, a, b)))
    out = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)
    if idx.axis != 0:
        out = np.moveaxis(out, 0, idx.axis)
    return out


def read_sharded(dirpath: str) -> np.ndarray:
    idx = load_index(dirpath)
    return read_slice(dirpath, 0, idx.offsets[-1], idx)

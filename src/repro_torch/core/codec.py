"""Chunked parallel compression codec for RawArray payloads (DESIGN.md §10).

Whole-file zlib (``FLAG_ZLIB``) forces single-threaded decode and defeats
every partial-read path the format exists for. ``FLAG_CHUNKED`` fixes that
the way Zarr does: the payload is a sequence of *independently* compressed
chunks, followed by a trailer chunk table — so decode parallelizes chunk-
wise over the engine pool, and any logical byte range touches only the
chunks that overlap it (``read_slice`` / ``gather`` / remote ranged GETs
stay partial).

On-disk layout of a chunked file::

    header                      (flags has FLAG_CHUNKED;
                                 data_length = stored chunk-stream bytes)
    stored chunk 0..n-1         back-to-back compressed chunks
    chunk table                 see below
    metadata[...]               optional trailing user metadata
    crc32                       optional 4-byte file-level CRC (of the
                                stored chunk stream, FLAG_CRC32_TRAILER)

Chunk table wire format (all ``<u8``, introspectable with ``od -t u8``
exactly like the header — the paper's "trailer can be anything" clause)::

    u64 magic                   "rachunks" as little-endian ASCII
    u64 codec_id                registry code (0=raw, 1=zlib, 2=lz4, ...)
    u64 chunk_bytes             nominal raw chunk size (last may be short)
    u64 nchunks
    u64 entries[nchunks][4]     raw_offset, stored_offset, stored_len, crc32
                                (crc32 is of the *stored* chunk bytes, so
                                verification never needs to decompress)

Codec registry: numeric id + name -> (compress, decompress). zlib is always
present (stdlib); lz4 / zstd register themselves only when importable, so a
file written elsewhere with an unavailable codec fails with a clear error
instead of an ImportError. ``RA_CODEC`` picks the default codec name and
``RA_CHUNK_BYTES`` the default chunk size (1 MiB).

Module-level counters (``stats()`` / ``reset_stats()``) count every chunk
actually fetched + decompressed — the observable that proves partial reads
touch only overlapping chunks (surfaced via ``RaDataset.io_stats()``).
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import engine, layouts
from .spec import RawArrayError, env_int as _env_int, env_str as _env_str

CHUNK_MAGIC: int = layouts.CHUNK_TABLE.magic_int
TABLE_HEAD = layouts.CHUNK_TABLE.head_struct  # magic, codec_id, chunk_bytes, nchunks
TABLE_HEAD_BYTES = layouts.CHUNK_TABLE.head_bytes  # 32
ENTRY_BYTES = layouts.CHUNK_TABLE.entry_bytes  # 4 x u64 per chunk


def default_chunk_bytes() -> int:
    """Raw bytes per chunk (knob ``RA_CHUNK_BYTES``, default 1 MiB)."""
    return max(1 << 12, _env_int("RA_CHUNK_BYTES", 1 << 20))


def default_codec_name() -> str:
    """Default codec (knob ``RA_CODEC``)."""
    return _env_str("RA_CODEC", "zlib")


# ------------------------------------------------------------ codec registry
@dataclass(frozen=True)
class Codec:
    codec_id: int
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


_by_id: Dict[int, Codec] = {}
_by_name: Dict[str, Codec] = {}


def register_codec(
    codec_id: int,
    name: str,
    compress: Callable[[bytes], bytes],
    decompress: Callable[[bytes], bytes],
) -> Codec:
    """Add a codec to the registry (id is the on-disk code; keep them stable)."""
    c = Codec(codec_id, name, compress, decompress)
    _by_id[codec_id] = c
    _by_name[name] = c
    return c


def get_codec(key: Union[int, str, None]) -> Codec:
    """Resolve a codec by registry id, name, or ``None`` (the env default)."""
    if key is None:
        key = default_codec_name()
    c = _by_name.get(key) if isinstance(key, str) else _by_id.get(key)
    if c is None:
        known = ", ".join(f"{c.codec_id}={c.name}" for c in sorted(_by_id.values(), key=lambda c: c.codec_id))
        raise RawArrayError(
            f"unknown or unavailable codec {key!r} (registered: {known})"
        )
    return c


# Codecs take and return bytes-like objects (memoryview in, bytes-like
# out) so the hot path never makes defensive copies.
# id 0 reserved for "store": identity transform, useful for incompressible
# data where chunking still buys parallel + partial reads.
register_codec(0, "raw", lambda b: b, lambda b: b)
# zlib level 1: same speed/ratio point as the FLAG_ZLIB writer.
register_codec(1, "zlib", lambda b: zlib.compress(b, 1), zlib.decompress)
try:  # pragma: no cover - depends on container
    import lz4.frame as _lz4

    register_codec(2, "lz4", _lz4.compress, _lz4.decompress)
except ImportError:
    pass
try:  # pragma: no cover - depends on container
    import zstandard as _zstd

    register_codec(
        3, "zstd",
        lambda b: _zstd.ZstdCompressor().compress(b),
        lambda b: _zstd.ZstdDecompressor().decompress(b),
    )
except ImportError:
    pass
# lzma is stdlib: slow but always present; preset 0 keeps it usable.
try:  # pragma: no cover - lzma can be absent on minimal builds
    import lzma as _lzma

    register_codec(
        4, "lzma",
        lambda b: _lzma.compress(b, preset=0),
        _lzma.decompress,
    )
except ImportError:
    pass


# ------------------------------------------------------------- read counters
_stats_lock = threading.Lock()
# Audit note (ralint guarded-by): every _count/stats/reset_stats access was
# already under _stats_lock when audited; the annotation locks that in.
_stats = {"chunk_reads": 0, "chunk_stored_bytes": 0, "chunk_raw_bytes": 0}  # guarded-by: _stats_lock


def _count(stored: int, raw: int) -> None:
    with _stats_lock:
        _stats["chunk_reads"] += 1
        _stats["chunk_stored_bytes"] += stored
        _stats["chunk_raw_bytes"] += raw


def stats() -> Dict[str, int]:
    """Process-wide chunk decode counters (chunks fetched+decompressed)."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


# --------------------------------------------------------------- chunk table
@dataclass(frozen=True)
class ChunkTable:
    """Decoded trailer chunk table of one chunked file."""

    codec_id: int
    chunk_bytes: int
    raw_offsets: np.ndarray     # <u8 [n], raw_offsets[0] == 0, increasing
    stored_offsets: np.ndarray  # <u8 [n], relative to start of data segment
    stored_lens: np.ndarray     # <u8 [n]
    crcs: np.ndarray            # <u8 [n], CRC32 of each *stored* chunk

    @property
    def nchunks(self) -> int:
        return len(self.raw_offsets)

    @property
    def nbytes(self) -> int:
        """Encoded table size on disk."""
        return TABLE_HEAD_BYTES + ENTRY_BYTES * self.nchunks

    @property
    def stored_nbytes(self) -> int:
        if not self.nchunks:
            return 0
        return int(self.stored_offsets[-1] + self.stored_lens[-1])

    def raw_len(self, i: int, logical_nbytes: int) -> int:
        """Raw (decompressed) size of chunk ``i``; the last chunk may be short."""
        end = (
            int(self.raw_offsets[i + 1])
            if i + 1 < self.nchunks
            else logical_nbytes
        )
        return end - int(self.raw_offsets[i])

    def overlapping(self, raw_start: int, raw_stop: int, logical_nbytes: int) -> range:
        """Chunk indices whose raw span intersects [raw_start, raw_stop)."""
        if raw_stop <= raw_start or not self.nchunks:
            return range(0)
        raw_start = max(0, raw_start)
        raw_stop = min(raw_stop, logical_nbytes)
        i0 = int(np.searchsorted(self.raw_offsets, raw_start, side="right")) - 1
        i1 = int(np.searchsorted(self.raw_offsets, raw_stop, side="left"))
        return range(max(0, i0), min(self.nchunks, i1))

    def encode(self) -> bytes:
        head = TABLE_HEAD.pack(CHUNK_MAGIC, self.codec_id, self.chunk_bytes, self.nchunks)
        if not self.nchunks:
            return head
        body = np.column_stack(
            [self.raw_offsets, self.stored_offsets, self.stored_lens, self.crcs]
        ).astype("<u8")
        return head + body.tobytes()

    @classmethod
    def decode(cls, buf: bytes, *, logical_nbytes: int, stored_nbytes: int) -> "ChunkTable":
        """Parse + validate a table from ``buf`` (which may hold extra tail
        bytes — metadata, CRC — after the entries)."""
        if len(buf) < TABLE_HEAD_BYTES:
            raise RawArrayError("chunked flag set but chunk table missing/truncated")
        magic, codec_id, chunk_bytes, n = TABLE_HEAD.unpack(buf[:TABLE_HEAD_BYTES])
        if magic != CHUNK_MAGIC:
            raise RawArrayError(
                f"bad chunk-table magic {magic:#018x} (expected 'rachunks')"
            )
        if n > max(1, logical_nbytes):
            raise RawArrayError(
                f"chunk table claims {n} chunks for a {logical_nbytes}-byte payload"
            )
        need = TABLE_HEAD_BYTES + ENTRY_BYTES * n
        if len(buf) < need:
            raise RawArrayError(
                f"truncated chunk table: wanted {need} bytes, got {len(buf)}"
            )
        cols = np.frombuffer(
            buf, dtype="<u8", count=4 * n, offset=TABLE_HEAD_BYTES
        ).reshape(n, 4)
        t = cls(
            codec_id=int(codec_id),
            chunk_bytes=int(chunk_bytes),
            raw_offsets=cols[:, 0].copy(),
            stored_offsets=cols[:, 1].copy(),
            stored_lens=cols[:, 2].copy(),
            crcs=cols[:, 3].copy(),
        )
        t._validate(logical_nbytes, stored_nbytes)
        return t

    def _validate(self, logical_nbytes: int, stored_nbytes: int) -> None:
        n = self.nchunks
        if n == 0:
            if logical_nbytes or stored_nbytes:
                raise RawArrayError(
                    f"empty chunk table for a {logical_nbytes}-byte payload"
                )
            return
        if int(self.raw_offsets[0]) != 0 or int(self.stored_offsets[0]) != 0:
            raise RawArrayError("chunk table does not start at offset 0")
        if n > 1 and not (np.diff(self.raw_offsets.astype(np.int64)) > 0).all():
            raise RawArrayError("chunk table raw offsets not strictly increasing")
        ends = self.stored_offsets + self.stored_lens
        if n > 1 and (self.stored_offsets[1:] < ends[:-1]).any():
            raise RawArrayError("chunk table stored spans overlap")
        if int(self.raw_offsets[-1]) >= logical_nbytes:
            raise RawArrayError("chunk table raw offsets exceed the logical size")
        if int(ends[-1]) != stored_nbytes:
            raise RawArrayError(
                f"chunk table stored size {int(ends[-1])} != data_length {stored_nbytes}"
            )


# ----------------------------------------------------------------- compress
def compress_chunked(
    payload,
    *,
    codec: Union[int, str, None] = None,
    chunk_bytes: Optional[int] = None,
) -> Tuple[List[bytes], ChunkTable]:
    """Chunk-split ``payload`` and compress every chunk concurrently on the
    engine pool. Returns ``(stored_parts, table)`` where ``stored_parts[i]``
    is chunk ``i``'s compressed bytes-like object (write them back-to-back,
    then the encoded table; the store codec returns zero-copy views into
    ``payload``)."""
    c = get_codec(codec)
    cbytes = default_chunk_bytes() if chunk_bytes is None else chunk_bytes
    if cbytes < 1:
        raise RawArrayError(f"chunk_bytes must be positive, got {cbytes}")
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    total = mv.nbytes
    n = (total + cbytes - 1) // cbytes
    parts: List[Optional[bytes]] = [None] * n

    def job(i: int) -> None:
        a = i * cbytes
        b = min(a + cbytes, total)
        parts[i] = c.compress(mv[a:b])

    engine.run_tasks([(lambda i=i: job(i)) for i in range(n)])
    raw_offs = np.arange(n, dtype="<u8") * cbytes
    lens = np.array([len(p) for p in parts], dtype="<u8")
    stored_offs = np.zeros(n, dtype="<u8")
    if n:
        stored_offs[1:] = np.cumsum(lens)[:-1]
    crcs = np.array([zlib.crc32(p) for p in parts], dtype="<u8")
    table = ChunkTable(
        codec_id=c.codec_id,
        chunk_bytes=cbytes,
        raw_offsets=raw_offs,
        stored_offsets=stored_offs,
        stored_lens=lens,
        crcs=crcs,
    )
    return [p for p in parts], table


class ChunkStreamCompressor:
    """Incremental chunk compression for the streaming write plane
    (DESIGN.md §11).

    ``RaWriter`` feeds raw payload bytes in arbitrary-sized pieces; every
    complete ``chunk_bytes`` window is compressed (one parallel engine wave
    per feed) and handed back as stored parts to append, so compression
    overlaps ingest instead of waiting for the full array. Chunk boundaries
    fall at absolute multiples of ``chunk_bytes`` of the logical payload —
    exactly where ``compress_chunked`` puts them — which is what makes a
    streamed file byte-identical to a monolithic ``io.write``.
    """

    def __init__(
        self,
        codec: Union[int, str, None] = None,
        chunk_bytes: Optional[int] = None,
        stats_dtype=None,
    ):
        self._codec = get_codec(codec)
        self._cbytes = default_chunk_bytes() if chunk_bytes is None else int(chunk_bytes)
        if self._cbytes < 1:
            raise RawArrayError(f"chunk_bytes must be positive, got {self._cbytes}")
        self._buf = bytearray()
        self._raw_offs: List[int] = []
        self._lens: List[int] = []
        self._crcs: List[int] = []
        self._raw_consumed = 0  # raw bytes already turned into stored chunks
        # per-chunk statistics (DESIGN.md §16) accumulate as raw bytes stream
        # through, so stats cost no extra pass over the payload
        if stats_dtype is not None:
            from . import stats as _stats_mod

            self._stats_acc = _stats_mod.StatsAccumulator(stats_dtype, self._cbytes)
        else:
            self._stats_acc = None

    @property
    def codec_id(self) -> int:
        return self._codec.codec_id

    @property
    def chunk_bytes(self) -> int:
        return self._cbytes

    def _compress(self, mv: memoryview) -> List[bytes]:
        """Compress ``mv`` chunk-parallel (chunk boundaries at multiples of
        ``chunk_bytes`` within ``mv``; callers guarantee ``mv`` itself starts
        on a chunk boundary of the logical payload)."""
        cb = self._cbytes
        n = (mv.nbytes + cb - 1) // cb
        out: List[Optional[bytes]] = [None] * n
        c = self._codec

        def job(i: int) -> None:
            a = i * cb
            b = min(a + cb, mv.nbytes)
            p = c.compress(mv[a:b])
            # the store codec returns a view into our (mutable, soon-recycled)
            # staging buffer — detach it
            out[i] = p if isinstance(p, bytes) else bytes(p)

        engine.run_tasks([(lambda i=i: job(i)) for i in range(n)])
        for i, p in enumerate(out):
            self._raw_offs.append(self._raw_consumed)
            self._raw_consumed += min(cb, mv.nbytes - i * cb)
            self._lens.append(len(p))
            self._crcs.append(zlib.crc32(p))
        return out  # type: ignore[return-value]

    def feed(self, data) -> List[bytes]:
        """Consume a piece of raw payload; returns the stored parts of every
        chunk completed by it (append them to the file in order)."""
        mv = data if isinstance(data, memoryview) else memoryview(data)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        if self._stats_acc is not None:
            self._stats_acc.feed(mv)
        parts: List[bytes] = []
        cb = self._cbytes
        if not self._buf and mv.nbytes >= cb:
            # fast path: full chunks compress straight out of the caller's
            # buffer, no staging copy
            nfull = (mv.nbytes // cb) * cb
            parts += self._compress(mv[:nfull])
            mv = mv[nfull:]
        if mv.nbytes:
            self._buf += mv
            if len(self._buf) >= cb:
                nfull = (len(self._buf) // cb) * cb
                staged = memoryview(self._buf)[:nfull]
                parts += self._compress(staged)
                staged.release()
                del self._buf[:nfull]
        return parts

    def flush(self) -> List[bytes]:
        """Compress the final short chunk (if any buffered bytes remain)."""
        if not self._buf:
            return []
        staged = memoryview(self._buf)
        parts = self._compress(staged)
        staged.release()
        self._buf = bytearray()
        return parts

    def table(self) -> ChunkTable:
        """The trailer chunk table for everything fed so far (call after
        ``flush``)."""
        n = len(self._lens)
        lens = np.array(self._lens, dtype="<u8")
        stored = np.zeros(n, dtype="<u8")
        if n:
            stored[1:] = np.cumsum(lens)[:-1]
        return ChunkTable(
            codec_id=self._codec.codec_id,
            chunk_bytes=self._cbytes,
            raw_offsets=np.array(self._raw_offs, dtype="<u8"),
            stored_offsets=stored,
            stored_lens=lens,
            crcs=np.array(self._crcs, dtype="<u8"),
        )

    def chunk_stats(self):
        """The accumulated per-chunk statistics (DESIGN.md §16), or ``None``
        when the compressor was built without ``stats_dtype``. Call after
        ``flush`` so the final short chunk is included."""
        if self._stats_acc is None:
            return None
        return self._stats_acc.finish()


# ------------------------------------------------------------------- decode
def _src_size(src) -> Optional[int]:
    """Total byte size of a positioned-read source when cheaply knowable
    (fstat for fds, ``.size`` for remote readers)."""
    if isinstance(src, int):
        try:
            return os.fstat(src).st_size
        except OSError:
            return None
    size = getattr(src, "size", None)
    return size if isinstance(size, int) else None


def table_nbytes(src, hdr) -> int:
    """Encoded table size of a chunked file without parsing the entries —
    one 32-byte positioned read of the table head (``src`` is an int fd or
    any ``engine.pread_into`` source, e.g. a ``RemoteReader``)."""
    base = hdr.nbytes + hdr.data_length
    head = bytearray(TABLE_HEAD_BYTES)
    engine.pread_into(src, base, head)
    magic, _, _, n = TABLE_HEAD.unpack(bytes(head))
    if magic != CHUNK_MAGIC:
        raise RawArrayError("chunked flag set but chunk table magic missing")
    if n > max(1, hdr.logical_nbytes):
        raise RawArrayError(
            f"chunk table claims {n} chunks for a {hdr.logical_nbytes}-byte payload"
        )
    # bound by the bytes actually present: a corrupted count must fail fast,
    # not allocate gigabytes before discovering the entries aren't there
    size = _src_size(src)
    if size is not None and TABLE_HEAD_BYTES + ENTRY_BYTES * n > size - base:
        raise RawArrayError(
            f"truncated chunk table: {n} chunks need "
            f"{TABLE_HEAD_BYTES + ENTRY_BYTES * n} bytes, file has {max(0, size - base)}"
        )
    return TABLE_HEAD_BYTES + ENTRY_BYTES * n


def read_table(src, hdr) -> ChunkTable:
    """Read + validate the chunk table of a chunked file: two small
    positioned reads (head, then entries), so a remote source costs at most
    two ranged GETs — never the payload."""
    base = hdr.nbytes + hdr.data_length
    size = table_nbytes(src, hdr)
    buf = bytearray(size)
    try:
        engine.pread_into(src, base, buf)
    except RawArrayError as e:
        raise RawArrayError(f"truncated chunk table: {e}") from None
    return ChunkTable.decode(
        bytes(buf), logical_nbytes=hdr.logical_nbytes, stored_nbytes=hdr.data_length
    )


def _decode_chunk(src, hdr, table: ChunkTable, c: Codec, i: int):
    """Fetch + CRC-check + decompress chunk ``i``. Returns the raw
    bytes-like payload (NB: the store codec returns a fresh bytes copy so
    the result never aliases recycled scratch)."""
    rlen = table.raw_len(i, hdr.logical_nbytes)
    so = int(table.stored_offsets[i])
    slen = int(table.stored_lens[i])
    scratch = engine.acquire_scratch(slen)
    try:
        stored = memoryview(scratch)[:slen]
        engine.pread_into(src, hdr.nbytes + so, stored)
        if zlib.crc32(stored) != int(table.crcs[i]):
            raise RawArrayError(f"chunk {i} CRC32 mismatch: stored bytes corrupted")
        raw = c.decompress(stored)
        if raw is stored:  # store codec: detach from scratch before recycling
            raw = bytes(stored)
    finally:
        engine.release_scratch(scratch)
    if len(raw) != rlen:
        raise RawArrayError(
            f"chunk {i} decompressed to {len(raw)} bytes, table wants {rlen}"
        )
    _count(slen, rlen)
    return raw


def chunk_read_tasks(
    src,
    hdr,
    table: ChunkTable,
    raw_start: int,
    raw_stop: int,
    dst,
) -> List[Callable[[], None]]:
    """Plan a partial decode: one zero-arg task per chunk overlapping the
    logical byte range [raw_start, raw_stop), each fetching the stored chunk
    (positioned read on ``src`` — fd or remote reader), verifying its CRC32,
    decompressing, and copying the overlapping part into ``dst`` (a writable
    byte view of exactly ``raw_stop - raw_start`` bytes). Run them with
    ``engine.run_tasks`` — possibly merged with other shards' tasks into one
    wave."""
    mv = dst if isinstance(dst, memoryview) else memoryview(dst)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if mv.nbytes != raw_stop - raw_start:
        raise RawArrayError(
            f"chunk decode: dst holds {mv.nbytes} bytes for range "
            f"[{raw_start}, {raw_stop})"
        )
    c = get_codec(table.codec_id)
    logical = hdr.logical_nbytes

    def job(i: int) -> None:
        raw = _decode_chunk(src, hdr, table, c, i)
        ro = int(table.raw_offsets[i])
        rlen = table.raw_len(i, logical)
        a, b = max(raw_start, ro), min(raw_stop, ro + rlen)
        mv[a - raw_start : b - raw_start] = memoryview(raw)[a - ro : b - ro]

    return [
        (lambda i=i: job(i))
        for i in table.overlapping(raw_start, raw_stop, logical)
    ]


def decompress_into(src, hdr, table: ChunkTable, dst) -> None:
    """Full parallel decode of a chunked payload into ``dst`` (a writable
    byte view of ``hdr.logical_nbytes`` bytes): one engine wave, each task
    fetch+verify+decompress of one chunk."""
    engine.run_tasks(chunk_read_tasks(src, hdr, table, 0, hdr.logical_nbytes, dst))


def gather_rows_tasks(
    src,
    hdr,
    table: ChunkTable,
    row_nbytes: int,
    rows: np.ndarray,
    positions: np.ndarray,
    dst,
) -> List[Callable[[], None]]:
    """Plan a scattered row gather over a chunked payload: decode each
    needed chunk EXACTLY ONCE, scattering every requested row (or the part
    of it the chunk covers — rows may straddle chunk boundaries) into
    ``dst`` at ``positions[k] * row_nbytes``. Without this, per-run chunk
    decodes re-decompress the same chunk once per sparse row — O(batch)
    decompressions of O(chunk) bytes each.

    ``rows`` are local row indices (any order, duplicates fine),
    ``positions[k]`` the destination row slot for ``rows[k]``, ``dst`` a
    writable byte view with row ``p`` at ``[p*row_nbytes, (p+1)*row_nbytes)``.
    """
    mv = dst if isinstance(dst, memoryview) else memoryview(dst)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if row_nbytes == 0 or len(rows) == 0:
        return []
    c = get_codec(table.codec_id)
    logical = hdr.logical_nbytes
    starts = np.asarray(rows, dtype=np.int64) * row_nbytes
    pos = np.asarray(positions, dtype=np.int64)
    # chunk span of each row: raw_offsets is sorted, rows may straddle
    c0 = np.searchsorted(table.raw_offsets, starts, side="right") - 1
    c1 = np.searchsorted(table.raw_offsets, starts + row_nbytes, side="left")
    by_chunk: Dict[int, List[int]] = {}
    for k in range(len(starts)):
        for ci in range(int(c0[k]), int(c1[k])):
            by_chunk.setdefault(ci, []).append(k)

    def job(ci: int, ks: List[int]) -> None:
        raw = _decode_chunk(src, hdr, table, c, ci)
        ro = int(table.raw_offsets[ci])
        rend = ro + table.raw_len(ci, logical)
        rawmv = memoryview(raw)
        for k in ks:
            a = max(ro, int(starts[k]))
            b = min(rend, int(starts[k]) + row_nbytes)
            d0 = int(pos[k]) * row_nbytes + (a - int(starts[k]))
            mv[d0 : d0 + (b - a)] = rawmv[a - ro : b - ro]

    return [(lambda ci=ci, ks=ks: job(ci, ks)) for ci, ks in by_chunk.items()]

"""RawArray read / write / memory-map.

Faithful to the paper: ``write`` emits header ++ raw bytes (++ optional
metadata); ``read`` parses the numeric header and hands back an ndarray;
``memmap`` maps the data segment directly (the format's linear up-front
layout makes this a single ``np.memmap`` with a computed offset).

Beyond-paper (flag-gated, backward compatible, DESIGN.md §7): optional CRC32
trailer, whole-file zlib payload compression, and — the fast compression
path — chunked compression (DESIGN.md §10): independently compressed chunks
plus a trailer chunk table, decoded chunk-parallel on the engine pool, with
partial reads touching only the chunks that overlap the request.

Large payloads (>= ``RA_IO_PARALLEL_MIN``) are read and written through the
slab-parallel engine (``repro_torch.core.engine``, DESIGN.md §8); ``read_into``
streams a file into a caller-owned preallocated array with zero intermediate
copies.

Every read-side entry point also accepts ``http(s)://`` URLs and dispatches
to the remote data plane (``repro_torch.remote``, DESIGN.md §9): the same header
decode and engine-planned slab reads, issued as parallel byte-range
requests. The URL may just as well point at a ``repro_torch.fleet`` router
(DESIGN.md §14) — the consistent-hash edge tier speaks the same
byte-range dialect and serves the origin's ETag, so slab, span, and
gather waves run unchanged through the proxy.

The streaming ingest plane (DESIGN.md §11): ``RaWriter`` writes a file
incrementally — unknown leading dimension, row batches, chunk-parallel
compression as batches arrive, crash-safe temp-file + rename publish.
``write`` also accepts an ``http(s)://`` destination (one authenticated
PUT, server-side atomic publish); ``repro_torch.remote.RemoteWriter`` is the
streaming equivalent. ``memmap``/``memmap_slice``/``append_metadata``
remain local-only and refuse URLs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import codec as chunked_codec
from . import engine
from . import quant as quant_schema
from . import stats as stats_mod
from .header import Header, decode_header, read_header
from .spec import (
    FLAG_BIG_ENDIAN,
    FLAG_CHUNKED,
    FLAG_CRC32_TRAILER,
    FLAG_ZLIB,
    RawArrayError,
)

PathLike = Union[str, os.PathLike]

# Buffered single-syscall-ish writes: header+data concatenated when small,
# else two writes. Keeps the hot path syscall count minimal (paper's "Fast").
_SMALL = 1 << 20


def is_url(path: object) -> bool:
    """True for ``http(s)://`` paths served by the remote data plane."""
    return isinstance(path, str) and path.startswith(("http://", "https://"))


def join_path(base: str, name: str) -> str:
    """``os.path.join`` that also speaks URLs — the one helper every
    directory-shaped layout (sharded stores, datasets, checkpoints) uses to
    address its member files in both local and remote mode."""
    if is_url(base):
        from urllib.parse import quote

        return base.rstrip("/") + "/" + quote(name)
    return os.path.join(base, name)


def _remote():
    # deferred: repro_torch.remote imports this module; function-local import
    # breaks the cycle and keeps purely-local workloads free of it
    from .. import remote

    return remote


def _reject_url(path: PathLike, op: str) -> None:
    if is_url(path):
        raise RawArrayError(f"{op} is local-only; cannot {op} a remote URL: {path}")


def _as_bytes_view(arr: np.ndarray) -> memoryview:
    """Zero-copy byte view of a contiguous array; copies only for dtypes that
    don't speak the buffer protocol (e.g. ml_dtypes bfloat16)."""
    if not arr.size:
        return memoryview(b"")
    try:
        return memoryview(arr).cast("B")
    except (ValueError, TypeError):
        return memoryview(arr.view(np.uint8).reshape(-1))


def write(
    path: PathLike,
    arr: np.ndarray,
    *,
    metadata: Optional[bytes] = None,
    big_endian: bool = False,
    crc32: bool = False,
    compress: bool = False,
    chunked: bool = False,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    quantize: Optional[str] = None,
    stats: bool = False,
    eltype: Optional[int] = None,
) -> int:
    """Write ``arr`` as a RawArray file. Returns bytes written.

    ``eltype`` overrides the header's element kind for the bits ``arr``
    holds: ``ELTYPE_BRAIN`` stores bfloat16 patterns held as uint16, so the
    file names bfloat16 without ``ml_dtypes``.

    ``stats=True`` (DESIGN.md §16) additionally emits a ``rastats``
    block — per-chunk min/max/NaN-count/count — at the head of the
    trailing metadata region, enabling predicate pushdown
    (``RaDataset.select``) to prune chunks without touching the payload.
    Requires a bool/int/float dtype; for quantized files the statistics
    describe the STORED uint8 codes.

    ``quantize="u8"`` (DESIGN.md §12) stores a float array as uint8 codes
    with per-channel affine calibration over the last axis; the
    ``(scale, bias, orig_dtype)`` schema rides in the trailing user
    metadata (the paper's extension point), so ``read(..., dequantize=
    True)`` — or the on-device CUDA kernel — reconstructs the logical
    values while the wire/disk payload is 4× smaller than float32.
    A caller-supplied ``metadata`` must then be a JSON object (bytes or
    dict) for the quant schema to merge into.

    ``compress=True`` keeps the legacy whole-file zlib payload
    (``FLAG_ZLIB``: single-stream decode, no partial reads). ``chunked=True``
    — or simply passing ``codec=`` / ``chunk_bytes=`` — writes the payload as
    independently compressed chunks plus a trailer chunk table
    (``FLAG_CHUNKED``, DESIGN.md §10): compression runs chunk-parallel on
    the engine pool here, and every read path decodes only the chunks it
    needs. Defaults: codec ``RA_CODEC`` (zlib), chunk size ``RA_CHUNK_BYTES``
    (1 MiB).

    ``path`` may be an ``http(s)://`` URL of a write-enabled byte-range
    server (DESIGN.md §11): the identical bytes are shipped as ONE
    authenticated PUT with server-side atomic publish (token knob
    ``RA_REMOTE_TOKEN``). Incremental / unknown-length writes go through
    ``RaWriter`` (local) or ``repro_torch.remote.RemoteWriter`` (URL) instead."""
    chunked = chunked or codec is not None or chunk_bytes is not None
    if compress and chunked:
        raise RawArrayError(
            "compress= (whole-file zlib) and chunked= are mutually exclusive"
        )
    if quantize is not None:
        if big_endian:
            raise RawArrayError("quantize= writes little-endian uint8 payloads only")
        info = quant_schema.quant_params(np.asarray(arr), mode=quantize)
        extra = None
        if metadata:
            if isinstance(metadata, dict):
                extra = metadata
            else:
                try:
                    extra = json.loads(metadata)
                except (TypeError, ValueError, UnicodeDecodeError):
                    extra = None
            if not isinstance(extra, dict):
                raise RawArrayError(
                    "quantize= stores its schema in JSON metadata; a "
                    "caller-supplied metadata blob must be a JSON object "
                    "(bytes or dict)"
                )
        arr = info.quantize(np.asarray(arr))
        metadata = info.encode(extra)
    orig_shape = np.asarray(arr).shape
    arr = np.ascontiguousarray(arr)  # NB: promotes 0-d to (1,)...
    arr = arr.reshape(orig_shape)    # ...so restore the true rank (ndims=0 is legal)
    flags = 0
    if big_endian:
        flags |= FLAG_BIG_ENDIAN
        arr = arr.astype(arr.dtype.newbyteorder(">"), copy=False)
    else:
        # normalize to little-endian on disk
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    payload = _as_bytes_view(arr)
    trailer_views: list = []  # chunk table, between payload and metadata
    table = None
    if chunked:
        flags |= FLAG_CHUNKED
        parts, table = chunked_codec.compress_chunked(
            payload, codec=codec, chunk_bytes=chunk_bytes
        )
        stored_views = [memoryview(p) for p in parts]
        trailer_views = [memoryview(table.encode())]
    elif compress:
        flags |= FLAG_ZLIB
        stored_views = [memoryview(zlib.compress(bytes(payload), level=1))]
    else:
        stored_views = [payload]
    if stats:
        if not stats_mod.stats_supported(arr.dtype):
            raise RawArrayError(f"stats=True unsupported for dtype {arr.dtype}")
        scb = table.chunk_bytes if table is not None \
            else chunked_codec.default_chunk_bytes()
        trailer_views.append(
            memoryview(stats_mod.compute_stats(arr, scb).encode()))
    if crc32:
        flags |= FLAG_CRC32_TRAILER
    data_length = sum(v.nbytes for v in stored_views)
    hdr = Header.for_array(arr, flags=flags, data_length=data_length)
    if eltype is not None:
        hdr = dataclasses.replace(hdr, eltype=eltype)
    views = [memoryview(hdr.encode())] + stored_views + trailer_views
    if metadata:
        views.append(memoryview(metadata))
    if crc32:
        # file-level CRC of the stored data segment, always the last 4 bytes
        crc = 0
        for v in stored_views:
            crc = zlib.crc32(v, crc)
        views.append(memoryview(crc.to_bytes(4, "little")))
    total = sum(v.nbytes for v in views)
    if is_url(path):
        return _remote().upload_bytes(path, views)
    with open(os.fspath(path), "wb") as f:
        if total < _SMALL:
            buf = bytearray()
            for v in views:
                buf += v
            f.write(buf)
            return total
        os.ftruncate(f.fileno(), total)  # preallocate, then go wide (DESIGN.md §8)
        return engine.parallel_write(f.fileno(), 0, views)


class _FileSink:
    """Crash-safe local byte sink for ``RaWriter`` (DESIGN.md §11).

    Every byte lands in a hidden same-directory temp file; ``commit`` fsyncs
    and atomically renames it into place, so a crash at ANY point of a
    streamed write leaves no partial file visible under the final name.
    ``patch`` rewrites earlier bytes (the finalize header patch); ``abort``
    removes the temp file.
    """

    def __init__(self, path: PathLike):
        self.path = os.fspath(path)
        _reject_url(self.path, "RaWriter")  # URLs go through remote.RemoteWriter
        self._dir = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path)
        self.tmp = os.path.join(
            self._dir, f".{base}.tmp-{os.getpid()}-{id(self) & 0xFFFF:04x}"
        )
        self.fd = os.open(self.tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o666)
        self.size = 0

    def append(self, views: Sequence[object]) -> int:
        total = 0
        for v in views:
            mv = v if isinstance(v, memoryview) else memoryview(v)
            total += mv.nbytes
        if total >= engine.parallel_min():
            # preallocate the extension, then go slab-parallel (DESIGN.md §8)
            os.ftruncate(self.fd, self.size + total)
            engine.parallel_write(self.fd, self.size, views)
        else:
            pos = self.size
            for v in views:
                pos += engine.pwrite_from(self.fd, pos, v)
        self.size += total
        return total

    def patch(self, offset: int, data) -> None:
        engine.pwrite_from(self.fd, offset, data)

    def commit(self) -> None:
        os.fsync(self.fd)
        os.close(self.fd)
        self.fd = -1
        os.replace(self.tmp, self.path)
        try:  # make the rename itself durable (same contract as checkpoints)
            dfd = os.open(self._dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # directory fsync is best-effort (e.g. some network FS)

    def abort(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
        try:
            os.unlink(self.tmp)
        except OSError:
            pass


# Plain-payload writes buffer small row batches and flush in slabs of this
# many bytes, so a row-at-a-time ingest still writes in large sequential I/O.
_WRITER_BUF = 4 << 20


class RaWriter:
    """Incremental RawArray writer: the streaming ingest plane (DESIGN.md §11).

    Opens with an UNKNOWN leading dimension, accepts row batches of shape
    ``(n, *row_shape)`` via ``write_rows``, and on ``finalize`` patches
    ``dims[0]`` / ``data_length`` into the header, emits the chunk table
    (chunked mode), optional user metadata and optional CRC32 trailer, then
    atomically publishes the file (write-to-temp + rename) — a crash mid-
    stream leaves no partial file visible.

    The output is byte-identical to a monolithic ``write()`` of the same
    array for every supported flag combination: plain, ``crc32=True``, and
    ``chunked=True`` with any registered codec (chunk compression runs
    chunk-parallel on the engine pool AS BATCHES ARRIVE, so compression
    overlaps ingest). Whole-file zlib (``compress=``) is not streamable —
    use ``chunked`` (DESIGN.md §10).

    ``sink`` is the byte-sink escape hatch the remote plane plugs into
    (``repro_torch.remote.RemoteWriter`` streams the same bytes as authenticated
    PUT appends); local callers never pass it.

    Usage::

        with RaWriter("out.ra", np.float32, (256,), chunked=True) as w:
            for batch in batches:          # (n, 256) float32 each
                w.write_rows(batch)
        # or explicitly: hdr = w.finalize(metadata=b"...")
    """

    def __init__(
        self,
        path: PathLike,
        dtype,
        row_shape: Tuple[int, ...] = (),
        *,
        crc32: bool = False,
        chunked: bool = False,
        codec: Optional[str] = None,
        chunk_bytes: Optional[int] = None,
        metadata: Optional[bytes] = None,
        stats: bool = False,
        sink=None,
    ):
        chunked = chunked or codec is not None or chunk_bytes is not None
        dt = np.dtype(dtype)
        if dt.byteorder == ">":
            raise RawArrayError("RaWriter writes little-endian files only")
        if stats and not stats_mod.stats_supported(dt):
            raise RawArrayError(f"stats=True unsupported for dtype {dt}")
        self._dtype = dt
        self._row_shape = tuple(int(d) for d in row_shape)
        self._row_nbytes = dt.itemsize
        for d in self._row_shape:
            self._row_nbytes *= d
        self._flags = 0
        if crc32:
            self._flags |= FLAG_CRC32_TRAILER
        if chunked:
            self._flags |= FLAG_CHUNKED
        self._crc32 = crc32
        self._metadata = metadata
        # prototype header (dims[0]=0, data_length=0): placeholder bytes now,
        # patched with the real values at finalize — the header size is fixed
        # because ndims is known up front
        proto = np.empty((0,) + self._row_shape, dtype=dt)
        self._hdr0 = Header.for_array(proto, flags=self._flags, data_length=0)
        self._compressor = (
            chunked_codec.ChunkStreamCompressor(
                codec=codec, chunk_bytes=chunk_bytes,
                stats_dtype=dt if stats else None,
            )
            if chunked
            else None
        )
        # plain mode computes stats itself (write_rows); chunked mode lets
        # the stream compressor accumulate them as chunks form (DESIGN.md §16)
        self._stats_acc = (
            stats_mod.StatsAccumulator(dt, chunked_codec.default_chunk_bytes())
            if stats and not chunked
            else None
        )
        self._buf = bytearray()  # plain mode: pending raw bytes, flushed in slabs
        self._rows = 0
        self._payload_nbytes = 0  # stored bytes appended so far
        self._crc = 0
        self._state = "open"
        self._sink = _FileSink(path) if sink is None else sink
        self._sink.append([memoryview(self._hdr0.encode())])

    # ---- introspection -----------------------------------------------------
    @property
    def rows(self) -> int:
        """Rows written so far (the eventual ``dims[0]``)."""
        return self._rows

    @property
    def stored_nbytes(self) -> int:
        """Stored payload bytes appended to the sink so far (compressed size
        in chunked mode; excludes buffered not-yet-flushed bytes)."""
        return self._payload_nbytes

    # ---- write path --------------------------------------------------------
    def _append_payload(self, view) -> None:
        """Append stored payload bytes, folding them into the file-level CRC
        (which covers the STORED data segment, exactly like ``write()``)."""
        if self._crc32:
            self._crc = zlib.crc32(view, self._crc)
        self._sink.append([view])
        mv = view if isinstance(view, memoryview) else memoryview(view)
        self._payload_nbytes += mv.nbytes

    def write_rows(self, rows) -> int:
        """Append a batch shaped ``(n, *row_shape)``; returns total rows so
        far. Rows are cast to the writer's dtype (same semantics as the
        dataset writer) and must be batched — a single row is ``rows[None]``."""
        if self._state != "open":
            raise RawArrayError(f"write_rows on a {self._state} RaWriter")
        a = np.asarray(rows)
        if a.shape[1:] != self._row_shape:
            raise RawArrayError(
                f"write_rows: batch row shape {a.shape[1:]} != writer row "
                f"shape {self._row_shape}"
            )
        a = np.ascontiguousarray(a.astype(self._dtype, copy=False))
        n = a.shape[0]
        if n == 0 or self._row_nbytes == 0:
            self._rows += n
            return self._rows
        view = _as_bytes_view(a)
        if self._stats_acc is not None:
            self._stats_acc.add(a)
        if self._compressor is not None:
            for part in self._compressor.feed(view):
                self._append_payload(part)
        elif view.nbytes >= _WRITER_BUF:
            # large batch: flush any buffered tail, then write the caller's
            # bytes straight through — never stage a big batch in the buffer
            if self._buf:
                self._append_payload(memoryview(self._buf))
                self._buf = bytearray()
            self._append_payload(view)
        else:
            self._buf += view
            if len(self._buf) >= _WRITER_BUF:
                self._append_payload(memoryview(self._buf))
                self._buf = bytearray()
        self._rows += n
        return self._rows

    # ---- lifecycle ---------------------------------------------------------
    def finalize(self, metadata: Optional[bytes] = None) -> Header:
        """Flush everything, emit trailers, patch the header, publish.

        Order (DESIGN.md §11): final short chunk → chunk table → ``rastats``
        block (``stats=True``, DESIGN.md §16) → metadata →
        CRC trailer → header patch (``dims[0]``, ``data_length``) → durable
        commit (fsync + atomic rename). Returns the final ``Header``.
        Calling it twice — or after ``abort`` — raises."""
        if self._state != "open":
            raise RawArrayError(f"finalize on a {self._state} RaWriter")
        meta = self._metadata if metadata is None else metadata
        if self._buf:
            self._append_payload(memoryview(self._buf))
            self._buf = bytearray()
        tail: List[memoryview] = []
        stats_block = None
        if self._compressor is not None:
            for part in self._compressor.flush():
                self._append_payload(part)
            tail.append(memoryview(self._compressor.table().encode()))
            cstats = self._compressor.chunk_stats()
            if cstats is not None:
                stats_block = cstats.encode()
        elif self._stats_acc is not None:
            stats_block = self._stats_acc.finish().encode()
        if stats_block is not None:
            tail.append(memoryview(stats_block))
        if meta:
            tail.append(memoryview(meta))
        if self._crc32:
            tail.append(memoryview(self._crc.to_bytes(4, "little")))
        if tail:
            self._sink.append(tail)
        hdr = Header(
            flags=self._flags,
            eltype=self._hdr0.eltype,
            elbyte=self._hdr0.elbyte,
            data_length=self._payload_nbytes,
            shape=(self._rows,) + self._row_shape,
        )
        self._sink.patch(0, memoryview(hdr.encode()))
        self._sink.commit()
        self._state = "finalized"
        return hdr

    def abort(self) -> None:
        """Drop the in-progress write: the temp file (or remote ``.part``)
        is deleted and the final path is never touched. Idempotent; a
        finalized writer cannot be aborted."""
        if self._state == "open":
            self._state = "aborted"
            self._sink.abort()

    def __enter__(self) -> "RaWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        elif self._state == "open":
            self.finalize()

    def __del__(self):  # a dropped writer must not leak its fd / temp file
        try:
            self.abort()
        except Exception:
            pass


def read(
    path: PathLike,
    *,
    with_metadata: bool = False,
    strict_flags: bool = True,
    dequantize: bool = False,
) -> Union[np.ndarray, Tuple[np.ndarray, bytes]]:
    """Read a RawArray file into an ndarray (native little-endian in memory).

    Fast path: plain little-endian payload with no trailer reads the header
    from one small syscall and ``readinto``s the payload DIRECTLY into the
    output array (zero intermediate copy — what the C reference does with
    fread into malloc'd memory).

    ``dequantize=True`` reconstructs the logical float values of a file
    written with ``quantize=`` (DESIGN.md §12) from its uint8 codes and the
    typed quant metadata; files without quant metadata pass through
    unchanged."""
    if dequantize:
        arr, meta = read(path, with_metadata=True, strict_flags=strict_flags)
        info = quant_schema.decode_quant_metadata(meta)
        if info is not None:
            arr = info.dequantize(arr)
        return (arr, meta) if with_metadata else arr
    if is_url(path):
        return _remote().remote_read(
            path, with_metadata=with_metadata, strict_flags=strict_flags
        )
    with open(path, "rb", buffering=0) as f:
        head = f.read(4096)
        hdr = decode_header(head, strict_flags=strict_flags)
        if hdr.flags & FLAG_CHUNKED:
            return read_chunked(
                f.fileno(), hdr,
                size=os.fstat(f.fileno()).st_size,
                with_metadata=with_metadata,
            )
        if hdr.plain and not with_metadata:
            out = np.empty(hdr.shape, dtype=hdr.dtype())
            if hdr.data_length == 0:
                return out
            mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
            if hdr.data_length >= engine.parallel_min():
                # big payload: slab-parallel preads straight into the output
                engine.parallel_read_into(f.fileno(), hdr.nbytes, mv)
                return out
            inline = head[hdr.nbytes : hdr.nbytes + hdr.data_length]
            mv[: len(inline)] = inline
            got = len(inline)
            while got < hdr.data_length:
                n = f.readinto(mv[got:])
                if not n:
                    raise RawArrayError(
                        f"truncated data segment: wanted {hdr.data_length}, got {got}"
                    )
                got += n
            return out
        rest = f.read()
        blob = head + rest
        payload = blob[hdr.nbytes : hdr.nbytes + hdr.data_length]
        if len(payload) != hdr.data_length:
            raise RawArrayError(
                f"truncated data segment: wanted {hdr.data_length}, got {len(payload)}"
            )
        trailer = blob[hdr.nbytes + hdr.data_length :]
    meta = trailer
    if hdr.flags & FLAG_CRC32_TRAILER:
        if len(trailer) < 4:
            raise RawArrayError("CRC flag set but trailer missing")
        meta, crc = trailer[:-4], int.from_bytes(trailer[-4:], "little")
        if zlib.crc32(payload) != crc:
            raise RawArrayError("CRC32 mismatch: data segment corrupted")
    if hdr.flags & FLAG_ZLIB:
        payload = zlib.decompress(payload)
        if len(payload) != hdr.logical_nbytes:
            raise RawArrayError(
                f"decompressed payload is {len(payload)} bytes, header shape "
                f"{hdr.shape} x elbyte={hdr.elbyte} wants {hdr.logical_nbytes}"
            )
    dtype = hdr.dtype()
    arr = np.frombuffer(payload, dtype=dtype)
    if hdr.big_endian:
        arr = arr.astype(dtype.newbyteorder("<"))
    arr = arr.reshape(hdr.shape)
    if with_metadata:
        # the rastats block rides at the head of the metadata region; user
        # metadata is what follows it (DESIGN.md §16)
        return arr, stats_mod.split_stats(meta)[1]
    return arr


def read_chunked(
    src,
    hdr: Header,
    *,
    size: int,
    with_metadata: bool = False,
) -> Union[np.ndarray, Tuple[np.ndarray, bytes]]:
    """Decode a ``FLAG_CHUNKED`` payload from any positioned-read source
    (int fd or ``RemoteReader``): read the trailer chunk table (two small
    reads), then fetch + CRC-check + decompress every chunk concurrently on
    the engine pool, each straight into its slice of the output array.

    Integrity comes from the per-chunk CRC32s (checked on every decode);
    the optional file-level CRC trailer is rechecked by ``racat verify``."""
    table = chunked_codec.read_table(src, hdr)
    out = np.empty(hdr.shape, hdr.dtype())
    if hdr.logical_nbytes:
        mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
        chunked_codec.decompress_into(src, hdr, table, mv)
    if hdr.big_endian:
        out = out.astype(hdr.dtype().newbyteorder("<"))
    if not with_metadata:
        return out
    start = hdr.nbytes + hdr.data_length + table.nbytes
    tail = bytearray(max(0, size - start))
    if tail:
        engine.pread_into(src, start, tail)
    meta = bytes(tail)
    if hdr.flags & FLAG_CRC32_TRAILER:
        if len(meta) < 4:
            raise RawArrayError("CRC flag set but trailer missing")
        meta = meta[:-4]
    return out, stats_mod.split_stats(meta)[1]


def _zlib_decompress_into(fd: int, hdr: Header, mv: memoryview, file_size: int) -> None:
    """Stream-decompress a whole-file zlib payload directly into the
    caller's buffer (no intermediate payload-sized allocation), verifying
    the file-level CRC trailer incrementally when present."""
    d = zlib.decompressobj()
    off, end = hdr.nbytes, hdr.nbytes + hdr.data_length
    pos = 0
    crc = 0
    buf = bytearray(min(1 << 20, max(1, hdr.data_length)))
    while off < end:
        n = min(len(buf), end - off)
        piece = memoryview(buf)[:n]
        engine.pread_into(fd, off, piece)
        off += n
        if hdr.flags & FLAG_CRC32_TRAILER:
            crc = zlib.crc32(piece, crc)
        raw = d.decompress(piece)
        if pos + len(raw) > mv.nbytes:
            raise RawArrayError(
                f"decompressed payload exceeds {mv.nbytes} bytes, header shape "
                f"{hdr.shape} x elbyte={hdr.elbyte}"
            )
        mv[pos : pos + len(raw)] = raw
        pos += len(raw)
    raw = d.flush()
    if pos + len(raw) > mv.nbytes:
        raise RawArrayError(
            f"decompressed payload exceeds {mv.nbytes} bytes, header shape "
            f"{hdr.shape} x elbyte={hdr.elbyte}"
        )
    mv[pos : pos + len(raw)] = raw
    pos += len(raw)
    if pos != hdr.logical_nbytes:
        raise RawArrayError(
            f"decompressed payload is {pos} bytes, header shape "
            f"{hdr.shape} x elbyte={hdr.elbyte} wants {hdr.logical_nbytes}"
        )
    if hdr.flags & FLAG_CRC32_TRAILER:
        if file_size < end + 4:
            raise RawArrayError("CRC flag set but trailer missing")
        stored = bytearray(4)
        engine.pread_into(fd, file_size - 4, stored)
        if int.from_bytes(stored, "little") != crc:
            raise RawArrayError("CRC32 mismatch: data segment corrupted")


def read_into(path: PathLike, out: np.ndarray) -> np.ndarray:
    """Read a RawArray file's payload straight into a preallocated array.

    ``out`` must be C-contiguous with the file's exact shape and dtype. This
    is the zero-copy restore primitive (DESIGN.md §8): the destination can be
    a reused (already page-faulted) buffer, a pinned host buffer, or one slab
    of a larger batch array — no intermediate allocation is made, and large
    payloads are read with slab-parallel preads.

    Compressed payloads honor ``out=`` too: chunked files decompress
    chunk-parallel straight into the caller's buffer, whole-file zlib
    streams through ``decompressobj`` into it. Only big-endian payloads
    fall back to ``read`` + one converting copy.
    """
    if is_url(path):
        return _remote().remote_read_into(path, out)
    with open(path, "rb", buffering=0) as f:
        head = f.read(4096)
        hdr = decode_header(head)
        if tuple(out.shape) != hdr.shape:
            raise RawArrayError(f"read_into: out.shape {out.shape} != file {hdr.shape}")
        # byte-order-insensitive: a big-endian payload lands in a native out
        # via the read() fallback below
        if out.dtype != hdr.dtype().newbyteorder("="):
            raise RawArrayError(f"read_into: out.dtype {out.dtype} != file {hdr.dtype()}")
        if not out.flags.c_contiguous:
            raise RawArrayError("read_into: out must be C-contiguous")
        if not hdr.big_endian:
            mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
            if hdr.flags & FLAG_CHUNKED:
                table = chunked_codec.read_table(f.fileno(), hdr)
                if hdr.logical_nbytes:
                    chunked_codec.decompress_into(f.fileno(), hdr, table, mv)
                return out
            if hdr.flags & FLAG_ZLIB:
                _zlib_decompress_into(
                    f.fileno(), hdr, mv, os.fstat(f.fileno()).st_size
                )
                return out
            if not (hdr.flags & FLAG_CRC32_TRAILER):
                if hdr.data_length:
                    engine.parallel_read_into(f.fileno(), hdr.nbytes, mv)
                return out
    out[...] = read(path)
    return out


def read_metadata(path: PathLike) -> bytes:
    """Read only the trailing user metadata (cheap: header + seek; for URLs
    a header fetch + one tail range request)."""
    if is_url(path):
        return _remote().remote_read_metadata(path)
    with open(path, "rb") as f:
        hdr = read_header(f)
        off = hdr.nbytes + hdr.data_length
        if hdr.flags & FLAG_CHUNKED:
            off += chunked_codec.table_nbytes(f.fileno(), hdr)
        f.seek(off)
        tail = f.read()
    if hdr.flags & FLAG_CRC32_TRAILER:
        tail = tail[:-4]
    return stats_mod.split_stats(tail)[1]


def _read_stats_src(src, hdr: Header, *, size: int,
                    table_nbytes: Optional[int] = None):
    """Decode the ``rastats`` block from a positioned-read source (int fd
    or ``RemoteReader``) with two small tail reads — the payload is never
    touched (DESIGN.md §16). Returns ``ChunkStats`` or ``None``."""
    if table_nbytes is None:
        table_nbytes = (
            chunked_codec.table_nbytes(src, hdr)
            if hdr.flags & FLAG_CHUNKED
            else 0
        )
    start = hdr.nbytes + hdr.data_length + table_nbytes
    end = size - (4 if hdr.flags & FLAG_CRC32_TRAILER else 0)
    avail = end - start
    if avail < stats_mod.HEAD_BYTES:
        return None
    head = bytearray(stats_mod.HEAD_BYTES)
    engine.pread_into(src, start, head)
    if not bytes(head).startswith(stats_mod.RASTATS_MAGIC_BYTES):
        return None
    block_bytes = int.from_bytes(head[16:24], "little")
    block = bytearray(min(max(block_bytes, stats_mod.HEAD_BYTES), avail))
    block[: len(head)] = head
    if len(block) > len(head):
        engine.pread_into(src, start + len(head), memoryview(block)[len(head):])
    return stats_mod.split_stats(bytes(block))[0]


def read_stats(path: PathLike):
    """Read only the per-chunk statistics block (DESIGN.md §16).

    Cheap for both local files (header + two tail reads) and
    ``http(s)://`` URLs (header fast path + tail ranges, never the
    payload). Returns :class:`repro_torch.core.stats.ChunkStats`, or ``None``
    for files without a (valid) ``rastats`` block — corrupt blocks warn
    and return ``None`` so callers degrade to a full scan."""
    if is_url(path):
        return _remote().remote_read_stats(path)
    with open(path, "rb") as f:
        hdr = read_header(f)
        return _read_stats_src(
            f.fileno(), hdr, size=os.fstat(f.fileno()).st_size
        )


def read_quant_metadata(path: PathLike):
    """Typed view of a file's quantization schema (DESIGN.md §12): the
    ``QuantInfo`` decoded from the trailing metadata, or ``None`` when the
    file carries no ``"ra_quant"`` schema. Works locally and over URLs
    (one header fetch + one tail range)."""
    return quant_schema.decode_quant_metadata(read_metadata(path))


def header_of(path: PathLike) -> Header:
    if is_url(path):
        return _remote().remote_header_of(path)
    with open(path, "rb") as f:
        return read_header(f)


def memmap(path: PathLike, mode: str = "r") -> np.ndarray:
    """Memory-map the data segment (zero-copy, the format's raison d'etre).

    Raises for compressed or big-endian payloads (not mappable in-place).
    """
    _reject_url(path, "memmap")
    with open(path, "rb") as f:
        hdr = read_header(f)
    if hdr.compressed:
        raise RawArrayError("cannot memory-map a compressed payload")
    if hdr.big_endian:
        raise RawArrayError("cannot memory-map a big-endian payload on LE host")
    if hdr.shape == ():  # np.memmap coerces 0-d to (1,); reshape it back
        m = np.memmap(path, dtype=hdr.dtype(), mode=mode, offset=hdr.nbytes, shape=(1,))
        return m.reshape(())
    return np.memmap(path, dtype=hdr.dtype(), mode=mode, offset=hdr.nbytes, shape=hdr.shape)


def memmap_slice(path: PathLike, start: int, stop: int, mode: str = "r") -> np.ndarray:
    """Map only rows [start, stop) of axis 0 — the multi-host shard read.

    Because the layout is linear with a fixed-size numeric header, the byte
    range of a row slab is pure offset arithmetic; each host touches only
    its pages.
    """
    _reject_url(path, "memmap")
    with open(path, "rb") as f:
        hdr = read_header(f)
    if hdr.compressed:
        raise RawArrayError("cannot memory-map a compressed payload")
    if not hdr.shape:
        raise RawArrayError("cannot row-slice a 0-d array")
    n = hdr.shape[0]
    start, stop = max(0, start), min(stop, n)
    if stop < start:
        raise RawArrayError(f"bad slice [{start}, {stop})")
    row = hdr.elbyte
    for d in hdr.shape[1:]:
        row *= d
    return np.memmap(
        path,
        dtype=hdr.dtype(),
        mode=mode,
        offset=hdr.nbytes + start * row,
        shape=(stop - start,) + hdr.shape[1:],
    )


def append_metadata(path: PathLike, metadata: bytes) -> None:
    """Append user metadata to an existing file (paper: 'can be anything').

    On a CRC-trailed file the 4-byte CRC must stay the *last* bytes of the
    file (that is where every reader splits metadata from checksum), so the
    metadata is spliced in front of it: naively appending after the trailer
    would make readers treat the tail of the new metadata as the checksum
    and fail — or worse, silently mis-verify."""
    _reject_url(path, "append_metadata")
    hdr = header_of(path)
    if not (hdr.flags & FLAG_CRC32_TRAILER):
        with open(path, "ab") as f:
            f.write(metadata)
        return
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < hdr.nbytes + hdr.data_length + 4:
            raise RawArrayError("CRC flag set but trailer missing")
        f.seek(size - 4)
        crc = f.read(4)
        f.seek(size - 4)
        # one write, not two: a crash between "overwrite CRC with metadata"
        # and "re-append CRC" would leave the file permanently mis-trailed
        f.write(bytes(metadata) + crc)


def write_like(path: PathLike, header: Header, payload: bytes) -> None:
    """Low-level escape hatch: write an explicit header + raw payload."""
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(payload)


def nbytes_on_disk(arr_or_shape: Any, dtype: Optional[np.dtype] = None) -> int:
    """Predict file size for an array (header + data, no metadata)."""
    if isinstance(arr_or_shape, np.ndarray):
        shape, itemsize = arr_or_shape.shape, arr_or_shape.dtype.itemsize
    else:
        shape, itemsize = tuple(arr_or_shape), np.dtype(dtype).itemsize
    n = itemsize
    for d in shape:
        n *= d
    return 48 + 8 * len(shape) + n

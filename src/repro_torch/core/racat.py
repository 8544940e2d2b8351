"""Command-line introspection for RawArray files (paper §3.2).

The paper demonstrates introspection with ``od``; this module is the
in-tree equivalent plus a self-test that our files *are* od-compatible::

    $ PYTHONPATH=src python -m repro_torch.core.racat header test.ra
    $ PYTHONPATH=src python -m repro_torch.core.racat data test.ra | head
    $ PYTHONPATH=src python -m repro_torch.core.racat od test.ra   # prints the od commands
    $ PYTHONPATH=src python -m repro_torch.core.racat verify test.ra  # integrity check
    $ PYTHONPATH=src python -m repro_torch.core.racat inspect test.ra # chunk table
    $ PYTHONPATH=src python -m repro_torch.core.racat compress in.ra out.ra --codec zlib

``header``, ``meta``, ``data``, ``inspect``, and ``verify`` also accept
``http(s)://`` URLs — introspection against a live byte-range server
(DESIGN.md §9) via the remote client, e.g. ``racat header
http://host:8742/train/x.ra``. Remote ``verify`` fetches the file exactly
ONCE and reuses that payload for every recheck (header, CRC, zlib, chunk
table) — never a header fast-path fetch plus a second full download.
``compress`` rewrites any RawArray file (local or URL source) as a
chunk-compressed one (DESIGN.md §10), preserving user metadata.
``ingest`` stream-concatenates ``.npy`` / ``.ra`` sources into one RawArray
file through the incremental writer (DESIGN.md §11) — the destination may
be a local path or the URL of a write-enabled server::

    $ PYTHONPATH=src python -m repro_torch.core.racat ingest out.ra a.npy b.ra
    $ ... racat ingest http://host:8742/out.ra a.npy --codec zlib
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import codec as chunked_codec
from . import io as raio
from . import stats as stats_mod
from .header import Header, decode_header
from .io import header_of, is_url, read, read_metadata
from .spec import (
    ELTYPE_NAMES,
    FLAG_CHUNKED,
    FLAG_CRC32_TRAILER,
    FLAG_ZLIB,
    RawArrayError,
)


def format_header(hdr: Header) -> str:
    notes = [
        name
        for bit, name in [
            (1, "big-endian"), (FLAG_CRC32_TRAILER, "crc32"),
            (FLAG_ZLIB, "zlib"), (FLAG_CHUNKED, "chunked"),
        ]
        if hdr.flags & bit
    ]
    lines = [
        f"magic        rawarray (0x7961727261776172)",
        f"flags        {hdr.flags:#x}"
        + (f" ({', '.join(notes)})" if notes else ""),
        f"eltype       {hdr.eltype} ({ELTYPE_NAMES.get(hdr.eltype, '?')})",
        f"elbyte       {hdr.elbyte}",
        f"data_length  {hdr.data_length}",
        f"ndims        {hdr.ndims}",
        f"dims         {list(hdr.shape)}",
        f"header_bytes {hdr.nbytes}",
        f"numpy dtype  {hdr.dtype()}",
    ]
    return "\n".join(lines)


def od_commands(path: str, hdr: Header) -> str:
    """Emit the exact od invocations from the paper for this file."""
    fmt = {4: "-f", 8: "-d"}.get(hdr.elbyte, "-t x1")
    return "\n".join(
        [
            f"od -N 48 -t u8 {path}        # fixed header as u64",
            f"od -N 48 -c {path}           # see the 'rawarray' magic",
            f"od -j {hdr.nbytes} {fmt} {path}   # the data segment",
        ]
    )


def _blob(path: str) -> bytes:
    """Whole file as bytes — local read or one remote GET."""
    if is_url(path):
        from .. import remote

        return remote.fetch_bytes(path)
    with open(path, "rb") as f:
        return f.read()


def verify_file(path: str) -> List[str]:
    """Recompute every redundant integrity signal in one file; returns the
    list of problems (empty = file is internally consistent).

    Checks: header parse + magic, dims/data_length consistency, payload
    present in full, CRC32 trailer recomputation, for zlib payloads that
    the *decompressed* size matches ``shape × elbyte``, and — when a
    ``rastats`` block is present (DESIGN.md §16) — that per-chunk
    min/max/NaN/count statistics recomputed from the decoded payload match
    the stored block exactly."""
    problems: List[str] = []
    try:
        blob = _blob(path)
    except (OSError, RawArrayError) as e:
        return [f"unreadable: {e}"]
    try:
        hdr = decode_header(blob, strict_flags=False)
    except RawArrayError as e:
        return [f"bad header: {e}"]
    if not hdr.compressed and hdr.data_length != hdr.logical_nbytes:
        problems.append(
            f"data_length={hdr.data_length} inconsistent with "
            f"shape={list(hdr.shape)} x elbyte={hdr.elbyte} (= {hdr.logical_nbytes})"
        )
    payload = blob[hdr.nbytes : hdr.nbytes + hdr.data_length]
    if len(payload) != hdr.data_length:
        problems.append(
            f"truncated data segment: header wants {hdr.data_length} bytes, "
            f"file holds {len(payload)}"
        )
        return problems  # downstream checks would only cascade
    trailer = blob[hdr.nbytes + hdr.data_length :]
    if hdr.flags & FLAG_CRC32_TRAILER:
        if len(trailer) < 4:
            problems.append("CRC32 flag set but trailer missing")
        else:
            want = int.from_bytes(trailer[-4:], "little")
            got = zlib.crc32(payload)
            if got != want:
                problems.append(f"CRC32 mismatch: stored {want:#010x}, computed {got:#010x}")
    if hdr.flags & FLAG_ZLIB:
        try:
            raw = zlib.decompress(payload)
        except zlib.error as e:
            problems.append(f"zlib payload does not decompress: {e}")
        else:
            if len(raw) != hdr.logical_nbytes:
                problems.append(
                    f"decompressed payload is {len(raw)} bytes, shape x elbyte "
                    f"wants {hdr.logical_nbytes}"
                )
    if hdr.flags & FLAG_CHUNKED:
        problems += _verify_chunked(hdr, payload, trailer)
    problems += _verify_stats(hdr, payload, trailer)
    return problems


def _verify_stats(hdr: Header, payload: bytes, trailer: bytes) -> List[str]:
    """Recompute the ``rastats`` block from the decoded payload and compare
    (DESIGN.md §16). Absent block -> nothing to check; damaged framing or
    statistics that disagree with the data are reported as problems —
    readers would full-scan either way, but a disagreement means the
    payload was rewritten without refreshing the stats."""
    meta = trailer
    if hdr.flags & FLAG_CHUNKED:
        try:
            table = chunked_codec.ChunkTable.decode(
                trailer, logical_nbytes=hdr.logical_nbytes,
                stored_nbytes=hdr.data_length)
        except RawArrayError:
            return []  # already reported by _verify_chunked
        meta = trailer[table.nbytes:]
    if hdr.flags & FLAG_CRC32_TRAILER:
        meta = meta[:-4] if len(meta) >= 4 else b""
    try:
        st, _ = stats_mod.split_stats(meta, strict=True)
    except RawArrayError as e:
        return [str(e)]
    if st is None:
        return []
    dt = hdr.dtype()
    if not stats_mod.stats_supported(dt):
        return [f"rastats block present for unsupported dtype {dt}"]
    # decode to raw logical bytes (chunk-by-chunk, whole-zlib, or as-is)
    if hdr.flags & FLAG_CHUNKED:
        try:
            table = chunked_codec.ChunkTable.decode(
                trailer, logical_nbytes=hdr.logical_nbytes,
                stored_nbytes=hdr.data_length)
            codec = chunked_codec.get_codec(table.codec_id)
            raw = b"".join(
                codec.decompress(
                    payload[int(table.stored_offsets[i]):
                            int(table.stored_offsets[i]) + int(table.stored_lens[i])])
                for i in range(table.nchunks))
        except Exception:
            return []  # chunk damage already reported by _verify_chunked
    elif hdr.flags & FLAG_ZLIB:
        try:
            raw = zlib.decompress(payload)
        except zlib.error:
            return []  # already reported above
    else:
        raw = payload
    try:
        acc = stats_mod.StatsAccumulator(dt, st.chunk_bytes)
        acc.feed(raw)
        got = acc.finish()
    except RawArrayError as e:
        return [f"rastats recompute failed: {e}"]
    problems: List[str] = []
    if got.nchunks != st.nchunks:
        problems.append(
            f"rastats window count {st.nchunks} disagrees with payload "
            f"(recomputed {got.nchunks} windows of {st.chunk_bytes} bytes)")
        return problems
    for name, a, b, eq in [
        ("count", st.counts, got.counts, np.array_equal),
        ("nan_count", st.nan_counts, got.nan_counts, np.array_equal),
        ("min", st.mins, got.mins,
         lambda x, y: np.array_equal(x, y, equal_nan=True)),
        ("max", st.maxs, got.maxs,
         lambda x, y: np.array_equal(x, y, equal_nan=True)),
    ]:
        if not eq(np.asarray(a), np.asarray(b)):
            bad = [i for i in range(st.nchunks)
                   if not eq(np.asarray(a[i:i + 1]), np.asarray(b[i:i + 1]))]
            problems.append(
                f"rastats {name} mismatch in window(s) {bad[:8]}"
                f"{'...' if len(bad) > 8 else ''}: stored statistics are "
                "stale for this payload")
    return problems


def _verify_chunked(hdr: Header, payload: bytes, trailer: bytes) -> List[str]:
    """Recheck a chunked payload against its trailer chunk table: table
    parse + geometry, per-chunk CRC32 of the stored bytes, and that every
    chunk decompresses to exactly its raw span (DESIGN.md §10)."""
    try:
        table = chunked_codec.ChunkTable.decode(
            trailer, logical_nbytes=hdr.logical_nbytes, stored_nbytes=hdr.data_length
        )
    except RawArrayError as e:
        return [f"bad chunk table: {e}"]
    problems: List[str] = []
    try:
        codec = chunked_codec.get_codec(table.codec_id)
    except RawArrayError as e:
        return [str(e)]
    raw_total = 0
    for i in range(table.nchunks):
        so = int(table.stored_offsets[i])
        slen = int(table.stored_lens[i])
        stored = payload[so : so + slen]
        if zlib.crc32(stored) != int(table.crcs[i]):
            problems.append(f"chunk {i} CRC32 mismatch: stored bytes corrupted")
            continue
        try:
            raw = codec.decompress(stored)
        except Exception as e:  # codec-specific error types
            problems.append(f"chunk {i} does not decompress: {e}")
            continue
        want = table.raw_len(i, hdr.logical_nbytes)
        if len(raw) != want:
            problems.append(
                f"chunk {i} decompressed to {len(raw)} bytes, table wants {want}"
            )
        raw_total += len(raw)
    if not problems and raw_total != hdr.logical_nbytes:
        problems.append(
            f"chunks decompress to {raw_total} bytes total, shape x elbyte "
            f"wants {hdr.logical_nbytes}"
        )
    return problems


def inspect_file(path: str) -> str:
    """Header, trailing-metadata length, and — for chunked files — a
    chunk-table summary."""
    hdr = header_of(path)
    lines = [format_header(hdr)]
    if is_url(path):
        from .. import remote

        size = remote.get_reader(path).size
    else:
        size = os.path.getsize(path)
    table = None
    if hdr.flags & FLAG_CHUNKED:
        # the table is two small positioned reads — never the payload (for a
        # URL: two ranged GETs through the pooled reader)
        if is_url(path):
            from .. import remote

            table = chunked_codec.read_table(remote.get_reader(path), hdr)
        else:
            with open(path, "rb") as f:
                table = chunked_codec.read_table(f.fileno(), hdr)
    # trailing user metadata = whatever sits between (payload + chunk table)
    # and the optional 4-byte CRC trailer
    meta_len = size - hdr.nbytes - hdr.data_length
    if table is not None:
        meta_len -= table.nbytes
    if hdr.flags & FLAG_CRC32_TRAILER:
        meta_len -= 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        st = raio.read_stats(path)
    if st is not None:
        meta_len -= st.nbytes
        lines.append(
            f"stats        {st.nchunks} windows x {st.chunk_bytes} bytes "
            f"(rastats v{st.version}, {st.nbytes} bytes)")
    else:
        lines.append("stats        none")
    lines.append(f"metadata     {max(0, meta_len)} bytes")
    if table is None:
        lines.append("chunks       none (payload is not chunk-compressed)")
        return "\n".join(lines)
    codec = chunked_codec.get_codec(table.codec_id)
    ratio = hdr.data_length / hdr.logical_nbytes if hdr.logical_nbytes else 1.0
    lines += [
        f"codec        {table.codec_id} ({codec.name})",
        f"chunk_bytes  {table.chunk_bytes}",
        f"nchunks      {table.nchunks}",
        f"stored       {hdr.data_length} ({ratio:.3f} of {hdr.logical_nbytes} raw)",
        f"table_bytes  {table.nbytes}",
    ]
    if table.nchunks:
        lens = table.stored_lens.astype(np.int64)
        lines.append(
            f"chunk stored min/mean/max  {int(lens.min())}/"
            f"{int(lens.mean())}/{int(lens.max())}"
        )
    return "\n".join(lines)


def stats_file(path: str, limit: int = 0) -> str:
    """Per-chunk ``rastats`` table (DESIGN.md §16) — header/table/tail
    ranged reads only, never the payload; works on local paths and URLs.
    Raises RawArrayError when the file carries no statistics block."""
    st = raio.read_stats(path)
    if st is None:
        raise RawArrayError(
            "no rastats block (written before rastats existed, or with stats=False); "
            "predicates on this file degrade to a full scan")
    lines = [
        f"version      {st.version}",
        f"chunk_bytes  {st.chunk_bytes}",
        f"nchunks      {st.nchunks}",
        f"  {'win':>5}  {'count':>10}  {'nans':>10}  {'min':>24}  {'max':>24}",
    ]
    n = st.nchunks if limit <= 0 else min(limit, st.nchunks)
    for i in range(n):
        lines.append(
            f"  {i:>5}  {int(st.counts[i]):>10}  {int(st.nan_counts[i]):>10}  "
            f"{st.mins[i]:>24.17g}  {st.maxs[i]:>24.17g}")
    if n < st.nchunks:
        lines.append(f"  ... ({st.nchunks} windows total)")
    return "\n".join(lines)


def _checkpoint_dir(path: str) -> Optional[str]:
    """The checkpoint directory when ``path`` names one (a directory — or
    directory URL — holding ``manifest.json``, or that manifest itself);
    ``None`` for anything else, including every ``*.ra`` file."""
    stripped = path.rstrip("/")
    if stripped.endswith("manifest.json"):
        return stripped[: -len("manifest.json")].rstrip("/") or "."
    if stripped.endswith(".ra") or stripped.endswith(".npy"):
        return None
    if not is_url(path):
        if os.path.isdir(path) and os.path.exists(os.path.join(path, "manifest.json")):
            return stripped
        return None
    # a directory URL has no marker; one cheap manifest probe decides
    import json

    from .. import remote

    try:
        obj = json.loads(remote.fetch_bytes(raio.join_path(stripped, "manifest.json")))
    except (RawArrayError, ValueError, OSError):
        return None
    return stripped if isinstance(obj, dict) and "leaves" in obj else None


def _flag_names(hdr: Header) -> str:
    names = [
        name
        for bit, name in [
            (1, "big-endian"), (FLAG_CRC32_TRAILER, "crc32"),
            (FLAG_ZLIB, "zlib"), (FLAG_CHUNKED, "chunked"),
        ]
        if hdr.flags & bit
    ]
    return ",".join(names) if names else "-"


def inspect_checkpoint(ckpt: str) -> str:
    """Audit a checkpoint's cold-start footprint without loading a single
    payload byte: per-leaf logical dtype/shape/flags/codec/quant schema plus
    total stored vs logical bytes. Headers (and chunk-table heads) resolve
    in one parallel engine wave — the same wave 1 the restore engine runs
    (DESIGN.md §13), so this is also a dry run of restore resolution."""
    from ..checkpoint.store import _entry_quant, _load_manifest

    from . import engine

    manifest = _load_manifest(ckpt)
    leaves = manifest.get("leaves", {})
    names = sorted(leaves)
    rows: dict = {}

    def _resolve(name: str) -> None:
        entry = leaves[name]
        fpath = raio.join_path(ckpt, entry["file"])
        hdr = header_of(fpath)
        codec_name = "-"
        if hdr.flags & FLAG_CHUNKED:
            if is_url(fpath):
                from .. import remote

                table = chunked_codec.read_table(remote.get_reader(fpath), hdr)
            else:
                fd = os.open(fpath, os.O_RDONLY)
                try:
                    table = chunked_codec.read_table(fd, hdr)
                finally:
                    os.close(fd)
            codec_name = chunked_codec.get_codec(table.codec_id).name
        elif hdr.flags & FLAG_ZLIB:
            codec_name = "zlib-whole"
        rows[name] = (hdr, codec_name, _entry_quant(entry, fpath, hdr))

    engine.run_tasks([(lambda n=n: _resolve(n)) for n in names])

    stored = logical = 0
    body: List[str] = []
    for name in names:
        hdr, codec_name, quant = rows[name]
        if quant is not None:
            dtype = quant.orig_dtype
            leaf_logical = hdr.logical_nbytes * np.dtype(quant.orig_dtype).itemsize
            per = "per-channel" if quant.scale.ndim else "scalar"
            qdesc = f"{quant.mode}->{quant.orig_dtype} {per}"
        else:
            dtype = str(hdr.dtype())
            leaf_logical = hdr.logical_nbytes
            qdesc = "-"
        stored += hdr.data_length
        logical += leaf_logical
        body.append(
            f"  {name:<40} {dtype:<9} {str(list(hdr.shape)):<16} "
            f"{_flag_names(hdr):<14} {codec_name:<10} {qdesc}"
        )
    ratio = stored / logical if logical else 1.0
    head = [
        f"checkpoint   {ckpt}",
        f"step         {manifest.get('step', '?')}",
        f"leaves       {len(names)}",
        f"stored       {stored} bytes",
        f"logical      {logical} bytes ({ratio:.3f} stored/logical)",
        f"  {'leaf':<40} {'dtype':<9} {'shape':<16} {'flags':<14} {'codec':<10} quant",
    ]
    return "\n".join(head + body)


def compress_file(
    src: str,
    dst: str,
    *,
    codec: str = None,
    chunk_bytes: int = None,
    crc32: bool = False,
) -> Tuple[int, int]:
    """Rewrite any RawArray file (local path or URL) as a chunk-compressed
    one, preserving user metadata. Returns (logical, stored) byte sizes."""
    arr, meta = read(src, with_metadata=True, strict_flags=False)
    raio.write(
        dst, arr, metadata=meta or None,
        chunked=True, codec=codec, chunk_bytes=chunk_bytes, crc32=crc32,
    )
    hdr = header_of(dst)
    return hdr.logical_nbytes, hdr.data_length


def _source_rows(src: str) -> np.ndarray:
    """Open one ingest source as an array-like with a leading row dim.
    Plain local ``.ra`` files and ``.npy`` are memory-mapped (rows stream
    without loading the file); compressed / remote sources decode fully."""
    if src.endswith(".npy"):
        if is_url(src):
            import io as _io

            from .. import remote

            return np.load(_io.BytesIO(remote.fetch_bytes(src)), allow_pickle=False)
        return np.load(src, mmap_mode="r", allow_pickle=False)
    hdr = header_of(src)
    if not is_url(src) and not hdr.compressed and not hdr.big_endian:
        return raio.memmap(src)
    return np.asarray(read(src, strict_flags=False))


def ingest_files(
    dst: str,
    sources: List[str],
    *,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    crc32: bool = False,
    batch_rows: Optional[int] = None,
) -> Tuple[int, "Header"]:
    """Stream-concatenate ``sources`` (``.npy`` or ``.ra``, local or URL)
    along axis 0 into one RawArray file through the incremental writer
    (DESIGN.md §11) — rows flow source → writer in bounded batches, so the
    result never materializes in RAM. ``dst`` may be a local path (crash-
    safe temp + rename) or the URL of a write-enabled server (streamed
    authenticated PUTs). Passing ``codec=``/``chunk_bytes=`` writes
    chunk-compressed. Returns ``(rows, final_header)``."""
    if not sources:
        raise RawArrayError("ingest needs at least one source file")
    first = _source_rows(sources[0])
    if first.ndim == 0:
        raise RawArrayError(f"{sources[0]}: cannot ingest a 0-d array")
    row_shape = first.shape[1:]
    dtype = np.dtype(first.dtype)
    row_nbytes = max(1, int(dtype.itemsize * int(np.prod(row_shape, dtype=np.int64))))
    if batch_rows is None:
        batch_rows = max(1, (32 << 20) // row_nbytes)  # ~32 MiB per batch
    chunked = codec is not None or chunk_bytes is not None
    if is_url(dst):
        from .. import remote

        writer = remote.RemoteWriter(
            dst, dtype, row_shape,
            crc32=crc32, chunked=chunked, codec=codec, chunk_bytes=chunk_bytes,
        )
    else:
        writer = raio.RaWriter(
            dst, dtype, row_shape,
            crc32=crc32, chunked=chunked, codec=codec, chunk_bytes=chunk_bytes,
        )
    with writer as w:
        for i, src in enumerate(sources):
            a = first if i == 0 else _source_rows(src)
            if a.shape[1:] != row_shape or np.dtype(a.dtype) != dtype:
                raise RawArrayError(
                    f"{src}: rows are {a.dtype}{list(a.shape[1:])}, expected "
                    f"{dtype}{list(row_shape)} (from {sources[0]})"
                )
            for lo in range(0, a.shape[0], batch_rows):
                w.write_rows(a[lo : lo + batch_rows])
        hdr = w.finalize()
    return int(hdr.shape[0]), hdr


def format_owners(table: dict) -> str:
    """Render ``data_mesh.owners_table`` output: per-shard assignment rows,
    per-host byte totals, and the imbalance ratio."""
    lines = [f"{'shard':>5}  {'rows':>10}  {'bytes':>14}  owner"]
    for s in table["shards"]:
        lines.append(
            f"{s['shard']:>5}  {s['rows']:>10}  {s['bytes']:>14}  {s['owner']}"
        )
    lines.append("")
    lines.append(f"{'host':<16}  {'shards':>6}  {'rows':>10}  {'bytes':>14}")
    for h in table["hosts"]:
        t = table["per_host"][h]
        lines.append(
            f"{h:<16}  {t['shards']:>6}  {t['rows']:>10}  {t['bytes']:>14}"
        )
    lines.append("")
    lines.append(
        f"epoch {table['epoch']}: {len(table['shards'])} shards, "
        f"{table['total_rows']} rows, {table['total_bytes']} bytes, "
        f"imbalance {table['imbalance']:.3f} (max host bytes / mean)"
    )
    return "\n".join(lines)


def _parse_hosts(spec: str) -> List[str]:
    names = [h.strip() for h in spec.split(",") if h.strip()]
    if len(names) == 1 and names[0].isdigit():
        return [f"host{i}" for i in range(int(names[0]))]
    return names


_EPILOG = """\
subcommands:
  header     print the decoded numeric header
  data       print the first payload elements (--limit)
  meta       dump the trailing user metadata to stdout
  od         print the od(1) commands that introspect this file (paper §3.2)
  verify     recompute every integrity signal (header consistency, CRC32
             trailer, zlib size, chunk-table geometry + per-chunk CRCs,
             rastats min/max/NaN/count vs the decoded payload)
  stats      print the per-chunk rastats table (DESIGN.md §16) — ranged
             reads only, the payload is never fetched; exits 1 when the
             file has no statistics block
  inspect    header + metadata length + chunk-table summary; pointed at a
             checkpoint directory (or its manifest.json), prints the
             per-leaf dtype/shape/flags/codec/quant audit instead —
             stored vs logical bytes without loading any payload
  compress   rewrite as chunk-compressed:  racat compress <src> <dst>
  ingest     stream-concatenate .npy/.ra sources into one file or URL:
             racat ingest <dst> <src...> [--codec C] [--crc32]
  doctor     layout-geometry checks against the core/layouts.py registry:
             racat doctor FILE|DIR [...] — header/chunk-table/rastats
             framing, segment tiling, stale-stats detection; never decodes
             the payload; exits 1 on any drift (DESIGN.md §17)
  owners     shard -> host ownership table for a dataset manifest (or
             sharded index.json) under the data mesh (DESIGN.md §15):
             racat owners <manifest> --hosts N [--epoch E] [--vnodes V]
             prints (shard, rows, bytes, owner) rows, per-host byte
             totals, and the imbalance ratio — ZERO payload reads

every subcommand accepts http(s):// URLs where a byte-range server is
serving (ingest destinations need a write-enabled server + RA_REMOTE_TOKEN).

exit codes:
  0   success (verify: file is internally consistent)
  1   failure (verify found problems, source unreadable, ingest/upload
      refused, malformed file)
  2   usage error (unknown subcommand or bad arguments)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="racat",
        description=__doc__,
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "cmd",
        choices=["header", "data", "meta", "od", "verify", "inspect",
                 "stats", "compress", "ingest", "owners", "doctor"],
    )
    p.add_argument("path", help="file path or http(s):// URL "
                   "(compress: source; ingest: destination)")
    p.add_argument("rest", nargs="*", default=[],
                   help="compress: output path; ingest: source files")
    p.add_argument("--limit", type=int, default=16, help="max elements to print")
    p.add_argument("--codec", default=None,
                   help="codec name for compress/ingest (default: RA_CODEC or zlib)")
    p.add_argument("--chunk-bytes", type=int, default=None,
                   help="raw chunk size for compress/ingest "
                   "(default: RA_CHUNK_BYTES or 1 MiB)")
    p.add_argument("--crc32", action="store_true",
                   help="also write a file-level CRC trailer (compress/ingest)")
    p.add_argument("--batch-rows", type=int, default=None,
                   help="rows per streamed ingest batch (default: ~32 MiB worth)")
    p.add_argument("--hosts", default=None,
                   help="owners: host count (N -> host0..host{N-1}) or a "
                   "comma-separated list of host names")
    p.add_argument("--epoch", type=int, default=0,
                   help="owners: epoch whose ownership deal to print "
                   "(RA_MESH_EPOCH_REOWN re-deals shards per epoch)")
    p.add_argument("--vnodes", type=int, default=None,
                   help="owners: virtual nodes per host on the ring "
                   "(default: RA_MESH_VNODES or 64)")
    args = p.parse_args(argv)
    if args.rest and args.cmd not in ("compress", "ingest", "doctor"):
        p.error(f"{args.cmd} takes exactly one path "
                f"(unexpected extra arguments: {' '.join(args.rest)})")

    try:
        if args.cmd == "doctor":
            # deferred: devtools is a dev dependency of the data plane,
            # not the other way around
            from ..devtools import doctor as doctor_mod

            return doctor_mod.main([args.path] + args.rest)

        if args.cmd == "verify":
            problems = verify_file(args.path)
            if problems:
                for msg in problems:
                    print(f"FAIL {args.path}: {msg}", file=sys.stderr)
                return 1
            print(f"OK {args.path}")
            return 0

        if args.cmd == "compress":
            if len(args.rest) != 1:
                p.error("compress needs an output path: racat compress <src> <dst>")
            logical, stored = compress_file(
                args.path, args.rest[0],
                codec=args.codec, chunk_bytes=args.chunk_bytes, crc32=args.crc32,
            )
            ratio = stored / logical if logical else 1.0
            print(f"OK {args.rest[0]}: {logical} -> {stored} bytes ({ratio:.3f})")
            return 0

        if args.cmd == "ingest":
            if not args.rest:
                p.error("ingest needs sources: racat ingest <dst> <src...>")
            rows, hdr = ingest_files(
                args.path, args.rest,
                codec=args.codec, chunk_bytes=args.chunk_bytes,
                crc32=args.crc32, batch_rows=args.batch_rows,
            )
            print(f"OK {args.path}: {rows} rows {list(hdr.shape)} "
                  f"{hdr.dtype()} ({hdr.data_length} stored bytes)")
            return 0

        if args.cmd == "owners":
            if not args.hosts:
                p.error("owners needs --hosts N (or --hosts a,b,c)")
            hosts = _parse_hosts(args.hosts)
            if not hosts:
                p.error(f"--hosts {args.hosts!r} names no hosts")
            # the data mesh (owners_table) is not part of this package yet
            raise RawArrayError("racat owners needs the data mesh, which is "
                                "not ported yet (ROADMAP.md, item 8)")

        if args.cmd == "inspect":
            ckpt = _checkpoint_dir(args.path)
            print(inspect_checkpoint(ckpt) if ckpt else inspect_file(args.path))
            return 0

        if args.cmd == "stats":
            print(stats_file(args.path))
            return 0

        hdr = header_of(args.path)
        if args.cmd == "header":
            print(format_header(hdr))
        elif args.cmd == "data":
            arr = read(args.path, strict_flags=False)
            flat = np.asarray(arr).reshape(-1)
            np.set_printoptions(threshold=args.limit)
            print(flat[: args.limit])
            if flat.size > args.limit:
                print(f"... ({flat.size} elements total)")
        elif args.cmd == "meta":
            sys.stdout.buffer.write(read_metadata(args.path))
        elif args.cmd == "od":
            print(od_commands(args.path, hdr))
        return 0
    except (RawArrayError, OSError) as e:
        print(f"FAIL {args.path}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())

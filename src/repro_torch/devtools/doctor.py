"""``racat doctor`` — layout-geometry checks against ``core/layouts.py``
(DESIGN.md §17).

Where ``racat verify`` recomputes *content* integrity (CRCs, rastats
bounds vs the decoded payload), ``doctor`` checks that a file's framing
agrees with the declared layout registry — byte for byte, without ever
decoding the payload:

* fixed header geometry matches ``layouts.HEADER`` (magic, 48-byte head,
  8-byte dims, ``ndims`` within the sanity bound), and the declaring
  module's ``header_nbytes`` agrees with ``layouts.HEADER.nbytes``;
* the on-disk segments tile the file exactly: ``header + data + [chunk
  table] + [rastats] + metadata + [crc trailer] == file size``, using
  the registry's sizes for every block;
* chunk-table framing matches ``layouts.CHUNK_TABLE`` (magic, 32/32
  head/entry bytes, strictly-increasing raw offsets, stored extent ==
  ``data_length``);
* ``rastats`` framing matches ``layouts.RASTATS`` (magic, 40-byte head,
  ``block_bytes == 40 + 32*n``) and the window count is not stale
  relative to the file's geometry (``ceil(logical / chunk_bytes)``).

URLs get the subset of checks the ranged readers support (header,
chunk-table, rastats); local files and directories get everything.
Exit is nonzero on any drift — CI runs it over the test corpus.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

from ..core import layouts
from ..core.spec import FLAG_CHUNKED, FLAG_CRC32_TRAILER, MAX_NDIMS, RawArrayError


def _expected_windows(logical_nbytes: int, chunk_bytes: int) -> int:
    if logical_nbytes <= 0 or chunk_bytes <= 0:
        return 0
    return (logical_nbytes + chunk_bytes - 1) // chunk_bytes


def doctor_file(path) -> List[str]:
    """Return a list of geometry problems (empty == healthy)."""
    from ..core import codec as chunked_codec
    from ..core import header as header_mod
    from ..core import io as ra_io
    from ..core import stats as stats_mod

    problems: List[str] = []
    H = layouts.HEADER

    # --- registry vs declaring modules (catches drift in either place)
    if header_mod.header_nbytes(0) != H.head_bytes:
        problems.append(
            f"core.header.header_nbytes(0)={header_mod.header_nbytes(0)} "
            f"disagrees with layouts.HEADER.head_bytes={H.head_bytes}"
        )
    if stats_mod.HEAD_BYTES != layouts.RASTATS.head_bytes:
        problems.append("core.stats head size disagrees with layouts.RASTATS")

    # --- header
    try:
        hdr = ra_io.header_of(path)
    except (RawArrayError, OSError) as e:
        return problems + [f"header: {e}"]
    if hdr.ndims > MAX_NDIMS:
        problems.append(f"header: ndims={hdr.ndims} exceeds bound {MAX_NDIMS}")
    hdr_nbytes = H.nbytes(hdr.ndims)
    if hdr.nbytes != hdr_nbytes:
        problems.append(
            f"header: declared size {hdr.nbytes} != layouts geometry {hdr_nbytes}"
        )

    is_remote = ra_io.is_url(path)

    # --- chunk table (decode validates monotonic offsets + stored extent
    # against data_length; re-framed here through the registry sizes)
    table = None
    table_nbytes = 0
    if hdr.flags & FLAG_CHUNKED:
        try:
            if is_remote:
                rdr = ra_io._remote().RemoteReader(path)
                try:
                    table = chunked_codec.read_table(rdr, hdr)
                finally:
                    rdr.close()
            else:
                with open(path, "rb") as f:
                    table = chunked_codec.read_table(f.fileno(), hdr)
        except (RawArrayError, OSError) as e:
            problems.append(f"chunk table: {e}")
        if table is not None:
            table_nbytes = (
                layouts.CHUNK_TABLE.nbytes(table.nchunks)
            )
            if table.nbytes != table_nbytes:
                problems.append(
                    f"chunk table: declared size {table.nbytes} != "
                    f"layouts geometry {table_nbytes}"
                )

    # --- rastats framing + staleness.  read_stats is deliberately lenient
    # (damaged block -> warn + full scan); doctor decodes strictly so a
    # truncated or misframed block is drift, not a shrug.
    st = None
    if is_remote:
        import warnings

        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                st = ra_io.read_stats(path)
            for w in caught:
                problems.append(f"rastats: {w.message}")
        except (RawArrayError, OSError) as e:
            problems.append(f"rastats: {e}")
    else:
        try:
            with open(path, "rb") as f:
                f.seek(hdr_nbytes + hdr.data_length + table_nbytes)
                tail = f.read()
            if hdr.flags & FLAG_CRC32_TRAILER:
                tail = tail[: -layouts.CRC32.head_bytes] or b""
            st = stats_mod.split_stats(tail, strict=True)[0]
        except (RawArrayError, OSError) as e:
            msg = str(e)
            problems.append(msg if msg.startswith("rastats") else f"rastats: {msg}")
    if st is not None:
        if st.nbytes != layouts.RASTATS.nbytes(st.nchunks):
            problems.append(
                f"rastats: block size {st.nbytes} != layouts geometry "
                f"{layouts.RASTATS.nbytes(st.nchunks)}"
            )
        want = _expected_windows(hdr.logical_nbytes, st.chunk_bytes)
        if st.nchunks != want:
            problems.append(
                f"rastats: {st.nchunks} windows but geometry implies {want} "
                f"({hdr.logical_nbytes} bytes / {st.chunk_bytes}-byte windows) "
                "— stale statistics block?"
            )

    # --- whole-file tiling (local only: needs the true size)
    if not is_remote:
        try:
            size = os.stat(path).st_size
            with open(path, "rb") as f:
                f.seek(hdr_nbytes + hdr.data_length + table_nbytes)
                tail = f.read()
        except OSError as e:
            return problems + [f"tail: {e}"]
        crc_bytes = layouts.CRC32.head_bytes if hdr.flags & FLAG_CRC32_TRAILER else 0
        if len(tail) < crc_bytes:
            problems.append(
                "crc trailer: flag set but file too short for the "
                f"{layouts.CRC32.head_bytes}-byte trailer"
            )
        stats_bytes = st.nbytes if st is not None else 0
        meta_start = hdr_nbytes + hdr.data_length + table_nbytes + stats_bytes
        if meta_start + crc_bytes > size:
            problems.append(
                f"tiling: header({hdr_nbytes}) + data({hdr.data_length}) + "
                f"table({table_nbytes}) + rastats({stats_bytes}) + "
                f"crc({crc_bytes}) = {meta_start + crc_bytes} "
                f"overruns file size {size}"
            )
    return problems


def doctor_paths(paths) -> Dict[str, List[str]]:
    """Expand directories to ``*.ra`` files and doctor each target."""
    from ..core.io import is_url

    out: Dict[str, List[str]] = {}
    for p in paths:
        if not is_url(p) and os.path.isdir(p):
            hit = False
            for dirpath, _dirs, files in sorted(os.walk(p)):
                for name in sorted(files):
                    if name.endswith(".ra"):
                        full = os.path.join(dirpath, name)
                        out[full] = doctor_file(full)
                        hit = True
            if not hit:
                out[str(p)] = [f"no .ra files under directory {p}"]
        else:
            out[str(p)] = doctor_file(p)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: racat doctor FILE|DIR [...]", file=sys.stderr)
        return 2
    results = doctor_paths(argv)
    bad = 0
    for path, problems in results.items():
        if problems:
            bad += 1
            for msg in problems:
                print(f"DRIFT {path}: {msg}", file=sys.stderr)
        else:
            print(f"OK {path}")
    return 1 if bad else 0

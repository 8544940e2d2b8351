"""Single registry of every on-disk struct layout (DESIGN.md §17).

The format's whole pitch is that every byte is introspectable with
``od -t u8`` — which only stays true while every writer and reader agrees
on the same geometry. Before this module, the header geometry lived in
``spec.py``, the chunk-table geometry in ``codec.py``, and the rastats
geometry in ``stats.py``, each as its own ``struct.Struct`` literal; a
drifted copy would produce files other layers misparse. Now each layout
is declared exactly once here, the declaring modules build their structs
FROM this registry, and two enforcement layers key off it:

* ``ralint`` (``repro.devtools.lint``) statically rejects any literal
  ``struct`` format string in the core plane that is not registered here;
* ``racat doctor`` (``repro.devtools.doctor``) checks real files on disk
  against the registered geometry and exits nonzero on drift.

This module is intentionally stdlib-only (``struct`` + ``dataclasses``)
and imports nothing from the rest of the package, so every layer — spec,
codec, stats, devtools, tools — can depend on it without cycles.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Layout:
    """One on-disk record layout: a fixed head plus optional repeated entries.

    ``head_fmt`` is the ``struct`` format of the fixed head (always
    little-endian u64s — the ``od -t u8`` contract).  ``entry_bytes`` is
    the size of one repeated entry after the head (0 = no entries);
    ``entry_fmt`` is its ``struct`` format when entries are row-packed,
    or ``None`` for columnar entry regions (rastats stores four parallel
    arrays rather than packed rows — the 32 bytes per window are split
    as u64 count / u64 nan_count / f64 min / f64 max columns).
    """

    name: str
    magic: Optional[bytes]          # leading magic bytes, None = no magic
    head_fmt: str
    head_fields: Tuple[str, ...]    # names of the head's fields, in order
    entry_bytes: int = 0
    entry_fmt: Optional[str] = None
    entry_fields: Tuple[str, ...] = ()
    module: str = ""                # module that declares/owns this layout
    design: str = ""                # DESIGN.md section documenting it

    @property
    def head_struct(self) -> struct.Struct:
        return struct.Struct(self.head_fmt)

    @property
    def head_bytes(self) -> int:
        return self.head_struct.size

    @property
    def magic_int(self) -> Optional[int]:
        """The magic as the little-endian u64 its first head field holds."""
        if self.magic is None:
            return None
        return int.from_bytes(self.magic, "little")

    def nbytes(self, nentries: int) -> int:
        """Total encoded size for ``nentries`` repeated entries."""
        return self.head_bytes + self.entry_bytes * int(nentries)


# --- the registry -----------------------------------------------------------
# RawArray file header (paper Table 1; DESIGN.md §1).  The shape vector
# (u64 dims[ndims]) follows the fixed head as "entries" of one u64 each.
HEADER = Layout(
    name="header",
    magic=b"rawarray",
    head_fmt="<QQQQQQ",
    head_fields=("magic", "flags", "eltype", "elbyte", "data_length", "ndims"),
    entry_bytes=8,
    entry_fmt="<Q",
    entry_fields=("dim",),
    module="repro_torch.core.spec",
    design="§1",
)

# Chunk-table trailer of FLAG_CHUNKED files (DESIGN.md §10): fixed head
# then one row-packed 4×u64 entry per chunk.
CHUNK_TABLE = Layout(
    name="rachunks",
    magic=b"rachunks",
    head_fmt="<QQQQ",
    head_fields=("magic", "codec_id", "chunk_bytes", "nchunks"),
    entry_bytes=32,
    entry_fmt="<QQQQ",
    entry_fields=("raw_offset", "stored_offset", "stored_len", "crc32"),
    module="repro_torch.core.codec",
    design="§10",
)

# Per-chunk statistics block (DESIGN.md §16): fixed head then a COLUMNAR
# entry region — u64 count[n], u64 nan_count[n], f64 min[n], f64 max[n]
# (32 bytes per window, but stored as four parallel arrays, hence
# entry_fmt=None).
RASTATS = Layout(
    name="rastats",
    magic=b"rastats_",
    head_fmt="<QQQQQ",
    head_fields=("magic", "version", "block_bytes", "nchunks", "chunk_bytes"),
    entry_bytes=32,
    entry_fmt=None,
    entry_fields=("count", "nan_count", "min", "max"),
    module="repro_torch.core.stats",
    design="§16",
)

# Bare little-endian u64 — the scalar every layout above is built from
# (also the file-level CRC32 trailer reads/writes through "<I", declared
# here so the linter's closed set covers every core-plane literal).
U64 = Layout(
    name="u64",
    magic=None,
    head_fmt="<Q",
    head_fields=("value",),
    module="repro_torch.core.spec",
    design="§1",
)

CRC32 = Layout(
    name="crc32",
    magic=None,
    head_fmt="<I",
    head_fields=("crc32",),
    module="repro_torch.core.io",
    design="§7",
)

LAYOUTS: Dict[str, Layout] = {
    lay.name: lay
    for lay in (HEADER, CHUNK_TABLE, RASTATS, U64, CRC32)
}

#: every registered struct format string — the closed set ``ralint``'s
#: struct-layout rule checks core-plane literals against
REGISTERED_FORMATS = frozenset(
    lay.head_fmt for lay in LAYOUTS.values()
) | frozenset(
    lay.entry_fmt for lay in LAYOUTS.values() if lay.entry_fmt is not None
)


def _selfcheck() -> None:
    """Internal consistency of the registry itself (runs at import)."""
    for lay in LAYOUTS.values():
        probe = struct.Struct(lay.head_fmt)
        vals = probe.unpack(b"\x00" * probe.size)
        if len(vals) != len(lay.head_fields):
            raise AssertionError(
                f"layout {lay.name}: head_fmt {lay.head_fmt!r} has "
                f"{len(vals)} fields but head_fields names {len(lay.head_fields)}"
            )
        if lay.entry_fmt is not None and struct.Struct(lay.entry_fmt).size != lay.entry_bytes:
            raise AssertionError(
                f"layout {lay.name}: entry_fmt {lay.entry_fmt!r} is "
                f"{struct.Struct(lay.entry_fmt).size} bytes, declared {lay.entry_bytes}"
            )
        if lay.magic is not None and len(lay.magic) != 8:
            raise AssertionError(f"layout {lay.name}: magic must be 8 bytes")


_selfcheck()

assert HEADER.head_bytes == 48
assert CHUNK_TABLE.head_bytes == 32 and CHUNK_TABLE.entry_bytes == 32
assert RASTATS.head_bytes == 40 and RASTATS.entry_bytes == 32

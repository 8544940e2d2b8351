"""RawArray on-disk format constants (paper Table 1 & 2; DESIGN.md §1, flag bits §7).

The file is a simple concatenation::

    u64 magic            "rawarray" as little-endian ASCII = 0x7961727261776172
    u64 flags            bit field (bit0 = big-endian payload)
    u64 eltype           element *kind* code (Table 2)
    u64 elbyte           element size in bytes
    u64 data_length      total payload bytes (redundant sanity check)
    u64 ndims            number of dimensions
    u64 dims[ndims]      shape vector
    u8  data[data_length]
    u8  metadata[...]    optional trailing user metadata (anything)

Everything before ``data`` is unsigned 64-bit little-endian integers, so the
header is introspectable with ``od -t u8`` (see ``repro.core.racat``).
"""

from __future__ import annotations

import os

from . import layouts


def env_int(name: str, default: int) -> int:
    """Integer env knob, read at call time; malformed/unset falls back."""
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    """Float env knob, read at call time; malformed/unset falls back."""
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    """String env knob, read at call time; unset/empty falls back.

    Every ``RA_*`` environment read in the tree goes through one of the
    ``env_*`` helpers — ralint's env-knob rule rejects raw ``os.environ``
    access elsewhere, and ``tools/check_docs.py`` cross-checks the knob
    names against the README table.
    """
    v = os.environ.get(name, "")
    return v if v else default

# ASCII of "rawarray" read as a little-endian u64. The byte sequence on disk
# is literally the string b"rawarray".
MAGIC: int = layouts.HEADER.magic_int
assert MAGIC == 0x7961727261776172

MAGIC_BYTES: bytes = layouts.HEADER.magic

# --- header geometry -------------------------------------------------------
# Derived from the single layout registry (core/layouts.py): the fixed head is
# magic, flags, eltype, elbyte, dlen, ndims — six little-endian u64s.
U64 = layouts.U64.head_struct
FIXED_HEADER = layouts.HEADER.head_struct
FIXED_HEADER_BYTES = layouts.HEADER.head_bytes  # 48
assert FIXED_HEADER_BYTES == 48


def header_nbytes(ndims: int) -> int:
    """Total header size for an array of ``ndims`` dimensions."""
    return FIXED_HEADER_BYTES + 8 * ndims


# --- element type codes (paper Table 2) -------------------------------------
ELTYPE_STRUCT = 0    # user-defined struct / opaque records
ELTYPE_INT = 1       # signed integer
ELTYPE_UINT = 2      # unsigned integer
ELTYPE_FLOAT = 3     # IEEE-754 floating point (incl. float16, bfloat16*)
ELTYPE_COMPLEX = 4   # complex float (contiguous float tuples)
# 5+ reserved by the paper for future use. We claim code 5 for brain floats,
# which are NOT IEEE-754 binary16 and therefore deserve their own kind —
# this is exactly the extension path the paper advertises (new codes are
# backward compatible: old readers reject unknown kinds loudly).
ELTYPE_BRAIN = 5     # brain floating point (bfloat16 and friends)

ELTYPE_NAMES = {
    ELTYPE_STRUCT: "struct",
    ELTYPE_INT: "int",
    ELTYPE_UINT: "uint",
    ELTYPE_FLOAT: "float",
    ELTYPE_COMPLEX: "complex",
    ELTYPE_BRAIN: "brain",
}

# --- flags bit field ---------------------------------------------------------
# bit 0 is the paper's byte-order bit. Higher bits are our backward-compatible
# extensions (DESIGN.md §7): a reader that doesn't know a bit can refuse it.
FLAG_BIG_ENDIAN = 1 << 0
FLAG_CRC32_TRAILER = 1 << 1   # 4-byte CRC32 of data segment appended AFTER metadata
FLAG_ZLIB = 1 << 2            # payload is zlib-compressed (data_length = compressed size)
FLAG_CHUNKED = 1 << 3         # payload is independently compressed chunks + a
                              # trailer chunk table (DESIGN.md §10);
                              # data_length = stored (compressed) size

KNOWN_FLAGS = FLAG_BIG_ENDIAN | FLAG_CRC32_TRAILER | FLAG_ZLIB | FLAG_CHUNKED

MAX_NDIMS = 64  # sanity bound; format itself allows 2**64


class RawArrayError(ValueError):
    """Malformed or unsupported RawArray file."""

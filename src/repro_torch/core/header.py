"""RawArray header encode/decode (paper §2, Table 1; DESIGN.md §1)."""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import BinaryIO, Tuple

import numpy as np

from .spec import (
    FIXED_HEADER,
    FIXED_HEADER_BYTES,
    FLAG_BIG_ENDIAN,
    FLAG_CHUNKED,
    FLAG_CRC32_TRAILER,
    FLAG_ZLIB,
    KNOWN_FLAGS,
    MAGIC,
    MAX_NDIMS,
    RawArrayError,
    header_nbytes,
)
from .dtypes import dtype_of, eltype_of


@dataclass(frozen=True)
class Header:
    """Decoded RawArray header."""

    flags: int
    eltype: int
    elbyte: int
    data_length: int
    shape: Tuple[int, ...]

    @property
    def ndims(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Header size on disk."""
        return header_nbytes(self.ndims)

    @property
    def big_endian(self) -> bool:
        return bool(self.flags & FLAG_BIG_ENDIAN)

    @property
    def count(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def logical_nbytes(self) -> int:
        """Uncompressed payload size implied by shape × elbyte (equals
        ``data_length`` except for compressed payloads — zlib or chunked —
        where ``data_length`` is the stored size)."""
        return self.count * self.elbyte

    @property
    def compressed(self) -> bool:
        """Payload bytes on disk are not the raw array bytes."""
        return bool(self.flags & (FLAG_ZLIB | FLAG_CHUNKED))

    @property
    def plain(self) -> bool:
        """True when the data segment can be streamed byte-for-byte into a
        native little-endian destination — the zero-copy fast path every
        layer (local, remote, sharded, checkpoint) keys off."""
        return not (
            self.flags & (FLAG_ZLIB | FLAG_CHUNKED | FLAG_CRC32_TRAILER)
        ) and not self.big_endian

    def dtype(self) -> np.dtype:
        return dtype_of(self.eltype, self.elbyte, big_endian=self.big_endian)

    def validate(self, *, strict_flags: bool = True) -> None:
        if self.ndims > MAX_NDIMS:
            raise RawArrayError(f"ndims={self.ndims} exceeds sanity bound {MAX_NDIMS}")
        if strict_flags and (self.flags & ~KNOWN_FLAGS):
            raise RawArrayError(f"unknown flag bits set: {self.flags:#x}")
        expected = self.logical_nbytes
        # The paper keeps data_length as a redundant sanity check; honor it —
        # except for compressed payloads where data_length is the stored size.
        if not self.compressed and expected != self.data_length:
            raise RawArrayError(
                f"data_length={self.data_length} inconsistent with "
                f"shape={self.shape} x elbyte={self.elbyte} (= {expected})"
            )

    def encode(self) -> bytes:
        buf = io.BytesIO()
        buf.write(
            FIXED_HEADER.pack(
                MAGIC, self.flags, self.eltype, self.elbyte, self.data_length, self.ndims
            )
        )
        if self.ndims:
            buf.write(np.asarray(self.shape, dtype="<u8").tobytes())
        return buf.getvalue()

    @classmethod
    def for_array(cls, arr: np.ndarray, flags: int = 0, data_length: int | None = None) -> "Header":
        eltype, elbyte = eltype_of(arr.dtype)
        dlen = arr.size * elbyte if data_length is None else data_length
        return cls(
            flags=flags,
            eltype=eltype,
            elbyte=elbyte,
            data_length=dlen,
            shape=tuple(int(d) for d in arr.shape),
        )


def read_header(f: BinaryIO, *, strict_flags: bool = True) -> Header:
    """Parse a header from a binary stream positioned at byte 0 of the file."""
    fixed = f.read(FIXED_HEADER_BYTES)
    if len(fixed) < FIXED_HEADER_BYTES:
        raise RawArrayError("file too short for RawArray header")
    magic, flags, eltype, elbyte, dlen, ndims = FIXED_HEADER.unpack(fixed)
    if magic != MAGIC:
        raise RawArrayError(
            f"bad magic {magic:#018x} (expected {MAGIC:#018x} = 'rawarray')"
        )
    if ndims > MAX_NDIMS:
        raise RawArrayError(f"ndims={ndims} exceeds sanity bound {MAX_NDIMS}")
    raw_dims = f.read(8 * ndims)
    if len(raw_dims) < 8 * ndims:
        raise RawArrayError("file truncated inside dimension vector")
    shape = tuple(int(d) for d in np.frombuffer(raw_dims, dtype="<u8"))
    hdr = Header(flags=flags, eltype=eltype, elbyte=elbyte, data_length=dlen, shape=shape)
    hdr.validate(strict_flags=strict_flags)
    return hdr


def decode_header(buf: bytes, *, strict_flags: bool = True) -> Header:
    return read_header(io.BytesIO(buf), strict_flags=strict_flags)

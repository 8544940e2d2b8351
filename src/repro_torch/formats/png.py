"""Pure-Python PNG codec on stdlib zlib (for the paper's Fig-3 benchmark;
baseline DESIGN.md §6).

Supports 8-bit grayscale (color type 0) and 8-bit RGB (color type 2),
which covers MNIST- and CIFAR-style images. The encoder uses filter type 0
(None) per scanline — the *fastest possible* PNG to decode — so the measured
RawArray-vs-PNG gap is a conservative lower bound on the paper's (real
datasets use adaptive filtering, which decodes slower). The decoder handles
all five filter types so it is a complete reader.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode(img: np.ndarray, *, level: int = 6) -> bytes:
    """Encode a (H, W) or (H, W, 3) uint8 array as PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png.encode wants uint8, got {img.dtype}")
    if img.ndim == 2:
        color_type, channels = 0, 1
        h, w = img.shape
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
        h, w = img.shape[:2]
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 prepended to each scanline
    raw = np.empty((h, 1 + w * channels), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = img.reshape(h, w * channels)
    idat = zlib.compress(raw.tobytes(), level)
    return b"".join(
        [_SIGNATURE, _chunk(b"IHDR", ihdr), _chunk(b"IDAT", idat), _chunk(b"IEND", b"")]
    )


def write(path: str, img: np.ndarray, *, level: int = 6) -> int:
    data = encode(img, level=level)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    # a = left, b = up, c = upper-left (int16 to avoid overflow)
    p = a.astype(np.int16) + b.astype(np.int16) - c.astype(np.int16)
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """Decode PNG bytes to a (H, W) or (H, W, C) uint8 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = None
    bit_depth = color_type = None
    idat = bytearray()
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, comp, filt, inter = struct.unpack(
                ">IIBBBBB", payload
            )
            if bit_depth != 8 or comp != 0 or filt != 0 or inter != 0:
                raise ValueError("unsupported PNG variant")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(bytes(idat))
    stride = width * channels
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, 1 + stride)
    filters = rows[:, 0]
    out = np.empty((height, stride), dtype=np.uint8)
    bpp = channels  # bytes per pixel at bit depth 8
    if not filters.any():
        # fast path: all scanlines unfiltered (what our encoder emits)
        out[:] = rows[:, 1:]
        return _reshape(out, height, width, channels)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        f = filters[y]
        cur = rows[y, 1:].copy()
        if f == 0:
            pass
        elif f == 1:  # Sub
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif f == 2:  # Up
            cur = (cur.astype(np.int16) + prev).astype(np.uint8)
        elif f == 3:  # Average
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                ul = prev[x - bpp] if x >= bpp else 0
                cur[x] = (
                    cur[x]
                    + _paeth(
                        np.uint8(left), np.uint8(prev[x]), np.uint8(ul)
                    )
                ) & 0xFF
        else:
            raise ValueError(f"bad filter {f}")
        out[y] = cur
        prev = cur
    return _reshape(out, height, width, channels)


def _reshape(flat: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    return flat.reshape(h, w) if c == 1 else flat.reshape(h, w, c)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def inflate_floor(path: str) -> Tuple[int, bytes]:
    """Read + inflate only (no unfiltering) — the time floor any PNG library
    must pay. Used to bound the Fig-3 comparison honestly from below."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 8
    idat = bytearray()
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8 : pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(bytes(idat))
    return len(raw), raw

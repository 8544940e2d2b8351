"""Mapping between numpy dtypes and RawArray (eltype, elbyte) pairs
(DESIGN.md §1).

The paper's key type-system idea: *kind* and *width* are independent, so new
widths (f16, f128, 512-bit AVX lanes) need no format change. We register the
full numpy zoo plus ``ml_dtypes`` extended floats used by JAX on TPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .spec import (
    ELTYPE_BRAIN,
    ELTYPE_COMPLEX,
    ELTYPE_FLOAT,
    ELTYPE_INT,
    ELTYPE_STRUCT,
    ELTYPE_UINT,
    RawArrayError,
)

try:  # ml_dtypes ships with jax; guard anyway so core/ has no hard jax dep.
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
    _HAVE_ML_DTYPES = True
except ImportError:  # pragma: no cover - ml_dtypes is installed with jax
    _BFLOAT16 = None
    _HAVE_ML_DTYPES = False


def eltype_of(dtype: np.dtype) -> Tuple[int, int]:
    """Return ``(eltype, elbyte)`` for a numpy dtype."""
    dtype = np.dtype(dtype)
    if _HAVE_ML_DTYPES and dtype == _BFLOAT16:
        return ELTYPE_BRAIN, 2
    kind = dtype.kind
    if kind == "i":
        return ELTYPE_INT, dtype.itemsize
    if kind == "u":
        return ELTYPE_UINT, dtype.itemsize
    if kind == "f":
        return ELTYPE_FLOAT, dtype.itemsize
    if kind == "c":
        return ELTYPE_COMPLEX, dtype.itemsize
    if kind == "V" and dtype.itemsize > 0:  # structured / void records
        return ELTYPE_STRUCT, dtype.itemsize
    if kind == "b":
        # Bools ride as 1-byte unsigned — same bits, archival-safe.
        return ELTYPE_UINT, 1
    raise RawArrayError(f"dtype {dtype} has no RawArray element type")


def dtype_of(eltype: int, elbyte: int, *, big_endian: bool = False) -> np.dtype:
    """Return the numpy dtype for an ``(eltype, elbyte)`` pair."""
    order = ">" if big_endian else "<"
    if eltype == ELTYPE_INT:
        if elbyte in (1, 2, 4, 8):
            return np.dtype(f"{order}i{elbyte}")
    elif eltype == ELTYPE_UINT:
        if elbyte in (1, 2, 4, 8):
            return np.dtype(f"{order}u{elbyte}")
    elif eltype == ELTYPE_FLOAT:
        if elbyte in (2, 4, 8) or (elbyte == 16 and hasattr(np, "float128")):
            return np.dtype(f"{order}f{elbyte}")
    elif eltype == ELTYPE_COMPLEX:
        if elbyte in (8, 16):
            return np.dtype(f"{order}c{elbyte}")
    elif eltype == ELTYPE_BRAIN:
        if elbyte == 2 and _HAVE_ML_DTYPES:
            if big_endian:
                raise RawArrayError("big-endian bfloat16 unsupported by this reader")
            return _BFLOAT16
    elif eltype == ELTYPE_STRUCT:
        # Opaque records: caller reinterprets. We hand back void bytes.
        return np.dtype((np.void, elbyte))
    raise RawArrayError(
        f"unsupported element type: eltype={eltype} elbyte={elbyte}"
    )


def is_native_reinterpretable(dtype: np.dtype) -> bool:
    """True if the dtype can be memory-mapped without byte swapping."""
    dtype = np.dtype(dtype)
    return dtype.byteorder in ("=", "|", "<")

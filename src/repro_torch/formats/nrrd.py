"""NRRD (Nearly Raw Raster Data) — the paper's "strong competitor" (§1).
Benchmark baseline (DESIGN.md §6).

Text header + raw payload; raw encoding only (the paper prefers external
compression anyway). Implemented so benchmarks can compare header-parse
overhead of a text format vs RawArray's numeric header.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_TYPE_TO_NRRD = {
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "uint16": "uint16",
    "int32": "int32", "uint32": "uint32",
    "int64": "int64", "uint64": "uint64",
    "float32": "float", "float64": "double",
}
_NRRD_TO_DTYPE = {v: k for k, v in _TYPE_TO_NRRD.items()}
_NRRD_TO_DTYPE.update({"signed char": "int8", "unsigned char": "uint8"})


def write(path: str, arr: np.ndarray, extra: Dict[str, str] | None = None) -> int:
    arr = np.ascontiguousarray(arr)
    t = _TYPE_TO_NRRD.get(arr.dtype.name)
    if t is None:
        raise ValueError(f"nrrd: unsupported dtype {arr.dtype}")
    # NRRD sizes are fastest-axis-first; numpy C-order last axis is fastest.
    sizes = " ".join(str(s) for s in arr.shape[::-1])
    lines = [
        "NRRD0004",
        f"type: {t}",
        f"dimension: {arr.ndim}",
        f"sizes: {sizes}",
        "encoding: raw",
        "endian: little",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    header = ("\n".join(lines) + "\n\n").encode()
    with open(path, "wb") as f:
        f.write(header)
        f.write(arr.tobytes())
    return len(header) + arr.nbytes


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"\n\n")
    fields: Dict[str, str] = {}
    head = data[:end].decode().splitlines()
    if not head[0].startswith("NRRD"):
        raise ValueError("not a NRRD file")
    for line in head[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            fields[k.strip()] = v.strip()
    if fields.get("encoding", "raw") != "raw":
        raise ValueError("nrrd: only raw encoding supported")
    if fields.get("endian", "little") != "little":
        raise ValueError("nrrd: only little endian supported")
    dtype = np.dtype(_NRRD_TO_DTYPE[fields["type"]])
    sizes = tuple(int(s) for s in fields["sizes"].split())
    shape = sizes[::-1]
    return np.frombuffer(data[end + 2 :], dtype=dtype, count=int(np.prod(shape))).reshape(shape)

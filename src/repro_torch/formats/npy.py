"""numpy .npy wrapper (benchmark baseline, DESIGN.md §6) — the paper
discusses NPY as 'quite fast, but not so
simple and not widely implemented in other languages'. We benchmark against
numpy's own battle-tested implementation (no reimplementation needed)."""

from __future__ import annotations

import numpy as np


def write(path: str, arr: np.ndarray) -> int:
    np.save(path, arr, allow_pickle=False)
    return arr.nbytes


def read(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=False)


def memmap(path: str) -> np.ndarray:
    return np.load(path, mmap_mode="r", allow_pickle=False)

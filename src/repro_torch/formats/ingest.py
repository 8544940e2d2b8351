"""Foreign-format → RawArray dataset converters (DESIGN.md §11).

The paper's motivating workload is archival ingest: take a pile of
format-of-the-day files (``.npy`` dumps, PNG images) and land them as a
RawArray dataset directory that every downstream plane — parallel reads,
remote byte-range serving, chunked compression, the training loader —
consumes natively. These converters stream through
``repro_torch.data.DatasetBuilder``, so an arbitrarily large corpus converts in
bounded memory (one write buffer per field) and the output directory is
atomic (manifest written last).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.spec import RawArrayError
from ..data.dataset import DatasetBuilder
from . import png as png_codec

PathList = Union[str, Sequence[str]]


def npy_to_dataset(
    root: str,
    field_files: Dict[str, PathList],
    *,
    shard_rows: int = 8192,
    batch_rows: Optional[int] = None,
    chunked: bool = False,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    metadata: Optional[dict] = None,
) -> dict:
    """Stream ``.npy`` files into a RawArray dataset (DESIGN.md §11).

    ``field_files`` maps each dataset field to one ``.npy`` path or an
    ordered list of paths that concatenate along axis 0; all fields must
    yield the same total row count. Sources are memory-mapped and fed to
    ``DatasetBuilder`` in bounded row batches, so nothing materializes.
    Returns the dataset manifest.
    """
    srcs: Dict[str, List[np.ndarray]] = {}
    fields: Dict[str, tuple] = {}
    totals = set()
    for name, paths in field_files.items():
        paths = [paths] if isinstance(paths, (str, os.PathLike)) else list(paths)
        arrs = [np.load(p, mmap_mode="r", allow_pickle=False) for p in paths]
        if not arrs or arrs[0].ndim == 0:
            raise RawArrayError(f"{name}: need at least one non-0-d .npy source")
        row_shape, dtype = arrs[0].shape[1:], arrs[0].dtype
        for p, a in zip(paths, arrs):
            if a.shape[1:] != row_shape or a.dtype != dtype:
                raise RawArrayError(
                    f"{p}: rows are {a.dtype}{list(a.shape[1:])}, field "
                    f"{name!r} wants {dtype}{list(row_shape)}"
                )
        srcs[name] = arrs
        fields[name] = (tuple(row_shape), str(dtype))
        totals.add(sum(a.shape[0] for a in arrs))
    if len(totals) != 1:
        raise RawArrayError(f"fields disagree on total rows: {sorted(totals)}")
    (total,) = totals
    if batch_rows is None:
        row_nbytes = max(
            1,
            sum(
                np.dtype(d).itemsize * int(np.prod(s, dtype=np.int64))
                for s, d in fields.values()
            ),
        )
        batch_rows = max(1, (32 << 20) // row_nbytes)
    # per-field cursors into the (file, row) stream
    flat = {name: _Concat(arrs) for name, arrs in srcs.items()}
    with DatasetBuilder(
        root, fields, shard_rows=shard_rows,
        chunked=chunked, codec=codec, chunk_bytes=chunk_bytes,
    ) as b:
        for lo in range(0, total, batch_rows):
            n = min(batch_rows, total - lo)
            b.append(**{name: flat[name].take(n) for name in fields})
        return b.finish(metadata=metadata)


class _Concat:
    """Sequential row cursor over a list of arrays (no np.concatenate)."""

    def __init__(self, arrs: List[np.ndarray]):
        self._arrs = arrs
        self._i = 0
        self._off = 0

    def take(self, n: int) -> np.ndarray:
        pieces = []
        while n:
            a = self._arrs[self._i]
            got = min(n, a.shape[0] - self._off)
            pieces.append(a[self._off : self._off + got])
            self._off += got
            n -= got
            if self._off == a.shape[0] and self._i + 1 < len(self._arrs):
                self._i += 1
                self._off = 0
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)


def images_to_dataset(
    root: str,
    image_paths: Sequence[str],
    labels: Optional[np.ndarray] = None,
    *,
    shard_rows: int = 8192,
    chunked: bool = False,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    metadata: Optional[dict] = None,
) -> dict:
    """Decode PNG images one by one into a RawArray dataset — the paper's
    MNIST/CIFAR-style ingest (DESIGN.md §11). All images must share one
    shape/dtype (the first image defines it); pass ``labels`` (one int per
    image) to add a ``label`` field. Returns the manifest."""
    if not image_paths:
        raise RawArrayError("images_to_dataset needs at least one image")
    first = png_codec.read(image_paths[0])
    fields: Dict[str, tuple] = {"image": (tuple(first.shape), str(first.dtype))}
    if labels is not None:
        labels = np.asarray(labels)
        if len(labels) != len(image_paths):
            raise RawArrayError(
                f"{len(labels)} labels for {len(image_paths)} images"
            )
        fields["label"] = ((), str(labels.dtype))
    with DatasetBuilder(
        root, fields, shard_rows=shard_rows,
        chunked=chunked, codec=codec, chunk_bytes=chunk_bytes,
    ) as b:
        for i, p in enumerate(image_paths):
            img = first if i == 0 else png_codec.read(p)
            if img.shape != first.shape or img.dtype != first.dtype:
                raise RawArrayError(
                    f"{p}: image is {img.dtype}{list(img.shape)}, dataset "
                    f"wants {first.dtype}{list(first.shape)}"
                )
            sample = {"image": img}
            if labels is not None:
                sample["label"] = labels[i]
            b.add(**sample)
        return b.finish(metadata=metadata)

"""RawArray shard-directory datasets.

Layout — exactly the paper's archival vision (§1: "metadata as human-
readable markup, raw data in RawArray files, organized by a file system
directory structure")::

    <root>/
      manifest.json             {"fields": {"tokens": {"dtype": "uint32",
                                 "shape": [1024]}, ...},
                                 "shards": [{"files": {"tokens":
                                 "tokens_00000.ra"}, "rows": 8192}, ...]}
      tokens_00000.ra           (rows, *field_shape) RawArray
      tokens_00001.ra           ...

Every shard file is an independent, memory-mappable RawArray; a reader
needs only offset arithmetic to fetch any row range of any field — this is
what makes multi-host sharded reads and exact-resume trivial.

``root`` may also be an ``http(s)://`` URL of a served dataset directory
(DESIGN.md §9): the manifest is fetched over HTTP, every positioned read
becomes a pooled byte-range request through ``repro_torch.remote``, and the
block cache turns repeated epoch traversals into RAM hits. The engine's
``rows``/``gather`` wave plans are identical in both modes; only the
sparse-leftover path differs (ranged reads instead of mmap fancy
indexing, since there is nothing to map).

Datasets are built by streaming (DESIGN.md §11): ``DatasetBuilder`` feeds
samples or row batches through per-field incremental writers in bounded
memory and publishes the manifest atomically at ``finish``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import core as ra
from ..core import codec as chunked_codec
from ..core import engine

MANIFEST = "manifest.json"

_join = ra.join_path


def dataset_manifest(root: str) -> Dict[str, Any]:
    if ra.is_url(root):
        from .. import remote

        return json.loads(remote.fetch_bytes(_join(root, MANIFEST)))
    with open(os.path.join(root, MANIFEST)) as f:
        return json.load(f)


class DatasetBuilder:
    """Streaming dataset ingest (DESIGN.md §11): feed samples or row
    batches; every field streams through an incremental ``RaWriter`` into
    the current shard file, shards roll at ``shard_rows``, and the manifest
    is written LAST (temp + atomic rename) — so peak memory is one write
    buffer per field (not a shard), a crash mid-ingest leaves only whole
    shard files plus invisible temps, and the directory is not a dataset
    until ``finish`` succeeds.

    This is the MNIST/CIFAR-style converter entry point the paper sketches
    (``repro_torch.formats`` converters call it; see ``examples/streaming_ingest.py``).
    ``chunked=True`` (or ``codec=``/``chunk_bytes=``) writes every shard
    file chunk-compressed (DESIGN.md §10) — compression runs chunk-parallel
    WHILE samples arrive; readers then decode only the chunks overlapping
    each row request. Output is byte-identical to the pre-streaming writer
    (one monolithic ``ra.write`` per shard) for the same sample stream.

    ``quantize={"field": spec}`` (DESIGN.md §12) stores a float field as
    uint8 codes — 4× fewer disk/wire bytes — with the ``(scale, bias,
    orig_dtype)`` schema in each shard file's RawArray metadata AND the
    manifest, so readers dequantize on host (``DataLoader``) or on device
    (``DeviceLoader`` via the CUDA dequant kernel). ``spec`` is ``"u8"``
    (calibration range [0, 1]), ``("u8", lo, hi)``, or a ``QuantInfo``;
    streaming ingest needs the range declared up front, so out-of-range
    samples saturate rather than rescaling.
    """

    def __init__(
        self,
        root: str,
        fields: Dict[str, Tuple[Tuple[int, ...], str]],
        shard_rows: int = 8192,
        *,
        crc32: bool = False,
        chunked: bool = False,
        codec: Optional[str] = None,
        chunk_bytes: Optional[int] = None,
        quantize: Optional[Dict[str, Any]] = None,
        stats: Optional[bool] = None,
    ):
        self.root = root
        self.fields = fields  # name -> (row_shape, dtype)
        self.shard_rows = shard_rows
        self.chunked = chunked or codec is not None or chunk_bytes is not None
        self.codec = codec
        self.chunk_bytes = chunk_bytes
        self.crc32 = crc32
        self.stats = stats  # None = auto: on for numeric stored dtypes (§16)
        self.quant: Dict[str, ra.QuantInfo] = {}
        for name, spec in (quantize or {}).items():
            if name not in fields:
                raise ra.RawArrayError(f"quantize names unknown field {name!r}")
            shape, dtype = fields[name]
            if not np.issubdtype(np.dtype(dtype), np.floating):
                raise ra.RawArrayError(
                    f"quantize: field {name!r} is {dtype}, only float fields "
                    f"can be stored quantized"
                )
            if len(shape) < 1:
                raise ra.RawArrayError(
                    f"quantize: field {name!r} has a scalar row shape; the "
                    f"dequant kernel needs a channel (last) axis"
                )
            self.quant[name] = ra.resolve_quant_spec(spec, dtype=dtype)
        self._writers: Optional[Dict[str, ra.io.RaWriter]] = None
        self._shard_fill = 0  # rows in the open shard
        self._shards: List[Dict[str, Any]] = []
        self._state = "open"
        os.makedirs(root, exist_ok=True)

    @property
    def rows(self) -> int:
        """Total rows ingested so far."""
        return sum(s["rows"] for s in self._shards) + self._shard_fill

    def _open_shard(self) -> Dict[str, ra.io.RaWriter]:
        if self._writers is None:
            idx = len(self._shards)
            self._writers = {
                # quantized fields store uint8 shard files carrying their
                # dequant schema as RawArray metadata (self-describing even
                # without the manifest)
                name: ra.io.RaWriter(
                    os.path.join(self.root, f"{name}_{idx:05d}.ra"),
                    np.uint8 if name in self.quant else np.dtype(dtype),
                    tuple(shape),
                    crc32=self.crc32, chunked=self.chunked,
                    codec=self.codec, chunk_bytes=self.chunk_bytes,
                    metadata=(self.quant[name].encode()
                              if name in self.quant else None),
                    # per-chunk stats default on for numeric stored dtypes
                    # (uint8 codes for quantized fields), DESIGN.md §16
                    stats=(ra.stats_supported(
                        np.uint8 if name in self.quant else np.dtype(dtype))
                        if self.stats is None else self.stats),
                )
                for name, (shape, dtype) in self.fields.items()
            }
            self._shard_fill = 0
        return self._writers

    def _roll(self) -> None:
        idx = len(self._shards)
        files = {}
        for name, w in self._writers.items():
            w.finalize()
            files[name] = f"{name}_{idx:05d}.ra"
        self._shards.append({"files": files, "rows": self._shard_fill})
        self._writers = None
        self._shard_fill = 0

    def append(self, **arrays: np.ndarray) -> None:
        """Append one row batch: every field, same leading dimension. The
        batch is split across shard boundaries as needed."""
        if self._state != "open":
            raise ra.RawArrayError(f"append on a {self._state} DatasetBuilder")
        batch: Dict[str, np.ndarray] = {}
        n = None
        for name, (shape, dtype) in self.fields.items():
            a = np.asarray(arrays[name])
            assert a.shape[1:] == tuple(shape), f"{name}: {a.shape} vs {shape}"
            n = a.shape[0] if n is None else n
            assert a.shape[0] == n
            if name in self.quant:
                a = self.quant[name].quantize(a)
            batch[name] = a
        pos = 0
        while pos < n:
            writers = self._open_shard()
            take = min(n - pos, self.shard_rows - self._shard_fill)
            for name, a in batch.items():
                writers[name].write_rows(a[pos : pos + take])
            self._shard_fill += take
            pos += take
            if self._shard_fill >= self.shard_rows:
                self._roll()

    def add(self, **sample: np.ndarray) -> None:
        """Append ONE sample (each field without the leading batch dim) —
        the live-capture convenience over ``append``."""
        self.append(**{k: np.asarray(v)[None] for k, v in sample.items()})

    def finish(self, metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Seal the open shard and atomically publish ``manifest.json``;
        returns the manifest. Calling it twice — or after ``abort`` — raises."""
        if self._state != "open":
            raise ra.RawArrayError(f"finish on a {self._state} DatasetBuilder")
        if self._writers is not None and self._shard_fill:
            self._roll()
        elif self._writers is not None:  # opened but empty: drop, don't publish
            for w in self._writers.values():
                w.abort()
            self._writers = None
        man = {
            "format": "rawarray-dataset-v1",
            # "dtype" stays the LOGICAL dtype; a "quant" sub-object marks the
            # shard files as uint8 codes plus the dequant schema (§12)
            "fields": {
                k: {
                    "shape": list(s),
                    "dtype": str(np.dtype(d)),
                    **({"quant": self.quant[k].to_dict()} if k in self.quant else {}),
                }
                for k, (s, d) in self.fields.items()
            },
            "shards": self._shards,
            "total_rows": int(sum(s["rows"] for s in self._shards)),
            "metadata": metadata or {},
        }
        tmp = os.path.join(self.root, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, MANIFEST))
        self._state = "finished"
        return man

    def abort(self) -> None:
        """Drop the open shard's temp files; no manifest is written."""
        if self._state == "open":
            self._state = "aborted"
            if self._writers is not None:
                for w in self._writers.values():
                    w.abort()
                self._writers = None

    def __enter__(self) -> "DatasetBuilder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        elif self._state == "open":
            self.finish()


# Pre-streaming name, kept for compatibility: the old RaDatasetWriter
# buffered a whole shard in RAM and wrote it monolithically; DatasetBuilder
# produces byte-identical output incrementally.
RaDatasetWriter = DatasetBuilder


@dataclass
class _Shard:
    rows: int
    files: Dict[str, str]
    row_offset: int


class RaDataset:
    """Random-access reader over a shard directory.

    Contiguous reads (``rows``) go through the parallel I/O engine in one
    wave of positioned preads straight into the output batch buffer; random
    gathers (``gather``) are planned by ``engine.coalesce`` — dense index
    runs become ranged reads, sparse leftovers fall back to fancy indexing
    on the cached per-shard mmaps (DESIGN.md §8). Both accept ``out=`` so a
    loader can stream into reused, pre-faulted batch arrays.
    """

    def __init__(self, root: str):
        self.root = root
        self.is_remote = ra.is_url(root)
        man = dataset_manifest(root)
        if man.get("format") != "rawarray-dataset-v1":
            raise ra.RawArrayError(f"not a RawArray dataset: {root}")
        self.fields: Dict[str, Any] = man["fields"]
        self.metadata = man.get("metadata", {})
        # typed quant schemas (DESIGN.md §12): shard files of these fields
        # hold uint8 codes; consumers dequantize on host or on device
        self.quant: Dict[str, ra.QuantInfo] = {
            f: ra.QuantInfo.from_dict(info["quant"])
            for f, info in self.fields.items()
            if info.get("quant")
        }
        self.shards: List[_Shard] = []
        off = 0
        for s in man["shards"]:
            self.shards.append(_Shard(rows=s["rows"], files=s["files"], row_offset=off))
            off += s["rows"]
        self.total_rows = off
        self._bounds = np.array([s.row_offset for s in self.shards] + [off])
        self._mmaps: Dict[Tuple[int, str], np.ndarray] = {}
        # (shard, field) -> (src, data_offset, row_nbytes, header, chunk
        # table or None) for positioned reads; src is an int fd locally, a
        # pooled RemoteReader for URLs
        self._fds: Dict[Tuple[int, str], Tuple[Any, int, int, Any, Any]] = {}
        # (shard, field) -> ChunkStats | None, decoded once from the tail
        # of each shard file (header/table/tail reads only — never payload)
        self._stats: Dict[Tuple[int, str], Any] = {}
        # shard -> access count, bumped on EVERY fd/mmap lookup: the witness
        # that a mesh host never touches a shard it doesn't own (§15)
        self._shard_touch: Dict[int, int] = {}

    def __len__(self) -> int:
        return self.total_rows

    # ---- shard-touch accounting (DESIGN.md §15) ---------------------------
    def shard_touches(self) -> Dict[int, int]:
        """Per-shard access counts (every fd/mmap lookup, local or remote):
        the observable a mesh test asserts to prove this host fetched bytes
        only from shards it owns."""
        return dict(self._shard_touch)

    def shards_touched(self) -> List[int]:
        return sorted(self._shard_touch)

    def reset_shard_touches(self) -> None:
        self._shard_touch.clear()

    def close(self) -> None:
        for fd, *_ in self._fds.values():
            if not isinstance(fd, int):
                continue  # remote readers live in the shared registry
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()
        self._mmaps.clear()

    def __del__(self):  # best-effort fd cleanup
        try:
            self.close()
        except Exception:
            pass

    def _mmap(self, shard_idx: int, field: str) -> np.ndarray:
        if self.is_remote:
            raise ra.RawArrayError(
                "memory-mapping is unavailable for a remote dataset "
                "(gather serves every row via ranged reads instead)"
            )
        key = (shard_idx, field)
        self._shard_touch[shard_idx] = self._shard_touch.get(shard_idx, 0) + 1
        if key not in self._mmaps:
            path = os.path.join(self.root, self.shards[shard_idx].files[field])
            self._mmaps[key] = ra.memmap(path)
        return self._mmaps[key]

    def _fmeta(self, shard_idx: int, field: str) -> Tuple[Any, int, int, Any, Any]:
        """(src, payload offset, row bytes, header, chunk table | None) for
        one shard file, cached. ``src`` is whatever ``engine.pread_into``
        accepts: an int fd for a local file, a pooled ``RemoteReader`` for a
        URL. A chunked shard carries its decoded chunk table so row spans
        map to chunk runs without re-reading the trailer."""
        key = (shard_idx, field)
        self._shard_touch[shard_idx] = self._shard_touch.get(shard_idx, 0) + 1
        if key not in self._fds:
            path = _join(self.root, self.shards[shard_idx].files[field])
            hdr = ra.header_of(path)
            if hdr.compressed and not (hdr.flags & ra.FLAG_CHUNKED):
                raise ra.RawArrayError(
                    f"{path}: whole-file zlib shards are not range-addressable; "
                    f"rewrite the dataset with chunked compression "
                    f"(RaDatasetWriter(chunked=True) or `racat compress`)"
                )
            if hdr.big_endian:
                raise ra.RawArrayError(
                    f"{path}: big-endian shards are not supported in datasets"
                )
            row_nbytes = hdr.elbyte
            for d in hdr.shape[1:]:
                row_nbytes *= d
            if self.is_remote:
                from .. import remote

                src: Any = remote.get_reader(path)
            else:
                src = os.open(path, os.O_RDONLY)
            table = (
                chunked_codec.read_table(src, hdr)
                if hdr.flags & ra.FLAG_CHUNKED
                else None
            )
            self._fds[key] = (src, hdr.nbytes, row_nbytes, hdr, table)
        return self._fds[key]

    def _raw_reader(self, shard_idx: int, field: str):
        """``read_raw(raw_off, view)`` closure over one plain shard file:
        one positioned read at the payload offset (chunked fields never
        come through here — gather plans them per chunk)."""
        src, doff, *_ = self._fmeta(shard_idx, field)
        return lambda off, view: engine.pread_into(src, doff + off, view)

    def _resolve_fmeta(self, shard_idx_list, fields) -> None:
        """Resolve the (shard, field) sources a read will touch in one
        concurrent wave. Remotely each resolution costs 1-2 HTTP round
        trips (header + HEAD); a serial first-batch loop over S x F shard
        files would pay them back-to-back (same pre-resolve pattern as
        checkpoint restore and sharded.read_slice)."""
        pending = [
            (si, f)
            for si in shard_idx_list
            for f in fields
            if (si, f) not in self._fds
        ]
        if len(pending) > 1:
            engine.run_tasks([(lambda s=si, g=f: self._fmeta(s, g)) for si, f in pending])

    def io_stats(self) -> Dict[str, int]:
        """I/O observability counters: block-cache hit/miss/eviction (plus a
        combined ``hit_ratio`` recomputed from the summed counters) over
        this dataset's remote readers (empty for a local dataset), plus the
        codec's chunk decode counters (``chunk_reads`` /
        ``chunk_stored_bytes`` / ``chunk_raw_bytes``) when any chunked
        decoding has happened — the observable that proves partial reads of
        compressed shards touch only overlapping chunks. NB: readers
        default to the process-wide ``remote.shared_cache()`` and the chunk
        counters are process-wide too, so with other traffic in the same
        process these counters are process-global, not per-dataset; pass
        each reader its own ``BlockCache`` (and ``codec.reset_stats()``)
        for isolated accounting."""
        out: Dict[str, int] = {}
        if self.is_remote:
            caches = []
            for src, *_ in self._fds.values():
                cache = getattr(src, "cache", None)
                if cache is not None and all(c is not cache for c in caches):
                    caches.append(cache)
            for c in caches:
                for k, v in c.stats().items():
                    if k == "hit_ratio":
                        continue  # a ratio does not sum; recomputed below
                    out[k] = out.get(k, 0) + v
            total = out.get("hits", 0) + out.get("misses", 0)
            if total:
                out["hit_ratio"] = out["hits"] / total
        cstats = chunked_codec.stats()
        if any(cstats.values()):
            out.update(cstats)
        return out

    def _field_spec(self, field: str) -> Tuple[Tuple[int, ...], np.dtype]:
        return self.stored_spec(field)

    def stored_spec(self, field: str) -> Tuple[Tuple[int, ...], np.dtype]:
        """``(row_shape, dtype)`` of the bytes actually ON DISK for one
        field — uint8 for quantized fields (DESIGN.md §12), the declared
        dtype otherwise. All read planning (and loader staging buffers)
        works in stored terms; dequantization happens at the consumer."""
        info = self.fields[field]
        dtype = np.dtype(np.uint8) if field in self.quant else np.dtype(info["dtype"])
        return tuple(info["shape"]), dtype

    def logical_spec(self, field: str) -> Tuple[Tuple[int, ...], np.dtype]:
        """``(row_shape, dtype)`` a consumer sees AFTER dequantization —
        the manifest's declared dtype."""
        info = self.fields[field]
        return tuple(info["shape"]), np.dtype(info["dtype"])

    def _dest(
        self,
        out: Optional[Dict[str, np.ndarray]],
        field: str,
        n: int,
    ) -> np.ndarray:
        rshape, dtype = self._field_spec(field)
        want = (n,) + rshape
        if out is not None and field in out:
            dst = out[field]
            if tuple(dst.shape) != want or dst.dtype != dtype or not dst.flags.c_contiguous:
                raise ra.RawArrayError(
                    f"{field}: out must be C-contiguous {want} {dtype}, "
                    f"got {dst.shape} {dst.dtype}"
                )
            return dst
        return np.empty(want, dtype)

    def rows(
        self,
        start: int,
        stop: int,
        fields: Optional[Sequence[str]] = None,
        *,
        out: Optional[Dict[str, np.ndarray]] = None,
    ) -> Dict[str, np.ndarray]:
        """Read global rows [start, stop) across shard boundaries — one
        engine wave of positioned reads into a single buffer per field."""
        fields = list(fields or self.fields)
        start, stop = max(0, start), min(stop, self.total_rows)
        n = max(0, stop - start)
        result = {f: self._dest(out, f, n) for f in fields}
        if n == 0:
            return result
        touched = [
            i
            for i, sh in enumerate(self.shards)
            if sh.row_offset < stop and sh.row_offset + sh.rows > start
        ]
        self._resolve_fmeta(touched, fields)
        jobs = []
        tasks = []  # per-chunk decode tasks for chunked shards
        for i in touched:
            sh = self.shards[i]
            lo, hi = sh.row_offset, sh.row_offset + sh.rows
            a, b = max(start, lo) - lo, min(stop, hi) - lo
            for f in fields:
                fd, doff, rnb, hdr, table = self._fmeta(i, f)
                if rnb == 0:
                    continue
                dst = result[f]
                mv = memoryview(dst.reshape(-1).view(np.uint8)).cast("B")
                o = lo + a - start
                dview = mv[o * rnb : (o + b - a) * rnb]
                if table is None:
                    jobs.append((fd, doff + a * rnb, dview))
                else:
                    tasks += chunked_codec.chunk_read_tasks(
                        fd, hdr, table, a * rnb, b * rnb, dview
                    )
        if tasks:  # one wave: slab preads + chunk decodes share the pool
            engine.run_tasks(engine.span_read_tasks(jobs) + tasks)
        else:
            engine.parallel_read_spans(jobs)
        return result

    def gather(
        self,
        indices: np.ndarray,
        fields: Optional[Sequence[str]] = None,
        *,
        out: Optional[Dict[str, np.ndarray]] = None,
    ) -> Dict[str, np.ndarray]:
        """Gather arbitrary global rows (shuffled access).

        Per shard, ``engine.coalesce`` merges near-adjacent requests into
        ranged positioned reads (served from reusable scratch buffers, or
        read directly into the output when the destination rows line up);
        requests too sparse to coalesce fall back to fancy indexing on the
        cached mmap — the planner never reads more than ``gap+1`` times the
        requested bytes."""
        fields = list(fields or self.fields)
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indices)
        result = {f: self._dest(out, f, n) for f in fields}
        if n == 0:
            return result
        # one global sort; shard membership is then a searchsorted over the
        # sorted values (no per-shard masks), and per-shard slices arrive
        # pre-sorted for the planner and for page-local fancy indexing
        order = np.argsort(indices, kind="stable")
        sidx = indices[order]
        cuts = np.searchsorted(sidx, self._bounds)
        touched = [
            si for si in range(len(self.shards)) if cuts[si] != cuts[si + 1]
        ]
        # sources must be resolved BEFORE planning: a chunked field is
        # planned per CHUNK (each needed chunk decoded exactly once, rows
        # scattered out of it), a plain field per coalesced row run —
        # chunked-ness is a per-field property, so a shard mixing chunked
        # and plain field files gets both plan kinds
        self._resolve_fmeta(touched, fields)
        plans = []  # (si, local rows, destination slots, plain (runs, leftover))
        for si in touched:
            a, b = cuts[si], cuts[si + 1]
            local = sidx[a:b] - self.shards[si].row_offset
            plain_plan = None
            if any(self._fmeta(si, f)[4] is None for f in fields):
                # remote: no mmap to service sparse leftovers, so every
                # request becomes a ranged read (min_run=1); singleton runs
                # are absorbed by the block cache
                min_run = 1 if self.is_remote else None
                plain_plan = engine.coalesce_sorted(local, np.arange(a, b),
                                                    min_run=min_run)
            plans.append((si, local, order[a:b], plain_plan))
        tasks = []
        fancy = []  # deferred sparse leftovers: (si, field, positions, local)
        for f in fields:
            rshape, dtype = self._field_spec(f)
            sample = result[f]
            for si, local, pos, plain_plan in plans:
                src, doff, rnb, hdr, table = self._fmeta(si, f)
                if rnb == 0:
                    continue
                if table is not None:
                    mv = memoryview(sample.reshape(-1).view(np.uint8)).cast("B")
                    tasks += chunked_codec.gather_rows_tasks(
                        src, hdr, table, rnb, local, pos, mv
                    )
                    continue
                runs, leftover = plain_plan
                if runs:
                    read_raw = self._raw_reader(si, f)
                    for run in runs:
                        tasks.append(
                            self._run_task(run, sidx, order, sample, rshape, dtype,
                                           read_raw, rnb, self.shards[si].row_offset)
                        )
                if leftover.size:
                    fancy.append((si, f, order[leftover], sidx[leftover]
                                  - self.shards[si].row_offset))
        engine.run_tasks(tasks)
        for si, f, pos, loc in fancy:
            result[f][pos] = self._mmap(si, f)[loc]
        return result

    @staticmethod
    def _run_task(run, sidx, order, sample, rshape, dtype, read_raw, rnb, row_off):
        """Closure for one coalesced ranged read (executed on the pool).
        ``run.sel`` points into the dataset-wide sorted arrays; ``read_raw``
        serves a logical payload byte range (positioned pread on a plain
        shard, chunk decode on a chunked one)."""

        def task():
            lo, hi, sel = run
            span = hi - lo
            want = span * rnb
            pos_sel = order[sel]
            loc_sel = sidx[sel] - row_off
            p0 = int(pos_sel[0])
            direct = (
                span == len(sel)
                and np.array_equal(loc_sel, np.arange(lo, hi))
                and np.array_equal(pos_sel, np.arange(p0, p0 + span))
            )
            if direct:
                # destination rows are contiguous and in order: zero-copy read
                mv = memoryview(sample.reshape(-1).view(np.uint8)).cast("B")
                read_raw(lo * rnb, mv[p0 * rnb : p0 * rnb + want])
                return
            scratch = engine.acquire_scratch(want)
            try:
                read_raw(lo * rnb, memoryview(scratch)[:want])
                rows_arr = scratch[:want].view(dtype).reshape((span,) + rshape)
                sample[pos_sel] = rows_arr[loc_sel - lo]
            finally:
                engine.release_scratch(scratch)

        return task

    def gather_naive(
        self, indices: np.ndarray, fields: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        """Reference per-row fancy-indexing gather (the pre-engine path).
        Kept for equivalence tests and as the benchmark baseline.
        Local-only: it indexes shard mmaps."""
        fields = list(fields or self.fields)
        indices = np.asarray(indices)
        bounds = np.array([s.row_offset for s in self.shards] + [self.total_rows])
        shard_of = np.searchsorted(bounds, indices, side="right") - 1
        out: Dict[str, np.ndarray] = {}
        for f in fields:
            rshape, dtype = self.stored_spec(f)
            sample = np.empty((len(indices),) + rshape, dtype=dtype)
            for si in np.unique(shard_of):
                mask = shard_of == si
                local = indices[mask] - self.shards[si].row_offset
                sample[mask] = self._mmap(int(si), f)[local]
            out[f] = sample
        return out

    # ---- predicate pushdown (DESIGN.md §16) -------------------------------
    def field_stats(self, shard_idx: int, field: str):
        """Per-chunk ``rastats`` statistics of one shard file, decoded once
        and cached. Costs the header + chunk table + two small tail reads
        (a few hundred bytes over HTTP) — the payload is never touched.
        ``None`` for shards written without (or with a damaged) stats
        block; those shards are then fully scanned."""
        key = (shard_idx, field)
        if key not in self._stats:
            src, _doff, _rnb, hdr, table = self._fmeta(shard_idx, field)
            size = chunked_codec._src_size(src)
            self._stats[key] = ra.io._read_stats_src(
                src, hdr, size=size,
                table_nbytes=table.nbytes if table is not None else 0,
            )
        return self._stats[key]

    def _row_verdicts(self, where) -> Tuple[np.ndarray, np.ndarray]:
        """Global per-row ``(definitely_true, definitely_false)`` for a
        predicate, from the per-shard stats blocks."""
        pfields = sorted(where.fields())
        for f in pfields:
            if f not in self.fields:
                raise ra.RawArrayError(f"predicate names unknown field {f!r}")
        dt = np.zeros(self.total_rows, dtype=bool)
        df = np.zeros(self.total_rows, dtype=bool)
        self._resolve_fmeta(range(len(self.shards)), pfields)
        for si, sh in enumerate(self.shards):
            info = {}
            for f in pfields:
                rshape, dtype = self.stored_spec(f)
                rnb = dtype.itemsize
                for d in rshape:
                    rnb *= d
                info[f] = (self.field_stats(si, f), rnb)
            d, e = where.row_verdicts(sh.rows, info)
            dt[sh.row_offset:sh.row_offset + sh.rows] = d
            df[sh.row_offset:sh.row_offset + sh.rows] = e
        return dt, df

    def select(
        self,
        where=None,
        fields: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        """Read every row matching ``where`` (DESIGN.md §16).

        The predicate (built with ``repro_torch.core.col``) is pushed down to
        the per-chunk statistics: chunks whose ``[min, max]`` intervals
        prove no row can match are pruned without fetching a single
        payload byte, chunks proved all-matching are taken wholesale, and
        only the undecided rows are decoded AND masked — each touched
        chunk is decoded exactly once, with the residual row filter
        applied in the same pass. Identical for local directories,
        ``http(s)://`` URLs and the fleet router. Rows of quantized
        fields are compared (and returned) as their STORED uint8 codes.
        Shards without usable stats degrade to a full scan — results are
        always byte-identical to filtering a full read."""
        fields = list(fields or self.fields)
        if where is None:
            return self.rows(0, self.total_rows, fields)
        pfields = sorted(where.fields())
        dt, df = self._row_verdicts(where)
        cand = np.nonzero(~df)[0]
        if cand.size == 0:
            return {f: self._dest(None, f, 0) for f in fields}
        need_scan = bool((~dt[cand]).any())
        gfields = list(dict.fromkeys(fields + (pfields if need_scan else [])))
        batch = self.gather(cand, gfields)
        if not need_scan:
            return {f: batch[f] for f in fields}
        keep = dt[cand] | where.mask({f: batch[f] for f in pfields})
        return {f: batch[f][keep] for f in fields}

    def select_indices(self, where) -> np.ndarray:
        """Global row indices matching ``where`` (sorted ascending) — the
        planning half of ``select``, used by ``DataLoader(where=...)``.
        Only predicate fields of undecided chunks are decoded."""
        dt, df = self._row_verdicts(where)
        cand = np.nonzero(~df)[0]
        scan = cand[~dt[cand]]
        if scan.size == 0:
            return cand
        pfields = sorted(where.fields())
        batch = self.gather(scan, pfields)
        keep = dt[cand].copy()
        keep[~dt[cand]] = where.mask(batch)
        return cand[keep]

    def host_range(self, host_id: int, host_count: int) -> Tuple[int, int]:
        """Contiguous row range owned by this host (multi-host sharding)."""
        per = self.total_rows // host_count
        start = host_id * per
        stop = start + per if host_id < host_count - 1 else self.total_rows
        return start, stop

"""Parallel chunked I/O engine (DESIGN.md §8).

The RawArray layout is a fixed-size numeric header followed by one linear
data segment, so the byte range of *any* sub-array is pure offset
arithmetic.  This module turns that property into wall-clock wins: it
chunk-splits byte ranges into aligned slabs and issues concurrent
``os.pread``/``os.pwrite`` calls from a process-wide reusable thread pool
(the kernel copies run with the GIL released), and it plans coalesced
ranged reads for scattered row gathers.

Primitives (all take raw file descriptors so positioned I/O never races a
shared file offset):

* ``pread_into(fd, offset, view)``   — short-read-safe positioned read
* ``pwrite_from(fd, offset, view)``  — short-write-safe positioned write
* ``parallel_read_into(fd, offset, view)`` — slab-parallel read
* ``parallel_read_spans(jobs)``      — one pool wave over many (fd, off, view)
* ``parallel_write(fd, offset, views)`` — slab-parallel write of a view train
* ``coalesce(indices)``              — merge near-adjacent rows into ranged reads
* ``acquire_scratch / release_scratch`` — reusable (pre-faulted) bounce buffers

Everything degrades to plain sequential I/O below ``parallel_min`` bytes,
when the pool would have one worker, when ``RA_IO_SEQUENTIAL=1``, or when
already running *on* an engine worker thread (nested parallelism would
deadlock a bounded pool; the outer level already owns the concurrency).

Env knobs (read at call time so tests/benches can flip them):

=====================  ========================================  =========
variable               meaning                                   default
=====================  ========================================  =========
``RA_IO_WORKERS``      pool width                                2 x cores (<= 8)
``RA_IO_CHUNK``        slab size in bytes                        8 MiB
``RA_IO_PARALLEL_MIN`` below this many bytes stay sequential     4 MiB
``RA_IO_SEQUENTIAL``   "1" forces the sequential path            off
``RA_IO_GATHER_GAP``   max missing rows merged into one read     1
``RA_IO_GATHER_RUN``   min rows for a coalesced ranged read      4
=====================  ========================================  =========
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .spec import RawArrayError, env_int as _env_int, env_str as _env_str

# Indirection points so tests can inject short reads/writes.
_preadv = os.preadv
_pwritev = os.pwritev

_THREAD_PREFIX = "ra-io"


def workers() -> int:
    return max(1, _env_int("RA_IO_WORKERS", min(8, 2 * (os.cpu_count() or 1))))


def chunk_bytes() -> int:
    return max(1 << 16, _env_int("RA_IO_CHUNK", 8 << 20))


def parallel_min() -> int:
    return max(0, _env_int("RA_IO_PARALLEL_MIN", 4 << 20))


def gather_gap() -> int:
    return max(0, _env_int("RA_IO_GATHER_GAP", 1))


def gather_min_run() -> int:
    return max(2, _env_int("RA_IO_GATHER_RUN", 4))


def sequential_forced() -> bool:
    return _env_str("RA_IO_SEQUENTIAL") == "1"


# --------------------------------------------------------------------- pool
_pool: Optional[ThreadPoolExecutor] = None  # guarded-by: _pool_lock
_pool_width = 0  # guarded-by: _pool_lock
_pool_lock = threading.Lock()


def get_pool() -> ThreadPoolExecutor:
    """Process-wide reusable executor (created lazily, resized on demand)."""
    global _pool, _pool_width
    w = workers()
    with _pool_lock:
        if _pool is None or _pool_width < w:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=w, thread_name_prefix=_THREAD_PREFIX)
            _pool_width = w
        return _pool


def _reset_pool_after_fork() -> None:  # the child must not reuse parent threads
    global _pool, _pool_width
    # At-fork child handler: exactly one thread exists in the child, and
    # taking the lock here could deadlock on a parent thread's hold
    # snapshotted by fork.
    _pool = None     # ralint: allow=guarded-by -- single-threaded at-fork child
    _pool_width = 0  # ralint: allow=guarded-by -- single-threaded at-fork child


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_pool_after_fork)


def on_engine_thread() -> bool:
    return threading.current_thread().name.startswith(_THREAD_PREFIX)


def _parallel_ok(nbytes: int) -> bool:
    return (
        nbytes >= parallel_min()
        and workers() > 1
        and not sequential_forced()
        and not on_engine_thread()
    )


def run_tasks(tasks: Sequence[Callable[[], None]]) -> None:
    """Run callables on the shared pool; re-raise the first failure."""
    if not tasks:
        return
    if len(tasks) == 1 or workers() == 1 or sequential_forced() or on_engine_thread():
        for t in tasks:
            t()
        return
    futures = [get_pool().submit(t) for t in tasks]
    err = None
    for f in futures:
        try:
            f.result()
        except BaseException as e:  # drain all futures before raising
            err = err or e
    if err is not None:
        raise err


# ------------------------------------------------------------ positioned I/O
def _writable_byte_view(view) -> memoryview:
    mv = view if isinstance(view, memoryview) else memoryview(view)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def pread_into(fd, offset: int, view) -> int:
    """Read ``len(view)`` bytes at ``offset`` into ``view`` (short-read loop).

    ``fd`` is either an ``int`` file descriptor or any object exposing
    ``pread_into(offset, view)`` — e.g. ``repro.remote.RemoteReader`` — so
    every slab/span/gather plan in this module works unchanged over
    non-local sources."""
    mv = _writable_byte_view(view)
    if not isinstance(fd, int):
        return fd.pread_into(offset, mv)
    want = mv.nbytes
    got = 0
    while got < want:
        n = _preadv(fd, [mv[got:]], offset + got)
        if n <= 0:
            raise RawArrayError(
                f"truncated read: wanted {want} bytes at offset {offset}, got {got}"
            )
        got += n
    return got


def pwrite_from(fd: int, offset: int, view) -> int:
    """Write all of ``view`` at ``offset`` (short-write loop)."""
    mv = view if isinstance(view, memoryview) else memoryview(view)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    want = mv.nbytes
    put = 0
    while put < want:
        n = _pwritev(fd, [mv[put:]], offset + put)
        if n <= 0:
            raise OSError(f"short write at offset {offset + put}")
        put += n
    return put


def chunk_spans(offset: int, length: int, chunk: Optional[int] = None) -> List[Tuple[int, int]]:
    """Split [offset, offset+length) into slabs aligned to absolute multiples
    of ``chunk`` (so concurrent slabs never share a page-cache chunk)."""
    chunk = chunk or chunk_bytes()
    spans: List[Tuple[int, int]] = []
    pos = offset
    end = offset + length
    while pos < end:
        nxt = min(end, (pos // chunk + 1) * chunk)
        spans.append((pos, nxt - pos))
        pos = nxt
    return spans


def parallel_read_into(
    fd: int,
    offset: int,
    view,
    *,
    nworkers: Optional[int] = None,
    chunk: Optional[int] = None,
) -> int:
    """Fill ``view`` from ``fd`` at ``offset`` with slab-parallel preads.

    Falls back to one sequential positioned read below ``parallel_min`` or
    whenever parallelism is disabled. Returns bytes read; raises
    ``RawArrayError`` if the file ends early.
    """
    mv = _writable_byte_view(view)
    nbytes = mv.nbytes
    if nbytes == 0:
        return 0
    force = nworkers is not None and nworkers > 1
    if not force and (nworkers == 1 or not _parallel_ok(nbytes)):
        return pread_into(fd, offset, mv)
    spans = chunk_spans(offset, nbytes, chunk)
    if len(spans) == 1:
        return pread_into(fd, offset, mv)

    def job(span: Tuple[int, int]) -> None:
        off, ln = span
        rel = off - offset
        pread_into(fd, off, mv[rel : rel + ln])

    run_tasks([(lambda s=s: job(s)) for s in spans])
    return nbytes


class _SpanJob(NamedTuple):
    fd: object  # int fd or positioned-read object (see pread_into)
    offset: int
    view: memoryview


def _flatten_spans(jobs: Sequence[Tuple[object, int, object]]) -> Tuple[List[_SpanJob], int]:
    flat: List[_SpanJob] = []
    total = 0
    for fd, off, view in jobs:
        mv = _writable_byte_view(view)
        if mv.nbytes == 0:
            continue
        total += mv.nbytes
        for soff, sln in chunk_spans(off, mv.nbytes):
            rel = soff - off
            flat.append(_SpanJob(fd, soff, mv[rel : rel + sln]))
    return flat, total


def span_read_tasks(jobs: Sequence[Tuple[object, int, object]]) -> List[Callable[[], None]]:
    """Flatten (fd, offset, view) reads into slab-granular zero-arg tasks —
    the building blocks ``parallel_read_spans`` runs as one wave. Callers
    that also have non-pread work (e.g. chunk decode tasks, DESIGN.md §10)
    concatenate the lists and submit ONE ``run_tasks`` wave so both kinds
    of work share the pool with no barrier between them."""
    flat, _ = _flatten_spans(jobs)
    return [(lambda j=j: pread_into(j.fd, j.offset, j.view)) for j in flat]


def parallel_read_spans(jobs: Sequence[Tuple[object, int, object]]) -> int:
    """One pool wave over many (fd, offset, view) reads — possibly spanning
    multiple files (or remote readers; see ``pread_into``). Each large view
    is further slab-split; everything is submitted together so cross-file
    and intra-file parallelism share the same wave (no nested waiting)."""
    flat, total = _flatten_spans(jobs)
    if not flat:
        return 0
    if len(flat) == 1 or not _parallel_ok(total):
        for j in flat:
            pread_into(j.fd, j.offset, j.view)
        return total
    run_tasks([(lambda j=j: pread_into(j.fd, j.offset, j.view)) for j in flat])
    return total


def parallel_write(
    fd: int,
    offset: int,
    views: Sequence[object],
    *,
    nworkers: Optional[int] = None,
    chunk: Optional[int] = None,
) -> int:
    """Write ``views`` back-to-back starting at ``offset`` via slab-parallel
    pwrites. The caller should ``os.ftruncate`` the file to its final size
    first when extending (concurrent pwrite past EOF is fine on Linux, but a
    preallocated length avoids interleaved extension). Returns bytes written."""
    mvs = []
    total = 0
    for v in views:
        mv = v if isinstance(v, memoryview) else memoryview(v)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            mvs.append(mv)
            total += mv.nbytes
    if not total:
        return 0
    force = nworkers is not None and nworkers > 1
    if not force and (nworkers == 1 or not _parallel_ok(total)):
        pos = offset
        for mv in mvs:
            pwrite_from(fd, pos, mv)
            pos += mv.nbytes
        return total
    tasks = []
    pos = offset
    for mv in mvs:
        for soff, sln in chunk_spans(pos, mv.nbytes, chunk):
            rel = soff - pos
            tasks.append(
                lambda m=mv[rel : rel + sln], o=soff: pwrite_from(fd, o, m)
            )
        pos += mv.nbytes
    run_tasks(tasks)
    return total


# ------------------------------------------------------------- scratch pool
# Reusable bounce buffers for coalesced gathers. Reuse matters beyond malloc
# cost: a recycled buffer is already page-faulted, and on this class of
# kernel fault handling is the single-threaded bottleneck (see DESIGN.md §8).
_scratch_lock = threading.Lock()
_scratch_bufs: List[np.ndarray] = []  # guarded-by: _scratch_lock
_SCRATCH_KEEP = 16


def acquire_scratch(nbytes: int) -> np.ndarray:
    """Get a uint8 scratch array of at least ``nbytes`` (may be larger)."""
    with _scratch_lock:
        best = None
        for i, b in enumerate(_scratch_bufs):
            if b.nbytes >= nbytes and (best is None or b.nbytes < _scratch_bufs[best].nbytes):
                best = i
        if best is not None:
            return _scratch_bufs.pop(best)
    return np.empty(nbytes, np.uint8)


def release_scratch(buf: np.ndarray) -> None:
    with _scratch_lock:
        if len(_scratch_bufs) < _SCRATCH_KEEP:
            _scratch_bufs.append(buf)


# ---------------------------------------------------------------- coalesce
class Run(NamedTuple):
    """One coalesced ranged read: rows [lo, hi) serve ``sel`` (positions into
    the original index array)."""

    lo: int
    hi: int
    sel: np.ndarray  # positions into the caller's index array, sorted by row


def coalesce(
    indices: np.ndarray,
    *,
    gap: Optional[int] = None,
    min_run: Optional[int] = None,
) -> Tuple[List[Run], np.ndarray]:
    """Plan scattered row reads: merge adjacent/near-adjacent requests.

    ``indices`` may be unsorted and contain duplicates. Returns ``(runs,
    leftover)`` where each ``Run`` covers >= ``min_run`` requested rows whose
    sorted values have gaps <= ``gap`` (read amplification is bounded by
    ``gap + 1``), and ``leftover`` holds the positions of requests too sparse
    to be worth a ranged read (the caller services those point-wise).
    The union of all ``run.sel`` and ``leftover`` is exactly
    ``arange(len(indices))``.
    """
    indices = np.asarray(indices)
    if indices.size == 0:
        return [], np.empty(0, np.intp)
    order = np.argsort(indices, kind="stable")
    return coalesce_sorted(indices[order], order, gap=gap, min_run=min_run)


def coalesce_sorted(
    svals: np.ndarray,
    positions: np.ndarray,
    *,
    gap: Optional[int] = None,
    min_run: Optional[int] = None,
) -> Tuple[List[Run], np.ndarray]:
    """``coalesce`` for already-sorted row values (``positions[i]`` is where
    ``svals[i]`` lands in the caller's output). Fully vectorized so a sparse
    request (hundreds of singleton segments) costs one pass, not a Python
    loop per segment."""
    gap = gather_gap() if gap is None else gap
    min_run = gather_min_run() if min_run is None else min_run
    # break where the sorted row distance exceeds the merge gap (+1 = adjacent)
    brk = np.nonzero(np.diff(svals) > gap + 1)[0] + 1
    starts = np.concatenate([[0], brk])
    stops = np.concatenate([brk, [len(svals)]])
    lens = stops - starts
    dense = lens >= min_run
    if not dense.any():
        return [], positions
    runs = [
        Run(int(svals[a]), int(svals[b - 1]) + 1, positions[a:b])
        for a, b in zip(starts[dense], stops[dense])
    ]
    leftover = positions[~np.repeat(dense, lens)]
    return runs, leftover

"""Parallel byte-range HTTP client for remote RawArray files (DESIGN.md §9).

``RemoteReader`` implements the same positioned-read interface the parallel
I/O engine consumes for local file descriptors — ``pread_into(offset,
view)`` — so every engine-planned slab/gather wave (single files, sharded
stores, datasets, checkpoint restores) works unchanged over the network:
the engine fans slabs out over its thread pool and each slab becomes a
concurrent ranged ``GET`` on a pooled connection.

Between the reader and the sockets sits a block-aligned LRU cache
(``repro_torch.remote.cache``): reads are decomposed into cache blocks, runs of
missing blocks are coalesced into one ranged request, and repeated epoch
traversals are served from RAM.

Module-level helpers mirror ``repro_torch.core.io`` one-for-one: ``remote_read``
/ ``remote_read_into`` / ``remote_header_of`` / ``remote_read_metadata``.

The write direction (DESIGN.md §11) mirrors the local ingest plane:
``upload_bytes`` is one whole-object PUT with server-side atomic publish
(``core.io.write`` dispatches URL writes to it), and ``RemoteWriter`` is
the incremental ``RaWriter`` whose byte sink is the server's
append/patch/commit/abort upload session — identical interface, identical
bytes, streamed over authenticated PUTs (token knob ``RA_REMOTE_TOKEN``).

Failure semantics: a dead server, a mid-transfer disconnect, or a range the
server cannot satisfy raises ``RawArrayError`` after bounded retries on
fresh connections — never a hang (sockets carry a timeout, knob
``RA_REMOTE_TIMEOUT``). Upload *appends* are the exception: they are never
blind-retried (a half-applied append would desynchronize the session and
the server answers 409 with its actual part size instead). Consecutive
connection *refusals* trip a per-host :class:`CircuitBreaker` (DESIGN.md
§14): once open, every call to that host fails in microseconds instead of
re-burning its retry budget — what lets the fleet router fail over to the
next ring node as soon as a replica dies.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union
from urllib.parse import urlsplit
import zlib

import numpy as np

from ..core import codec as chunked_codec
from ..core import engine
from ..core.header import Header, decode_header
from ..core.io import RaWriter as _io_RaWriter, _read_stats_src, is_url, read_chunked
from ..core.stats import split_stats as _split_stats
from ..core.spec import (
    FLAG_CHUNKED,
    FLAG_CRC32_TRAILER,
    FLAG_ZLIB,
    RawArrayError,
    env_float as _env_float,
    env_int as _env_int,
    env_str as _env_str,
)
from .cache import BlockCache, shared_cache


class RemoteAuthError(RawArrayError):
    """The server refused the request for AUTH reasons (HTTP 401/403,
    the PR token-auth plane of DESIGN.md §11). Deliberately distinct from
    transient transport failures: retrying a rejected credential can never
    succeed, so every retry loop in this module fails fast on it instead of
    burning its retry budget as if the error were transient."""


def _raise_for_auth(status: int, url: str, what: str) -> None:
    """Fail fast on 401/403 — wrong or missing bearer token is permanent."""
    if status in (401, 403):
        raise RemoteAuthError(
            f"{what} {url} refused by server auth: HTTP {status} "
            f"(check the bearer token — RA_REMOTE_TOKEN or token=; "
            f"not retried: credential errors are not transient)"
        )


class CircuitBreaker:
    """Per-host connection-refused circuit breaker (DESIGN.md §14).

    A dead host refuses connections instantly, but a bounded retry loop
    still burns its whole budget (fresh connection per attempt) before
    raising — and every *subsequent* call pays the same budget again. That
    is exactly wrong for fleet failover, where the router needs a dead
    replica to fail in microseconds so it can walk to the next ring node.

    State machine: ``RA_REMOTE_BREAKER_FAILS`` consecutive refusals, each
    within ``RA_REMOTE_BREAKER_WINDOW`` seconds of the previous one, OPEN
    the circuit — :meth:`check` then raises immediately, no socket touched —
    for ``RA_REMOTE_BREAKER_COOLDOWN`` seconds. After the cooldown the
    circuit is half-open: callers flow again, but one more refusal re-opens
    it instantly (the count stays primed), while one success fully closes
    it. Only ``ConnectionRefusedError`` trips it: refusal is the one failure
    mode that is both instant and overwhelmingly likely to persist; slow
    faults (timeouts, resets mid-entity) keep their normal retry budget."""

    def __init__(self, fails: Optional[int] = None, window: Optional[float] = None,
                 cooldown: Optional[float] = None):
        self.fails = max(1, _env_int("RA_REMOTE_BREAKER_FAILS", 3)) if fails is None else int(fails)
        self.window = _env_float("RA_REMOTE_BREAKER_WINDOW", 10.0) if window is None else float(window)
        self.cooldown = _env_float("RA_REMOTE_BREAKER_COOLDOWN", 1.0) if cooldown is None else float(cooldown)
        self._lock = threading.Lock()
        self._count = 0       # guarded-by: _lock
        self._last = 0.0      # guarded-by: _lock
        self._open_until = 0.0  # guarded-by: _lock

    def check(self, what: str = "") -> None:
        """Raise ``RawArrayError`` at once if the circuit is open; a no-op
        (closed or half-open) otherwise. Call before touching a socket."""
        with self._lock:
            if time.monotonic() < self._open_until:
                raise RawArrayError(
                    f"circuit open{f' for {what}' if what else ''}: host refused "
                    f"{self._count} consecutive connections; failing fast for "
                    f"{self.cooldown:g}s (knobs RA_REMOTE_BREAKER_FAILS/"
                    f"WINDOW/COOLDOWN)"
                )

    def record_refusal(self) -> bool:
        """Count one connection refusal; returns True when the circuit is
        (now) open, so retry loops can stop burning their budget."""
        now = time.monotonic()
        with self._lock:
            if now - self._last > self.window:
                self._count = 0  # stale streak: refusals must cluster
            self._last = now
            self._count += 1
            if self._count >= self.fails:
                self._count = self.fails  # stay primed while half-open
                self._open_until = now + self.cooldown
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._count = 0
            self._open_until = 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "consecutive_refusals": self._count,
                "open": float(time.monotonic() < self._open_until),
            }


_breakers: Dict[Tuple[str, Optional[int]], CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(host: str, port: Optional[int]) -> CircuitBreaker:
    """Process-wide breaker shared by every client of one ``host:port`` —
    a reader pool, ``fetch_bytes``, the upload plane, and the fleet router
    all see (and contribute to) the same host health."""
    key = (host or "", port)
    with _breakers_lock:
        brk = _breakers.get(key)
        if brk is None:
            brk = _breakers[key] = CircuitBreaker()
        return brk


def reset_breakers() -> None:
    """Forget every per-host breaker (tests/benchmarks: cold start)."""
    with _breakers_lock:
        _breakers.clear()


def default_conns() -> int:
    """Connection-pool width per reader (knob ``RA_REMOTE_CONNS``)."""
    return max(1, _env_int("RA_REMOTE_CONNS", 8))


def default_timeout() -> float:
    """Per-socket-operation timeout in seconds (knob ``RA_REMOTE_TIMEOUT``)."""
    return _env_float("RA_REMOTE_TIMEOUT", 30.0)


class _ConnPool:
    """Bounded pool of keep-alive HTTP connections. ``acquire`` blocks when
    ``limit`` connections are in flight, so an arbitrarily wide engine wave
    degrades to queueing, not to unbounded sockets."""

    def __init__(self, scheme: str, host: str, port: Optional[int], limit: int, timeout: float):
        self.scheme = scheme
        self.host = host
        self.port = port
        self.timeout = timeout
        self.limit = limit
        self._sem = threading.BoundedSemaphore(limit)
        self._lock = threading.Lock()
        self._free: List[http.client.HTTPConnection] = []  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock

    def _new_conn(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        return cls(self.host, self.port, timeout=self.timeout)

    def acquire(self) -> http.client.HTTPConnection:
        self._sem.acquire()
        with self._lock:
            if self._free:
                return self._free.pop()
        return self._new_conn()

    def release(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if self._closed:
                conn.close()
            else:
                self._free.append(conn)
        self._sem.release()

    def prewarm(self, n: int) -> int:
        """Eagerly open up to ``n`` keep-alive connections (capped at the
        pool limit) and park them in the free list, so the first parallel
        read wave starts with established sockets instead of serializing
        TCP/TLS handshakes inside it (DESIGN.md §13). Connect errors are
        swallowed — the regular acquire path reports them with its usual
        retry/raise contract. Returns the number of sockets opened."""
        with self._lock:
            if self._closed:
                return 0
            want = max(0, min(n, self.limit) - len(self._free))
        made: List[http.client.HTTPConnection] = []
        for _ in range(want):
            c = self._new_conn()
            try:
                c.connect()
            except OSError:
                break
            made.append(c)
        with self._lock:
            if self._closed:
                pass  # close below, outside the lock
            else:
                self._free.extend(made)
                return len(made)
        for c in made:
            try:
                c.close()
            except Exception:
                pass
        return 0

    def discard(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except Exception:
            pass
        self._sem.release()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            free, self._free = self._free, []
        for c in free:
            try:
                c.close()
            except Exception:
                pass


class RemoteReader:
    """Positioned-read view of one remote object.

    Engine-compatible: ``engine.pread_into(reader, offset, view)`` and every
    plan built on it treat a reader exactly like a file descriptor. The
    object's size and ETag are pinned by one ``HEAD`` at construction; a
    response whose ETag no longer matches raises (the file changed under a
    running traversal) rather than silently mixing versions.
    """

    def __init__(
        self,
        url: str,
        *,
        conns: Optional[int] = None,
        timeout: Optional[float] = None,
        retries: int = 2,
        cache: Optional[BlockCache] = None,
        use_cache: bool = True,
        pinned: Optional[Tuple[int, Optional[str]]] = None,
    ):
        if not is_url(url):
            raise RawArrayError(f"not an http(s) URL: {url!r}")
        self.url = url
        parts = urlsplit(url)
        self._path = parts.path or "/"
        if parts.query:
            self._path += "?" + parts.query
        self.retries = max(0, retries)
        self._pool = _ConnPool(
            parts.scheme, parts.hostname or "", parts.port,
            conns or default_conns(), default_timeout() if timeout is None else timeout,
        )
        self._breaker = breaker_for(parts.hostname or "", parts.port)
        self.cache = (cache if cache is not None else shared_cache()) if use_cache else None
        # a caller that already holds the object's (size, etag) — e.g. from
        # one stat_dir() listing covering a whole checkpoint — skips the
        # per-object HEAD; the first ranged response still verifies its
        # ETag against the pin, so a stale listing fails loudly, not late
        self.size, self.etag = self._stat() if pinned is None else (int(pinned[0]), pinned[1])
        # cache tag pins URL + version: a changed ETag can never hit stale blocks
        self._tag = f"{url}@{self.etag or ''}"
        self._closed = False

    # ---- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        self._pool.close()

    def prewarm(self, n: Optional[int] = None) -> int:
        """Pre-open up to ``n`` pooled sockets (default: the full pool width,
        knob ``RA_REMOTE_CONNS``) so a following engine wave pays zero
        handshakes. Returns sockets actually opened (0 when already warm)."""
        return self._pool.prewarm(self._pool.limit if n is None else n)

    def __enter__(self) -> "RemoteReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort socket cleanup
        try:
            self.close()
        except Exception:
            pass

    # ---- raw HTTP ----------------------------------------------------------
    def _stat(self) -> Tuple[int, Optional[str]]:
        err: Optional[BaseException] = None
        for _ in range(self.retries + 1):
            self._breaker.check(self.url)
            conn = self._pool.acquire()
            try:
                conn.request("HEAD", self._path)
                resp = conn.getresponse()
                resp.read()  # HEAD has no body; settle the connection state
                self._breaker.record_success()
                if resp.status != 200:
                    self._pool.release(conn)
                    _raise_for_auth(resp.status, self.url, "stat of")
                    raise RawArrayError(
                        f"remote stat failed: HTTP {resp.status} for {self.url}"
                    )
                length = resp.getheader("Content-Length")
                if length is None:
                    self._pool.release(conn)
                    raise RawArrayError(f"no Content-Length from server for {self.url}")
                etag = resp.getheader("ETag")
                self._pool.release(conn)
                return int(length), etag
            except ConnectionRefusedError as e:
                self._pool.discard(conn)
                err = e
                if self._breaker.record_refusal():
                    break  # circuit open: stop burning the retry budget
            except (OSError, http.client.HTTPException) as e:
                self._pool.discard(conn)
                err = e
        raise RawArrayError(f"cannot reach remote server for {self.url}: {err!r}")

    def _ranged_into(self, offset: int, view: memoryview) -> None:
        """One ranged GET filling ``view`` exactly; retries on transport
        errors with a fresh connection, raises ``RawArrayError`` on protocol
        problems (bad status, short entity, version change)."""
        length = view.nbytes
        if length == 0:
            return
        last = offset + length - 1
        err: Optional[BaseException] = None
        for _ in range(self.retries + 1):
            self._breaker.check(self.url)
            conn = self._pool.acquire()
            try:
                conn.request("GET", self._path, headers={"Range": f"bytes={offset}-{last}"})
                resp = conn.getresponse()
                self._breaker.record_success()
                try:
                    whole = resp.status == 200 and offset == 0 and length == self.size
                    if resp.status != 206 and not whole:
                        _raise_for_auth(resp.status, self.url, "ranged read of")
                        raise RawArrayError(
                            f"range [{offset}, {offset + length}) of {self.url} "
                            f"not satisfiable: HTTP {resp.status}"
                        )
                    etag = resp.getheader("ETag")
                    if self.etag and etag and etag != self.etag:
                        raise RawArrayError(
                            f"{self.url} changed on server during read "
                            f"(ETag {self.etag} -> {etag})"
                        )
                    clen = resp.getheader("Content-Length")
                    if clen is not None and int(clen) != length:
                        raise RawArrayError(
                            f"truncated range: wanted {length} bytes at {offset} "
                            f"of {self.url}, server offered {clen}"
                        )
                    got = 0
                    while got < length:
                        n = resp.readinto(view[got:])
                        if not n:
                            # server hung up mid-entity: transport-level, retry
                            raise ConnectionError(
                                f"connection closed after {got}/{length} bytes"
                            )
                        got += n
                except RawArrayError:
                    self._pool.discard(conn)
                    raise
                self._pool.release(conn)
                return
            except ConnectionRefusedError as e:
                self._pool.discard(conn)
                err = e
                if self._breaker.record_refusal():
                    break  # circuit open: stop burning the retry budget
            except (OSError, http.client.HTTPException) as e:
                self._pool.discard(conn)
                err = e
        raise RawArrayError(
            f"remote read of {self.url} [{offset}, {offset + length}) failed "
            f"after {self.retries + 1} attempts: {err!r}"
        )

    # ---- positioned reads (the engine-facing interface) --------------------
    def pread_into(self, offset: int, view) -> int:
        """Fill ``view`` from the remote object at ``offset`` (block-cached).

        This is the method ``engine.pread_into`` dispatches to for non-fd
        sources; thread-safe, so engine slab waves call it concurrently."""
        mv = view if isinstance(view, memoryview) else memoryview(view)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        n = mv.nbytes
        if n == 0:
            return 0
        if offset < 0 or offset + n > self.size:
            raise RawArrayError(
                f"truncated read: wanted {n} bytes at offset {offset}, "
                f"remote object {self.url} has {self.size}"
            )
        if self.cache is None:
            self._ranged_into(offset, mv)
            return n
        block = self.cache.block_bytes
        b0, b1 = offset // block, (offset + n - 1) // block
        missing: List[int] = []
        for bi in range(b0, b1 + 1):
            data = self.cache.get(self._tag, bi)
            if data is None:
                missing.append(bi)
            else:
                self._copy_cached(bi, data, offset, mv)
        # coalesce consecutive missing blocks into single ranged requests
        i = 0
        while i < len(missing):
            j = i
            while j + 1 < len(missing) and missing[j + 1] == missing[j] + 1:
                j += 1
            self._fetch_blocks(missing[i], missing[j], offset, mv)
            i = j + 1
        return n

    def _copy_cached(self, bi: int, data: bytes, offset: int, mv: memoryview) -> None:
        """Copy the part of cached block ``bi`` that the request covers."""
        blk_off = bi * self.cache.block_bytes
        a = max(offset, blk_off)
        b = min(offset + mv.nbytes, blk_off + len(data))
        if b <= a:
            raise RawArrayError(f"short cache block {bi} of {self.url}: object shrank?")
        mv[a - offset : b - offset] = data[a - blk_off : b - blk_off]

    def _fetch_blocks(self, lo: int, hi: int, offset: int, mv: memoryview) -> None:
        """Fetch missing blocks [lo, hi] for a request at ``offset``.

        Blocks interior to the request stream in one ranged GET *directly
        into the destination* (zero scratch; the cache copy is materialized
        from the destination afterwards). The at-most-two edge blocks that
        stick out of the request are fetched whole through a one-block
        scratch so they are cacheable in full."""
        block = self.cache.block_bytes
        end = offset + mv.nbytes

        def _interior(bi: int) -> bool:
            return bi * block >= offset and min((bi + 1) * block, self.size) <= end

        bi = lo
        while bi <= hi:
            if _interior(bi):
                bj = bi
                while bj + 1 <= hi and _interior(bj + 1):
                    bj += 1
                fa = bi * block
                fb = min((bj + 1) * block, self.size)
                dst = mv[fa - offset : fb - offset]
                self._ranged_into(fa, dst)
                for k in range(bi, bj + 1):
                    ka = k * block - fa
                    kb = min((k + 1) * block, self.size) - fa
                    self.cache.put(self._tag, k, bytes(dst[ka:kb]))
                bi = bj + 1
            else:
                fa = bi * block
                fb = min(fa + block, self.size)
                buf = bytearray(fb - fa)
                self._ranged_into(fa, memoryview(buf))
                data = bytes(buf)
                self.cache.put(self._tag, bi, data)
                self._copy_cached(bi, data, offset, mv)
                bi += 1

    def pread_into_naive(self, offset: int, view) -> int:
        """Single-stream baseline: one block-granular ranged request at a
        time on one connection — no coalescing, no concurrency, no cache
        (the access pattern of a generic block-oriented remote reader).
        Kept (like ``read_slice_naive`` / ``gather_naive``) for equivalence
        tests and as the benchmark baseline the parallel plane is measured
        against."""
        from .cache import default_block_bytes

        mv = view if isinstance(view, memoryview) else memoryview(view)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        n = mv.nbytes
        if offset < 0 or offset + n > self.size:
            raise RawArrayError(
                f"truncated read: wanted {n} bytes at offset {offset}, "
                f"remote object {self.url} has {self.size}"
            )
        block = self.cache.block_bytes if self.cache else default_block_bytes()
        pos = 0
        while pos < n:
            ln = min(block, n - pos)
            self._ranged_into(offset + pos, mv[pos : pos + ln])
            pos += ln
        return n

    def read_range(self, offset: int, length: int) -> bytes:
        buf = bytearray(length)
        self.pread_into(offset, memoryview(buf))
        return bytes(buf)

    def cache_stats(self) -> Dict[str, int]:
        return self.cache.stats() if self.cache is not None else {}


# ------------------------------------------------------------ reader registry
# One long-lived reader per URL so shard/dataset/checkpoint traversals reuse
# warm connections and one shared block cache across calls. LRU-capped
# (knob ``RA_REMOTE_READERS``) so a many-thousand-file remote tree cannot
# accumulate keep-alive sockets until the process hits EMFILE; an evicted
# reader keeps working, it just opens per-call connections instead of
# pooling them.
_readers: "OrderedDict[str, RemoteReader]" = OrderedDict()
_readers_lock = threading.Lock()


def max_readers() -> int:
    return max(1, _env_int("RA_REMOTE_READERS", 64))


def get_reader(
    url: str,
    *,
    revalidate: bool = False,
    pinned: Optional[Tuple[int, Optional[str]]] = None,
) -> RemoteReader:
    """Pooled reader for ``url``. With ``revalidate=True`` a cached reader is
    re-HEADed first and silently replaced if the object's (size, ETag) moved —
    callers that pin a version set at a point in time (cold-start restore)
    use this so the pin reflects the server's *current* object, not whatever
    generation an earlier traversal happened to cache. ``pinned=(size,
    etag)`` — e.g. one entry of a :func:`stat_dir` listing — plays the same
    role with zero extra round trips: a cached reader is reused only if it
    already matches, and a fresh reader adopts the pin instead of HEADing."""
    stale: Optional[RemoteReader] = None
    with _readers_lock:
        r = _readers.get(url)
        if r is not None and not r._closed:
            _readers.move_to_end(url)
            if pinned is not None:
                if (r.size, r.etag) == (int(pinned[0]), pinned[1]):
                    return r
            elif not revalidate:
                return r
    if r is not None and not r._closed:
        if pinned is None:
            try:
                if r._stat() == (r.size, r.etag):
                    return r
            except Exception:
                pass  # unreachable/changed -> rebuild below, surfacing real errors
        stale = r
        with _readers_lock:
            if _readers.get(url) is stale:
                del _readers[url]
        try:
            stale.close()
        except Exception:
            pass
    r = RemoteReader(url, pinned=pinned)
    evicted: List[RemoteReader] = []
    with _readers_lock:
        cur = _readers.get(url)
        if cur is not None and not cur._closed:
            evicted.append(r)
            r = cur
        else:
            _readers[url] = r
            _readers.move_to_end(url)
            while len(_readers) > max_readers():
                _, old = _readers.popitem(last=False)
                evicted.append(old)
    for old in evicted:
        try:
            old.close()
        except Exception:
            pass
    return r


def close_readers() -> None:
    """Close and forget every pooled reader (tests/benchmarks: cold start)."""
    with _readers_lock:
        readers = list(_readers.values())
        _readers.clear()
    for r in readers:
        try:
            r.close()
        except Exception:
            pass


def fetch_bytes(url: str, *, timeout: Optional[float] = None, retries: int = 2) -> bytes:
    """Full-object GET (manifests, index.json, /header JSON) on an ephemeral
    connection — never pollutes the reader registry or the cache. Same
    failure contract as the reader: bounded retries on a fresh connection
    for transport errors, then ``RawArrayError``."""
    parts = urlsplit(url)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    cls = http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
    brk = breaker_for(parts.hostname or "", parts.port)
    err: Optional[BaseException] = None
    for _ in range(max(0, retries) + 1):
        brk.check(url)
        conn = cls(parts.hostname or "", parts.port,
                   timeout=default_timeout() if timeout is None else timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            brk.record_success()
            if resp.status != 200:
                _raise_for_auth(resp.status, url, "GET of")
                raise RawArrayError(f"GET {url} failed: HTTP {resp.status}")
            return body
        except ConnectionRefusedError as e:
            err = e
            if brk.record_refusal():
                break  # circuit open: stop burning the retry budget
        except (OSError, http.client.HTTPException) as e:
            err = e
        finally:
            conn.close()
    raise RawArrayError(f"GET {url} failed after {max(0, retries) + 1} attempts: {err!r}")


def stat_dir(dir_url: str, *, timeout: Optional[float] = None) -> Dict[str, Tuple[int, Optional[str]]]:
    """One-round-trip version-set listing: GET ``/stat/<dir>`` and return
    ``{name: (size, etag)}`` for every regular file in the directory. A
    cold-start restore feeds each entry to :func:`get_reader` as ``pinned``,
    replacing one HEAD per leaf with a single listing (the HTTP analogue of
    S3 ListObjectsV2, which also returns ETags). Raises ``RawArrayError`` if
    the server has no ``/stat/`` route (older servers → caller falls back to
    per-leaf HEAD pinning) or the listing is malformed."""
    parts = urlsplit(dir_url)
    stat_url = f"{parts.scheme}://{parts.netloc}/stat{parts.path or '/'}"
    body = fetch_bytes(stat_url, timeout=timeout)
    try:
        files = json.loads(body)["files"]
        return {str(k): (int(v["size"]), v.get("etag")) for k, v in files.items()}
    except (ValueError, KeyError, TypeError) as e:
        raise RawArrayError(f"malformed /stat listing from {stat_url}: {e!r}") from e


# ------------------------------------------------------------- upload plane
def default_token() -> Optional[str]:
    """Upload bearer token (knob ``RA_REMOTE_TOKEN``; DESIGN.md §11)."""
    return _env_str("RA_REMOTE_TOKEN") or None


def _views_of(data) -> Tuple[List[memoryview], int]:
    views = []
    total = 0
    for v in data if isinstance(data, (list, tuple)) else [data]:
        mv = v if isinstance(v, memoryview) else memoryview(v)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            views.append(mv)
            total += mv.nbytes
    return views, total


def _put(
    url: str,
    data,
    headers: Dict[str, str],
    *,
    token: Optional[str],
    timeout: Optional[float],
    retries: int,
    conn: Optional[http.client.HTTPConnection] = None,
) -> Tuple[int, bytes, Optional[http.client.HTTPConnection]]:
    """One authenticated PUT. ``data`` is bytes / a view / a list of views;
    the body streams piecewise with an explicit Content-Length (the server
    does not decode chunked encoding). With ``conn`` the request reuses a
    keep-alive connection and returns it (or a fresh one) for the next call;
    transport errors retry ``retries`` times on fresh connections."""
    tok = default_token() if token is None else token
    if not tok:
        raise RawArrayError(
            f"upload to {url} needs a bearer token (RA_REMOTE_TOKEN or token=)"
        )
    parts = urlsplit(url)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    views, total = _views_of(data)
    hdrs = dict(headers)
    hdrs["Authorization"] = f"Bearer {tok}"
    hdrs["Content-Length"] = str(total)
    cls = http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
    brk = breaker_for(parts.hostname or "", parts.port)
    err: Optional[BaseException] = None
    for attempt in range(max(0, retries) + 1):
        brk.check(url)
        c = conn
        conn = None
        if c is None:
            c = cls(parts.hostname or "", parts.port,
                    timeout=default_timeout() if timeout is None else timeout)
        try:
            c.request("PUT", path, body=iter(views), headers=hdrs)
            resp = c.getresponse()
            body = resp.read()
            brk.record_success()
            if resp.status in (401, 403):
                c.close()
                _raise_for_auth(resp.status, url, "upload to")
            return resp.status, body, c
        except ConnectionRefusedError as e:
            try:
                c.close()
            except Exception:
                pass
            err = e
            if brk.record_refusal() or retries == 0:
                break  # circuit open: stop burning the retry budget
        except (OSError, http.client.HTTPException) as e:
            try:
                c.close()
            except Exception:
                pass
            err = e
            if retries == 0:
                break
    raise RawArrayError(
        f"PUT {url} failed after {max(1, retries + 1)} attempts: {err!r}"
    )


def upload_bytes(
    url: str,
    data,
    *,
    token: Optional[str] = None,
    timeout: Optional[float] = None,
    retries: int = 2,
) -> int:
    """Whole-object authenticated upload with server-side ATOMIC publish
    (body → same-directory temp → fsync → rename; DESIGN.md §11). ``data``
    is bytes or a list of byte views (streamed without concatenation).
    Safe to retry: replaying the PUT just republishes the same bytes.
    Returns bytes uploaded. This is what ``core.io.write`` dispatches
    ``http(s)://`` destinations to."""
    views, total = _views_of(data)
    status, body, conn = _put(url, views, {}, token=token, timeout=timeout, retries=retries)
    if conn is not None:
        conn.close()
    if status not in (200, 201):
        raise RawArrayError(
            f"upload of {url} refused: HTTP {status} {body.decode(errors='replace').strip()}"
        )
    return total


class _UploadSink:
    """Remote byte sink for ``RaWriter`` (DESIGN.md §11): the same
    append/patch/commit/abort surface as the local temp-file sink, spoken
    as authenticated PUTs against the server's ``<path>.part`` upload
    session. Appends ride one keep-alive connection; commit renames the
    part into place server-side (the remote twin of fsync + rename)."""

    def __init__(self, url: str, *, token: Optional[str] = None, timeout: Optional[float] = None):
        if not is_url(url):
            raise RawArrayError(f"not an http(s) URL: {url!r}")
        self.url = url
        self._token = token
        self._timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None
        self.size = 0
        # reset the session: a predecessor SIGKILLed mid-stream leaves a
        # stale <path>.part server-side, which would 409 our first append
        # forever (sessions are single-writer; concurrent writers to one
        # path are unsupported and now clobber instead of deadlock)
        self._session_put("abort", b"", retries=1)

    def _session_put(self, mode: str, data, *, offset: Optional[int] = None,
                     retries: int = 0) -> None:
        headers = {"X-RA-Upload": mode}
        if offset is not None:
            headers["X-RA-Offset"] = str(offset)
        status, body, self._conn = _put(
            self.url, data, headers,
            token=self._token, timeout=self._timeout, retries=retries,
            conn=self._conn,
        )
        if status not in (200, 201):
            raise RawArrayError(
                f"upload {mode} of {self.url} at {offset} refused: HTTP {status} "
                f"{body.decode(errors='replace').strip()}"
            )

    def append(self, views) -> int:
        _, total = _views_of(views)
        # appends are NOT blind-retried: a replay after a half-applied body
        # would double bytes; the server's 409 (offset != part size) catches
        # any desync loudly instead
        self._session_put("append", views, offset=self.size)
        self.size += total
        return total

    def patch(self, offset: int, data) -> None:
        self._session_put("patch", data, offset=offset)

    def commit(self) -> None:
        self._session_put("commit", b"")
        self.close()

    def abort(self) -> None:
        try:
            self._session_put("abort", b"", retries=1)
        finally:
            self.close()

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None


class RemoteWriter(_io_RaWriter):
    """Incremental RawArray writer streaming to a URL (DESIGN.md §11).

    Exactly ``core.io.RaWriter`` — same row-batch interface, same chunk-
    parallel compression, same finalize patch order, byte-identical output —
    with the byte sink swapped for the server's authenticated upload
    session: bytes accumulate in ``<path>.part`` server-side and the final
    commit atomically renames them into place, so a dropped client never
    publishes a partial object::

        with RemoteWriter(f"{server.url}/out.ra", np.float32, (256,),
                          token=TOKEN, chunked=True) as w:
            for batch in batches:
                w.write_rows(batch)
    """

    def __init__(
        self,
        url: str,
        dtype,
        row_shape: Tuple[int, ...] = (),
        *,
        token: Optional[str] = None,
        timeout: Optional[float] = None,
        crc32: bool = False,
        chunked: bool = False,
        codec: Optional[str] = None,
        chunk_bytes: Optional[int] = None,
        metadata: Optional[bytes] = None,
        stats: bool = False,
    ):
        super().__init__(
            url, dtype, row_shape,
            crc32=crc32, chunked=chunked, codec=codec, chunk_bytes=chunk_bytes,
            metadata=metadata, stats=stats,
            sink=_UploadSink(url, token=token, timeout=timeout),
        )


# ----------------------------------------------------- io.py mirror functions
def _header_url(url: str) -> str:
    parts = urlsplit(url)
    base = f"{parts.scheme}://{parts.netloc}"
    return base + "/header" + (parts.path or "/")


def remote_header_of(url: str, *, strict_flags: bool = True) -> Header:
    """Decode the header of a remote file.

    Fast path: the server's ``/header/<path>`` endpoint returns the decoded
    header as JSON — one small response, no range arithmetic. Foreign
    byte-range servers (no such endpoint) fall back to a ranged read of the
    header bytes."""
    try:
        body = fetch_bytes(_header_url(url))
    except RawArrayError:
        body = None  # foreign server: no /header endpoint; use a ranged read
    if body is not None:
        try:
            d = json.loads(body)
            hdr = Header(
                flags=int(d["flags"]),
                eltype=int(d["eltype"]),
                elbyte=int(d["elbyte"]),
                data_length=int(d["data_length"]),
                shape=tuple(int(x) for x in d["shape"]),
            )
        except (KeyError, TypeError, ValueError):
            hdr = None  # not our endpoint's JSON shape
        if hdr is not None:
            hdr.validate(strict_flags=strict_flags)
            return hdr
    reader = get_reader(url)
    head = reader.read_range(0, min(reader.size, 4096))
    return decode_header(head, strict_flags=strict_flags)


def remote_read(
    url: str,
    *,
    with_metadata: bool = False,
    strict_flags: bool = True,
) -> Union[np.ndarray, Tuple[np.ndarray, bytes]]:
    """``core.io.read`` over HTTP: plain little-endian payloads stream via
    engine-parallel ranged reads straight into the output array; flagged
    payloads (zlib / CRC / big-endian) fetch the remainder and reuse the
    local decode logic."""
    reader = get_reader(url)
    head = reader.read_range(0, min(reader.size, 4096))
    hdr = decode_header(head, strict_flags=strict_flags)
    if hdr.flags & FLAG_CHUNKED:
        # chunk-parallel decode: the table is two small ranged reads, then
        # every chunk fetch is a ranged GET through the block cache (keyed
        # on stored byte ranges) + decompress straight into the output
        return read_chunked(reader, hdr, size=reader.size, with_metadata=with_metadata)
    if hdr.plain and not with_metadata:
        out = np.empty(hdr.shape, dtype=hdr.dtype())
        if hdr.data_length == 0:
            return out
        mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
        engine.parallel_read_into(reader, hdr.nbytes, mv)
        return out
    rest_len = reader.size - hdr.nbytes
    if rest_len < hdr.data_length:
        raise RawArrayError(
            f"truncated data segment: wanted {hdr.data_length}, got {rest_len}"
        )
    blob = bytearray(rest_len)
    if rest_len:
        engine.parallel_read_into(reader, hdr.nbytes, memoryview(blob))
    payload = bytes(blob[: hdr.data_length])
    trailer = bytes(blob[hdr.data_length :])
    meta = trailer
    if hdr.flags & FLAG_CRC32_TRAILER:
        if len(trailer) < 4:
            raise RawArrayError("CRC flag set but trailer missing")
        meta, crc = trailer[:-4], int.from_bytes(trailer[-4:], "little")
        if zlib.crc32(payload) != crc:
            raise RawArrayError("CRC32 mismatch: data segment corrupted")
    if hdr.flags & FLAG_ZLIB:
        payload = zlib.decompress(payload)
        if len(payload) != hdr.logical_nbytes:
            raise RawArrayError(
                f"decompressed payload is {len(payload)} bytes, header shape "
                f"{hdr.shape} x elbyte={hdr.elbyte} wants {hdr.logical_nbytes}"
            )
    dtype = hdr.dtype()
    arr = np.frombuffer(payload, dtype=dtype)
    if hdr.big_endian:
        arr = arr.astype(dtype.newbyteorder("<"))
    arr = arr.reshape(hdr.shape)
    if with_metadata:
        # user metadata follows the rastats block, if any (DESIGN.md §16)
        return arr, _split_stats(meta)[1]
    return arr


def remote_read_into(url: str, out: np.ndarray) -> np.ndarray:
    """``core.io.read_into`` over HTTP: stream the payload straight into a
    caller-owned preallocated array (the warm-epoch fast path — an
    already-faulted destination plus a warm block cache is a pure memcpy)."""
    reader = get_reader(url)
    head = reader.read_range(0, min(reader.size, 4096))
    hdr = decode_header(head)
    if tuple(out.shape) != hdr.shape:
        raise RawArrayError(f"read_into: out.shape {out.shape} != file {hdr.shape}")
    if out.dtype != hdr.dtype().newbyteorder("="):
        raise RawArrayError(f"read_into: out.dtype {out.dtype} != file {hdr.dtype()}")
    if not out.flags.c_contiguous:
        raise RawArrayError("read_into: out must be C-contiguous")
    if hdr.flags & FLAG_CHUNKED and not hdr.big_endian:
        if hdr.logical_nbytes:
            mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
            table = chunked_codec.read_table(reader, hdr)
            chunked_codec.decompress_into(reader, hdr, table, mv)
        return out
    if hdr.plain:
        if hdr.data_length:
            mv = memoryview(out.reshape(-1).view(np.uint8)).cast("B")
            engine.parallel_read_into(reader, hdr.nbytes, mv)
        return out
    out[...] = remote_read(url)
    return out


def remote_read_metadata(url: str) -> bytes:
    """Trailing user metadata of a remote file: header + one tail range
    (chunked files skip the trailer chunk table first — one more small
    ranged read of the table head)."""
    reader = get_reader(url)
    hdr = remote_header_of(url, strict_flags=False)
    start = hdr.nbytes + hdr.data_length
    if hdr.flags & FLAG_CHUNKED:
        start += chunked_codec.table_nbytes(reader, hdr)
    tail = reader.read_range(start, max(0, reader.size - start))
    if hdr.flags & FLAG_CRC32_TRAILER:
        tail = tail[:-4]
    return _split_stats(tail)[1]


def remote_read_stats(url: str):
    """Per-chunk ``rastats`` statistics of a remote file (DESIGN.md §16):
    header fast path + (for chunked files) the table-head range + two
    small tail ranges. The payload is never fetched, which is what makes
    predicate pushdown selectivity-proportional over HTTP — including
    through the fleet router, which proxies ranges unchanged."""
    reader = get_reader(url)
    hdr = remote_header_of(url, strict_flags=False)
    return _read_stats_src(reader, hdr, size=reader.size)

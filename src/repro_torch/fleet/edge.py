"""Per-replica read-through edge cache for the fleet tier (DESIGN.md §14).

``EdgeServer`` speaks the same byte-range dialect as the origin (Range
GET/HEAD with the origin's ETag, ``/header/`` and ``/stat/`` JSON views,
``/healthz`` + ``/metrics``) but serves from a three-level read-through
hierarchy: the remote plane's block LRU in RAM (``RA_FLEET_CACHE_MB``), a
local-disk spill tier (``RA_FLEET_SPILL_MB``; 0 disables), then the
origin over a cache-bypassing ``RemoteReader``. A miss is **single
flight**: when a thundering herd of clients lands on one cold block, one
leader fetches from the origin while every other request parks on an
event and shares the bytes — the ``coalesced_waits`` / ``origin_fetches``
counters in ``/metrics`` prove exactly one upstream fetch happened.

Consistency is ETag-scoped, like the rest of the remote plane: cached
blocks are keyed by ``path@etag``, the edge revalidates a path's ETag
against the origin at most every ``RA_FLEET_REVALIDATE`` seconds (0 =
every request), and a changed ETag drops every RAM and disk block of the
stale version before the new one is served. Responses always carry the
origin's ETag, so ``RemoteReader`` clients behind a router see the same
change-detection semantics as direct-origin reads.

``python -m repro_torch.fleet.edge http://origin:8000`` runs one standalone
edge replica.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote, urlsplit

from ..core.spec import RawArrayError, env_float, env_int
from ..remote.cache import BlockCache, default_block_bytes
from ..remote.client import RemoteReader
from . import _proxy

_COPY_CHUNK = 1 << 20


def default_edge_cache_bytes() -> int:
    """RAM tier capacity per edge (``RA_FLEET_CACHE_MB``, default 128)."""
    return max(1, env_int("RA_FLEET_CACHE_MB", 128)) << 20


def default_spill_bytes() -> int:
    """Disk spill tier capacity per edge (``RA_FLEET_SPILL_MB``, default
    512; 0 disables the tier)."""
    return max(0, env_int("RA_FLEET_SPILL_MB", 512)) << 20


def default_revalidate_s() -> float:
    """Seconds an origin ETag check stays fresh (``RA_FLEET_REVALIDATE``,
    default 1.0; 0 revalidates on every request)."""
    return max(0.0, env_float("RA_FLEET_REVALIDATE", 1.0))


class SpillCache:
    """Local-disk LRU spill tier below the RAM block cache.

    One file per ``(tag, block)`` under ``root`` — the tag (``path@etag``)
    is hashed into the filename, so a version change simply strands the old
    files until ``invalidate`` or LRU eviction unlinks them. All index
    mutations happen under one lock; file I/O is small (one cache block)
    and stays inside it for simplicity.
    """

    def __init__(self, root: str, capacity_bytes: Optional[int] = None):
        self.root = root
        self.capacity_bytes = (default_spill_bytes()
                               if capacity_bytes is None else int(capacity_bytes))
        self._lock = threading.Lock()
        # (tag, block) -> size, in LRU order (oldest first)
        self._index: "OrderedDict[Tuple[str, int], int]" = OrderedDict()  # guarded-by: _lock
        self._bytes = 0     # guarded-by: _lock
        self.hits = 0       # guarded-by: _lock
        self.misses = 0     # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def _stem(tag: str) -> str:
        return hashlib.sha1(tag.encode()).hexdigest()

    def _path(self, tag: str, block: int) -> str:
        return os.path.join(self.root, f"{self._stem(tag)}.{block}.blk")

    def get(self, tag: str, block: int) -> Optional[bytes]:
        key = (tag, block)
        with self._lock:
            if key not in self._index:
                self.misses += 1
                return None
            try:
                with open(self._path(tag, block), "rb") as f:
                    data = f.read()
            except OSError:
                self._bytes -= self._index.pop(key)
                self.misses += 1
                return None
            self._index.move_to_end(key)
            self.hits += 1
            return data

    def put(self, tag: str, block: int, data: bytes) -> None:
        if self.capacity_bytes <= 0 or len(data) > self.capacity_bytes:
            return
        key = (tag, block)
        path = self._path(tag, block)
        tmp = path + ".tmp"
        with self._lock:
            if key in self._index:
                return
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError:
                return
            self._index[key] = len(data)
            self._bytes += len(data)
            while self._bytes > self.capacity_bytes and self._index:
                old, sz = self._index.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1
                try:
                    os.unlink(self._path(*old))
                except OSError:
                    pass

    def invalidate(self, tag: str) -> int:
        """Unlink every spilled block of ``tag``; returns blocks dropped."""
        with self._lock:
            victims = [k for k in self._index if k[0] == tag]
            for key in victims:
                self._bytes -= self._index.pop(key)
                try:
                    os.unlink(self._path(*key))
                except OSError:
                    pass
            return len(victims)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "blocks": float(len(self._index)),
                "bytes": float(self._bytes),
                "capacity_bytes": float(self.capacity_bytes),
                "hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "hit_ratio": (self.hits / total) if total else 0.0,
            }


class _Flight:
    __slots__ = ("event", "result", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[bytes] = None
        self.exc: Optional[BaseException] = None


class SingleFlight:
    """Request coalescing: concurrent ``do(key, fn)`` calls for one key run
    ``fn`` exactly once (the leader); everyone else blocks on an event and
    shares the leader's result or exception. The flight table only holds
    in-progress keys, so completed work never pins memory."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: Dict[Tuple[str, int], _Flight] = {}  # guarded-by: _lock
        self.leaders = 0          # guarded-by: _lock
        self.coalesced_waits = 0  # guarded-by: _lock

    def do(self, key: Tuple[str, int], fn):
        with self._lock:
            fl = self._flights.get(key)
            if fl is None:
                fl = self._flights[key] = _Flight()
                leader = True
                self.leaders += 1
            else:
                leader = False
                self.coalesced_waits += 1
        if leader:
            try:
                fl.result = fn()
            except BaseException as exc:
                fl.exc = exc
            finally:
                with self._lock:
                    self._flights.pop(key, None)
                fl.event.set()
        else:
            fl.event.wait()
        if fl.exc is not None:
            raise fl.exc
        return fl.result


class _PathState:
    """Per-path edge state: the pinned origin reader plus revalidation
    bookkeeping. ``lock`` serializes (re)validation per path so a herd of
    first requests issues one origin HEAD, not hundreds."""

    __slots__ = ("lock", "reader", "etag", "size", "tag", "checked_at")

    def __init__(self):
        self.lock = threading.Lock()
        self.reader: Optional[RemoteReader] = None  # guarded-by: lock
        self.etag: Optional[str] = None             # guarded-by: lock
        self.size = 0          # guarded-by: lock
        self.tag = ""          # guarded-by: lock
        self.checked_at = -1e9  # guarded-by: lock


class _NotServable(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status
        self.msg = msg


class _EdgeHandler(_proxy.JsonResponderMixin, BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rawarray-edge/1"

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def log_request(self, code="-", size="-"):
        try:
            status = int(code)
        except (TypeError, ValueError):
            status = 0
        self.server.metrics.record(self.path.split("?", 1)[0], status)
        if self.server.verbose:
            super().log_request(code, size)

    def do_GET(self):
        self._route(head_only=False)

    def do_HEAD(self):
        self._route(head_only=True)

    def do_PUT(self):
        self._fail(405, "edge replicas are read-only; PUT to the origin")

    def _route(self, head_only: bool) -> None:
        srv: EdgeServer = self.server
        path = unquote(urlsplit(self.path).path)
        if path == "/healthz":
            self._send_json({"ok": True, "role": "edge", "origin": srv.origin,
                             "uptime_s": srv.metrics.snapshot()["uptime_s"]})
            return
        if path == "/metrics":
            self._send_json(srv.edge_metrics())
            return
        if path.startswith("/header/") or path.startswith("/stat/"):
            self._passthrough(path, head_only)
            return
        try:
            self._serve_entity(srv, path, head_only)
        except _NotServable as exc:
            self._fail(exc.status, exc.msg)

    def _passthrough(self, path: str, head_only: bool) -> None:
        """Relay the origin's JSON metadata views verbatim. These are tiny
        and already served from the origin's OS page cache; caching them
        here would only add a second staleness domain."""
        srv: EdgeServer = self.server
        try:
            resp = _proxy.upstream_request(srv.origin,
                                           "HEAD" if head_only else "GET",
                                           self.path, {})
            body = resp.read()
        except Exception as exc:
            self.close_connection = True
            self._fail(502, f"origin unreachable: {exc}")
            return
        self.send_response(resp.status)
        for name in _proxy.RELAY_HEADERS:
            val = resp.getheader(name)
            if val is not None:
                self.send_header(name, val)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not head_only:
            try:
                self.wfile.write(body)
            except OSError:
                self.close_connection = True

    def _serve_entity(self, srv: "EdgeServer", path: str, head_only: bool) -> None:
        st = srv.validated(path)
        inm = self.headers.get("If-None-Match")
        if inm and st["etag"] and inm == st["etag"]:
            self.send_response(304)
            self.send_header("ETag", st["etag"])
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        size = st["size"]
        try:
            rng = _proxy.parse_range(self.headers.get("Range"), size)
        except ValueError as exc:
            raise _NotServable(416, str(exc))
        start, stop = rng if rng is not None else (0, size)
        self.send_response(206 if rng is not None else 200)
        if st["etag"]:
            self.send_header("ETag", st["etag"])
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Type", "application/octet-stream")
        if rng is not None:
            self.send_header("Content-Range", f"bytes {start}-{stop - 1}/{size}")
        self.send_header("Content-Length", str(stop - start))
        self.end_headers()
        if head_only or stop <= start:
            return
        try:
            srv.write_span(st, start, stop, self.wfile)
        except OSError:
            self.close_connection = True
        except RawArrayError:
            # origin died (or the object changed) after headers committed:
            # the client sees a short body + dropped connection, never
            # silently wrong bytes
            self.close_connection = True


class EdgeServer(ThreadingHTTPServer):
    """One read-through cache replica in front of an origin. See module
    docstring; booted standalone via the CLI or in fleets via
    ``fleet.serve``."""

    daemon_threads = True
    request_queue_size = 256
    disable_nagle_algorithm = True

    def __init__(
        self,
        origin_url: str,
        address: Tuple[str, int] = ("127.0.0.1", 0),
        *,
        cache_bytes: Optional[int] = None,
        block_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
        spill_bytes: Optional[int] = None,
        revalidate_s: Optional[float] = None,
        verbose: bool = False,
    ):
        from ..remote.server import ServerMetrics

        self.origin = origin_url.rstrip("/")
        self.verbose = verbose
        self.block_bytes = default_block_bytes() if block_bytes is None else int(block_bytes)
        self.cache = BlockCache(
            capacity_bytes=(default_edge_cache_bytes()
                            if cache_bytes is None else int(cache_bytes)),
            block_bytes=self.block_bytes)
        cap = default_spill_bytes() if spill_bytes is None else int(spill_bytes)
        self.spill = SpillCache(spill_dir, cap) if (spill_dir and cap > 0) else None
        self.revalidate_s = (default_revalidate_s()
                             if revalidate_s is None else float(revalidate_s))
        self.metrics = ServerMetrics()
        self.flights = SingleFlight()
        self._paths: Dict[str, _PathState] = {}  # guarded-by: _paths_lock
        self._paths_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.origin_fetches = 0      # guarded-by: _stats_lock
        self.origin_bytes = 0        # guarded-by: _stats_lock
        self.invalidated_paths = 0   # guarded-by: _stats_lock
        self._fetches_by_path: Dict[str, int] = {}  # guarded-by: _stats_lock
        super().__init__(address, _EdgeHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    # -- origin validation -------------------------------------------------

    def _origin_stat(self, path: str) -> Tuple[int, Optional[str]]:
        """Status-aware HEAD of the origin entity (the reader's own stat
        folds every non-200 into one error string; the edge must map 404
        vs auth vs transport to distinct downstream statuses)."""
        try:
            resp = _proxy.upstream_request(self.origin, "HEAD", path, {})
            resp.read()
        except Exception as exc:
            raise _NotServable(502, f"origin unreachable: {exc}")
        if resp.status != 200:
            raise _NotServable(resp.status if resp.status in (401, 403, 404) else 502,
                               f"origin returned HTTP {resp.status} for {path}")
        length = resp.getheader("Content-Length")
        if length is None:
            raise _NotServable(502, f"origin sent no Content-Length for {path}")
        return int(length), resp.getheader("ETag")

    def validated(self, path: str, force: bool = False) -> Dict:
        """Per-path state with a fresh-enough origin ETag. On ETag change:
        close the stale reader, drop every RAM + disk block of the old
        version, re-pin. Returns a plain snapshot dict so handlers never
        race the next revalidation."""
        with self._paths_lock:
            st = self._paths.get(path)
            if st is None:
                st = self._paths[path] = _PathState()
        with st.lock:
            now = time.monotonic()
            stale = (st.reader is None or force
                     or now - st.checked_at >= self.revalidate_s)
            if stale:
                size, etag = self._origin_stat(path)
                if st.reader is not None and (etag != st.etag or size != st.size):
                    old_tag = st.tag
                    st.reader.close()
                    st.reader = None
                    self.cache.invalidate(old_tag)
                    if self.spill is not None:
                        self.spill.invalidate(old_tag)
                    with self._stats_lock:
                        self.invalidated_paths += 1
                if st.reader is None:
                    st.reader = RemoteReader(self.origin + path, use_cache=False,
                                             pinned=(size, etag))
                st.etag, st.size = etag, size
                st.tag = f"{path}@{etag or ''}"
                st.checked_at = now
            return {"path": path, "reader": st.reader, "etag": st.etag,
                    "size": st.size, "tag": st.tag}

    # -- block assembly ----------------------------------------------------

    def _fetch_block(self, st: Dict, bi: int) -> bytes:
        size = st["size"]
        fa = bi * self.block_bytes
        fb = min(fa + self.block_bytes, size)
        buf = bytearray(fb - fa)
        st["reader"].pread_into(fa, memoryview(buf))
        data = bytes(buf)
        with self._stats_lock:
            self.origin_fetches += 1
            self.origin_bytes += len(data)
            if len(self._fetches_by_path) < 1024 or st["path"] in self._fetches_by_path:
                self._fetches_by_path[st["path"]] = \
                    self._fetches_by_path.get(st["path"], 0) + 1
        self.cache.put(st["tag"], bi, data)
        if self.spill is not None:
            self.spill.put(st["tag"], bi, data)
        return data

    def block(self, st: Dict, bi: int) -> bytes:
        """One cache block of the entity: RAM, then disk spill (promoting
        back to RAM), then a single-flight origin fetch."""
        tag = st["tag"]
        data = self.cache.get(tag, bi)
        if data is not None:
            return data
        if self.spill is not None:
            data = self.spill.get(tag, bi)
            if data is not None:
                self.cache.put(tag, bi, data)
                return data
        return self.flights.do((tag, bi), lambda: self._fetch_block(st, bi))

    def write_span(self, st: Dict, start: int, stop: int, wfile) -> None:
        """Stream ``[start, stop)`` of the entity to ``wfile`` block by
        block — no full-span buffer, so a cold multi-GB coldstart read
        through the edge stays O(block) in RAM."""
        block = self.block_bytes
        for bi in range(start // block, (stop - 1) // block + 1):
            data = self.block(st, bi)
            lo = max(start - bi * block, 0)
            hi = min(stop - bi * block, len(data))
            wfile.write(data[lo:hi] if (lo, hi) != (0, len(data)) else data)

    # -- introspection -----------------------------------------------------

    def edge_metrics(self) -> Dict:
        snap = self.metrics.snapshot()
        with self._stats_lock:
            snap.update(
                role="edge",
                origin=self.origin,
                block_bytes=self.block_bytes,
                origin_fetches=self.origin_fetches,
                origin_bytes=self.origin_bytes,
                invalidated_paths=self.invalidated_paths,
                origin_fetches_by_path=dict(self._fetches_by_path),
            )
        with self.flights._lock:
            snap["coalesced_waits"] = self.flights.coalesced_waits
            snap["flight_leaders"] = self.flights.leaders
        snap["ram"] = self.cache.stats()
        snap["disk"] = self.spill.stats() if self.spill is not None else None
        return snap

    def close_readers(self) -> None:
        with self._paths_lock:
            states = list(self._paths.values())
        for st in states:
            with st.lock:
                if st.reader is not None:
                    st.reader.close()
                    st.reader = None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.edge",
        description="One read-through edge cache replica for a RawArray origin.")
    ap.add_argument("origin", help="origin base URL, e.g. http://127.0.0.1:8000")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--spill-dir", default=None,
                    help="directory for the disk spill tier (default: off)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    edge = EdgeServer(args.origin, (args.host, args.port),
                      spill_dir=args.spill_dir, verbose=args.verbose)
    print(f"edge: {edge.url} -> origin {edge.origin}")
    try:
        edge.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        edge.shutdown()
        edge.server_close()
        edge.close_readers()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

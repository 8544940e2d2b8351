"""Consistent-hash HTTP router/proxy for a replica fleet (DESIGN.md §14).

``Router`` fronts N replicas (normally ``fleet.edge`` read-through caches)
behind one URL. Every GET/HEAD hashes on ``(path, block)`` — the block is
``range_start // RA_FLEET_BLOCK`` — so a hot byte range always lands on
the same replica and the fleet's aggregate cache partitions the key space
instead of duplicating it. ``HashRing`` is classic consistent hashing
with ``RA_FLEET_VNODES`` virtual nodes per replica: membership changes
move only ~1/N of the key space, and each key has a deterministic
preference list the proxy walks on failure, so a dead replica costs one
refused connect (then the circuit breaker makes it free) rather than an
outage. PUTs bypass the cache tier entirely and stream to the origin.

``python -m repro_torch.fleet.router --root DIR --replicas 3`` boots a full
in-process fleet (origin + edges + router); ``--replica URL`` (repeated)
fronts replicas that already exist.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import unquote, urlsplit

from ..core.spec import env_float, env_int
from . import _proxy

_COPY_CHUNK = 1 << 20


def default_vnodes() -> int:
    """Virtual nodes per replica (``RA_FLEET_VNODES``, default 64)."""
    return max(1, env_int("RA_FLEET_VNODES", 64))


def default_hash_block() -> int:
    """Routing-hash block size in bytes (``RA_FLEET_BLOCK``, default 8 MiB).
    Coarser than the edge cache block on purpose: one slab wave's worth of
    adjacent requests routes to one replica, keeping its cache dense."""
    return max(1, env_int("RA_FLEET_BLOCK", 8 << 20))


def default_health_interval() -> float:
    """Seconds between health probes of down replicas (``RA_FLEET_HEALTH_S``)."""
    return max(0.05, env_float("RA_FLEET_HEALTH_S", 2.0))


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Deterministic across processes (BLAKE2b, not Python ``hash``), so any
    router instance over the same membership routes identically. Instances
    are immutable after construction as used by ``Router`` — membership
    changes build a new ring and swap the reference atomically, so lookups
    never need the router's lock.
    """

    def __init__(self, nodes=(), vnodes: Optional[int] = None):
        self.vnodes = default_vnodes() if vnodes is None else max(1, int(vnodes))
        self._nodes: List[str] = []
        self._points: List[int] = []
        self._owners: List[str] = []
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.append(node)
        pairs = list(zip(self._points, self._owners))
        for v in range(self.vnodes):
            pairs.append((self._hash(f"{node}#{v}"), node))
        pairs.sort()
        self._points = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.remove(node)
        pairs = [(p, o) for p, o in zip(self._points, self._owners) if o != node]
        self._points = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]

    def nodes(self) -> List[str]:
        return list(self._nodes)

    def lookup(self, key: str) -> Optional[str]:
        """Owner of ``key``: first vnode clockwise of the key's hash."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, self._hash(key)) % len(self._points)
        return self._owners[i]

    def preference(self, key: str, limit: Optional[int] = None) -> List[str]:
        """Distinct nodes in clockwise order from ``key`` — the failover
        walk order. ``preference(k)[0] == lookup(k)``."""
        if not self._points:
            return []
        want = len(self._nodes) if limit is None else min(limit, len(self._nodes))
        out: List[str] = []
        i = bisect.bisect_right(self._points, self._hash(key))
        n = len(self._points)
        for step in range(n):
            owner = self._owners[(i + step) % n]
            if owner not in out:
                out.append(owner)
                if len(out) >= want:
                    break
        return out


class _Replica:
    """Per-replica routing state; mutated only under ``Router._lock``."""

    __slots__ = ("url", "down", "requests", "errors")

    def __init__(self, url: str):
        self.url = url
        self.down = False      # guarded-by: _lock
        self.requests = 0      # guarded-by: _lock
        self.errors = 0        # guarded-by: _lock


def route_key(path: str, range_start: int, hash_block: int) -> str:
    """Hash key for a request: the entity path (with the ``/header/`` and
    ``/stat/`` JSON-view prefixes stripped, so metadata co-locates with the
    bytes it describes) plus the routing block the range starts in."""
    for pre in ("/header/", "/stat/"):
        if path.startswith(pre):
            path = path[len(pre) - 1:]
            break
    return f"{path}#{range_start // hash_block}"


class _RouterHandler(_proxy.JsonResponderMixin, BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "rawarray-router/1"

    def log_message(self, fmt, *args):  # noqa: D102 - quiet by default
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
        self._route("GET")

    def do_HEAD(self):
        self._route("HEAD")

    def do_PUT(self):
        srv: Router = self.server
        if not srv.origin_url:
            self._fail(501, "router has no origin configured for writes")
            return
        length = self.headers.get("Content-Length")
        headers = {k: v for k in _proxy.FORWARD_HEADERS
                   if (v := self.headers.get(k)) is not None}
        body = _proxy._BoundedReader(self.rfile, int(length)) if length else None
        try:
            resp = _proxy.upstream_request(srv.origin_url, "PUT", self.path,
                                           headers, body=body)
            payload = resp.read()
        except Exception as exc:  # origin down: nothing to fail over to
            self.close_connection = True
            self._fail(502, f"origin unreachable: {exc}")
            return
        self.send_response(resp.status)
        ctype = resp.getheader("Content-Type")
        if ctype:
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except OSError:
            self.close_connection = True

    # -- GET/HEAD: hash, walk the preference list, relay ------------------

    def _route(self, method: str) -> None:
        srv: Router = self.server
        path = unquote(urlsplit(self.path).path)
        if path == "/healthz":
            self._send_json({"ok": True, "role": "router",
                             "replicas": len(srv.replica_urls()),
                             "uptime_s": srv.metrics.snapshot()["uptime_s"]})
            return
        if path == "/metrics":
            self._send_json(srv.fleet_metrics())
            return
        start = 0
        spec = self.headers.get("Range")
        if spec and spec.startswith("bytes="):
            a = spec[len("bytes="):].partition("-")[0]
            if a.isdigit():
                start = int(a)
        targets = srv.plan(route_key(path, start, srv.hash_block))
        if not targets:
            self._fail(503, "no replicas in the ring")
            return
        headers = {k: v for k in _proxy.FORWARD_HEADERS
                   if (v := self.headers.get(k)) is not None}
        last_exc: Optional[Exception] = None
        for hop, url in enumerate(targets):
            try:
                resp = _proxy.upstream_request(url, method, self.path, headers)
            except Exception as exc:
                last_exc = exc
                srv.note_failure(url, failover=hop + 1 < len(targets))
                continue
            srv.note_success(url)
            if hop:
                srv.note_served_by_fallback()
            self._relay(method, resp)
            return
        self.close_connection = True
        self._fail(502, f"all replicas failed: {last_exc}")

    def _relay(self, method: str, resp) -> None:
        """Stream an upstream response to the client. Headers are committed
        here, so failover is impossible past this point by construction —
        a mid-body upstream death kills the client connection instead of
        silently truncating a 206."""
        srv: Router = self.server
        length = resp.getheader("Content-Length")
        body: Optional[bytes] = None
        if length is None:
            body = resp.read()
            length = str(len(body))
        self.send_response(resp.status)
        for name in _proxy.RELAY_HEADERS:
            val = resp.getheader(name)
            if val is not None:
                self.send_header(name, val)
        self.send_header("Content-Length", length)
        self.end_headers()
        if method == "HEAD" or resp.status in (204, 304):
            resp.read()
            return
        try:
            if body is not None:
                self.wfile.write(body)
                srv.metrics.add_bytes(out=len(body))
                return
            left = int(length)
            while left > 0:
                chunk = resp.read(min(_COPY_CHUNK, left))
                if not chunk:
                    raise ConnectionError("upstream closed mid-body")
                self.wfile.write(chunk)
                srv.metrics.add_bytes(out=len(chunk))
                left -= len(chunk)
        except (OSError, ConnectionError):
            self.close_connection = True


class Router(ThreadingHTTPServer):
    """Consistent-hash proxy over a replica fleet. See module docstring.

    ``add_replica`` / ``remove_replica`` rebuild the ring and swap it
    atomically; a background thread probes ``/healthz`` of down replicas
    every ``RA_FLEET_HEALTH_S`` seconds and folds them back in.
    """

    daemon_threads = True
    request_queue_size = 256
    disable_nagle_algorithm = True

    def __init__(
        self,
        replicas,
        address: Tuple[str, int] = ("127.0.0.1", 0),
        *,
        origin_url: Optional[str] = None,
        vnodes: Optional[int] = None,
        hash_block: Optional[int] = None,
        health_interval: Optional[float] = None,
        verbose: bool = False,
    ):
        from ..remote.server import ServerMetrics

        self.verbose = verbose
        self.origin_url = origin_url.rstrip("/") if origin_url else None
        self.vnodes = default_vnodes() if vnodes is None else max(1, int(vnodes))
        self.hash_block = default_hash_block() if hash_block is None else max(1, int(hash_block))
        self.metrics = ServerMetrics()
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}   # guarded-by: _lock
        self._ring = HashRing((), vnodes=self.vnodes)  # guarded-by: _lock
        self._failovers = 0        # guarded-by: _lock
        self._fallback_served = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._health_interval = (default_health_interval()
                                 if health_interval is None else health_interval)
        super().__init__(address, _RouterHandler)
        for url in replicas:
            self.add_replica(url)
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="ra-fleet-health")
        self._health_thread.start()

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    # -- membership -------------------------------------------------------

    def add_replica(self, url: str) -> None:
        url = url.rstrip("/")
        with self._lock:
            if url in self._replicas:
                return
            self._replicas[url] = _Replica(url)
            self._rebuild_locked()

    def remove_replica(self, url: str) -> None:
        url = url.rstrip("/")
        with self._lock:
            if self._replicas.pop(url, None) is None:
                return
            self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        self._ring = HashRing(sorted(self._replicas), vnodes=self.vnodes)

    def replica_urls(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    # -- routing ----------------------------------------------------------

    def plan(self, key: str) -> List[str]:
        """Failover-ordered targets for ``key``: the ring's preference list
        with known-down replicas demoted to last resort (a down replica is
        still tried if everything else fails — it might just have healed)."""
        with self._lock:
            ring = self._ring
            down = {u for u, r in self._replicas.items() if r.down}
        pref = ring.preference(key)
        if not down:
            return pref
        return [u for u in pref if u not in down] + [u for u in pref if u in down]

    def note_failure(self, url: str, failover: bool) -> None:
        with self._lock:
            rep = self._replicas.get(url)
            if rep is not None:
                rep.errors += 1
                rep.down = True
            if failover:
                self._failovers += 1

    def note_success(self, url: str) -> None:
        with self._lock:
            rep = self._replicas.get(url)
            if rep is not None:
                rep.requests += 1
                rep.down = False

    def note_served_by_fallback(self) -> None:
        with self._lock:
            self._fallback_served += 1

    def fleet_metrics(self) -> Dict:
        snap = self.metrics.snapshot()
        with self._lock:
            snap.update(
                role="router",
                hash_block=self.hash_block,
                vnodes=self.vnodes,
                failovers=self._failovers,
                fallback_served=self._fallback_served,
                replicas={u: {"down": r.down, "requests": r.requests,
                              "errors": r.errors}
                          for u, r in self._replicas.items()},
            )
        return snap

    # -- health probing ---------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self._health_interval):
            for url in self.replica_urls():
                with self._lock:
                    rep = self._replicas.get(url)
                    if rep is None or not rep.down:
                        continue
                if self._probe(url):
                    self.note_success(url)

    def _probe(self, url: str) -> bool:
        import http.client

        parts = urlsplit(url)
        conn = http.client.HTTPConnection(
            parts.hostname or "", parts.port,
            timeout=min(1.0, self._health_interval))
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                from ..remote.client import breaker_for
                breaker_for(parts.hostname or "", parts.port).record_success()
                return True
            return False
        except Exception:
            return False
        finally:
            try:
                conn.close()
            except Exception:
                pass

    def shutdown(self) -> None:
        # Regression note (ralint thread-lifecycle): shutdown() used to set
        # _stop without joining, leaving the health prober alive mid-probe
        # while the server object was torn down — the same zombie-thread
        # shape once fixed in the loader ring. _stop.set() wakes the
        # Event.wait immediately; the timeout only bounds an in-flight
        # /healthz probe (itself capped at 1s).
        self._stop.set()
        super().shutdown()
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=5.0)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.router",
        description="Consistent-hash router for a RawArray replica fleet.")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--replica", action="append", default=[],
                    help="replica base URL (repeat); mutually exclusive with --root")
    ap.add_argument("--origin", default=None,
                    help="origin base URL for writes (PUT passthrough)")
    ap.add_argument("--root", default=None,
                    help="serve DIR via an in-process origin + N edge replicas")
    ap.add_argument("--replicas", type=int, default=3,
                    help="edge count with --root (default 3)")
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="with --root: simulated origin latency per request")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if bool(args.root) == bool(args.replica):
        ap.error("give exactly one of --root or --replica")

    if args.root:
        from . import serve as fleet_serve

        fl = fleet_serve(args.root, replicas=args.replicas, host=args.host,
                         router_port=args.port, delay_s=args.delay_ms / 1e3,
                         verbose=args.verbose)
        print(f"fleet: router {fl.url} -> {len(fl.edges)} edges -> origin {fl.origin.url}")
        try:
            fl.router.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            fl.shutdown()
        return 0

    router = Router(args.replica, (args.host, args.port),
                    origin_url=args.origin, verbose=args.verbose)
    print(f"router: {router.url} -> {', '.join(router.replica_urls())}")
    try:
        router.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        router.shutdown()
        router.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

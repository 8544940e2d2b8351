"""Shared HTTP plumbing for the fleet tier (DESIGN.md §14).

Small pieces both fleet servers need and ``http.server`` does not provide:
a JSON/problem-response mixin for handlers, single-range parsing with the
same semantics as the origin server, a per-thread keep-alive connection
cache (a ``ThreadingHTTPServer`` dedicates one thread to one downstream
connection, so thread-local upstream connections give 1:1 keep-alive
chains through the proxy with zero locking), and a bounded reader that
lets a request body stream upstream without buffering it in RAM.
"""

from __future__ import annotations

import http.client
import threading
import time
from typing import Dict, Optional, Tuple
from urllib.parse import urlsplit

from ..remote.client import breaker_for, default_timeout

_COPY_CHUNK = 1 << 20

# request headers a proxy hop forwards verbatim; everything else is
# hop-by-hop or regenerated
FORWARD_HEADERS = ("Range", "If-None-Match", "Authorization", "X-RA-Upload",
                   "X-RA-Offset", "Content-Length")
# response headers relayed back to the client; Content-Length is handled
# separately because the relay must guarantee it matches the body it sends
RELAY_HEADERS = ("ETag", "Content-Range", "Content-Type", "Accept-Ranges")


def parse_range(spec: Optional[str], size: int) -> Optional[Tuple[int, int]]:
    """Single-range ``Range`` header → ``(start, stop)``; ``None`` means the
    whole entity; raises ``ValueError`` for a syntactically valid but
    unsatisfiable range (→ 416). Same semantics as the origin server's
    parser, so byte behavior through the fleet is identical to direct."""
    if not spec or not spec.startswith("bytes="):
        return None
    spec = spec[len("bytes="):]
    if "," in spec:
        return None
    a, _, b = spec.partition("-")
    if a == "":
        n = int(b)
        if n <= 0:
            raise ValueError("empty suffix range")
        return max(0, size - n), size
    start = int(a)
    stop = int(b) + 1 if b else size
    if start >= size or stop <= start:
        raise ValueError(f"range [{start}, {stop}) outside entity of {size}")
    return start, min(stop, size)


class JsonResponderMixin:
    """``_send_json`` / ``_fail`` for ``BaseHTTPRequestHandler`` subclasses,
    mirroring the origin server's responses (Content-Length always set, so
    keep-alive survives every status)."""

    def _send_json(self, obj, status: int = 200, etag: Optional[str] = None) -> None:
        import json

        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if etag is not None:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass

    def _fail(self, status: int, msg: str) -> None:
        body = (msg + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass


class _BoundedReader:
    """File-like over exactly ``length`` bytes of ``raw`` — what lets a PUT
    body stream through the proxy hop without ever reading past the request
    (the client connection is keep-alive; overreading would eat the next
    request line)."""

    def __init__(self, raw, length: int):
        self._raw = raw
        self._left = int(length)

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        want = self._left if n is None or n < 0 else min(n, self._left)
        data = self._raw.read(min(want, _COPY_CHUNK))
        self._left -= len(data)
        return data


_tls = threading.local()


def conn_for(base_url: str, timeout: Optional[float] = None) -> http.client.HTTPConnection:
    """Thread-local keep-alive connection to ``base_url``. One proxy handler
    thread serves one downstream connection for its whole life, so caching
    upstream connections per (thread, base) turns an N-request client
    session into N requests over ONE upstream socket — no locks, no pool."""
    conns: Dict[str, http.client.HTTPConnection] = getattr(_tls, "conns", None)
    if conns is None:
        conns = _tls.conns = {}
    c = conns.get(base_url)
    if c is None:
        parts = urlsplit(base_url)
        cls = (http.client.HTTPSConnection if parts.scheme == "https"
               else http.client.HTTPConnection)
        c = cls(parts.hostname or "", parts.port,
                timeout=default_timeout() if timeout is None else timeout)
        conns[base_url] = c
    return c


def drop_conn(base_url: str) -> None:
    """Close and forget this thread's cached connection to ``base_url``
    (after any transport error — the socket state is unknown)."""
    conns = getattr(_tls, "conns", None)
    if conns is None:
        return
    c = conns.pop(base_url, None)
    if c is not None:
        try:
            c.close()
        except Exception:
            pass


def upstream_request(
    base_url: str,
    method: str,
    path_qs: str,
    headers: Dict[str, str],
    body=None,
    *,
    timeout: Optional[float] = None,
):
    """One request on this thread's keep-alive connection to ``base_url``;
    returns the live ``HTTPResponse`` (caller must fully read it before the
    next call on this thread). Transport errors close/forget the connection
    and re-raise; the per-host circuit breaker is consulted first, so a
    dead replica fails in microseconds (DESIGN.md §14)."""
    parts = urlsplit(base_url)
    brk = breaker_for(parts.hostname or "", parts.port)
    brk.check(base_url)
    conn = conn_for(base_url, timeout)
    try:
        conn.request(method, path_qs, body=body, headers=headers)
        resp = conn.getresponse()
        brk.record_success()
        return resp
    except ConnectionRefusedError:
        drop_conn(base_url)
        brk.record_refusal()
        raise
    except (OSError, http.client.HTTPException):
        drop_conn(base_url)
        raise


def monotonic() -> float:
    return time.monotonic()

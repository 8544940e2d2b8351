"""Stdlib-only threaded HTTP byte-range server for RawArray trees
(DESIGN.md §9; upload plane §11).

Serves a directory of ``.ra`` files — including sharded stores, dataset
directories, and checkpoint directories (their ``index.json`` /
``manifest.json`` are plain files) — with exactly the parts of HTTP a
remote array plane needs:

* ``GET /<path>`` with single-range ``Range: bytes=a-b`` support (``206`` +
  ``Content-Range``); a row slab or engine slab is one request, because the
  RawArray layout makes every sub-range pure offset arithmetic;
* zero-copy responses: entity bytes go socket-ward through ``os.sendfile``
  (graceful buffered fallback where unavailable);
* ``ETag`` from ``(mtime_ns, size)`` and ``If-None-Match`` → ``304``, so
  clients can pin a version and revalidate for free;
* ``GET /header/<path>`` fast path: the decoded RawArray header as JSON —
  one round trip, no range arithmetic on the client;
* ``HEAD`` for size/ETag discovery;
* ``GET /healthz`` liveness probe and ``GET /metrics`` thread-safe counters
  (uptime, request/byte totals, per-path hit counts) — what the fleet
  router (DESIGN.md §14) health-checks and weights replicas with;
* authenticated ``PUT /<path>`` upload plane (DESIGN.md §11): whole-object
  upload with atomic publish (temp + rename), plus an append/patch/commit/
  abort session protocol driven by the ``X-RA-Upload`` header that mirrors
  the local writer's temp-file protocol — streamed bytes accumulate in
  ``<path>.part``, ``commit`` fsyncs and renames, so a dropped client never
  leaves a partial object visible. Uploads are OFF unless the server is
  started with an upload token (``--upload-token`` / ``RA_REMOTE_TOKEN``)
  and every PUT carries it as ``Authorization: Bearer <token>``.

Run standalone::

    PYTHONPATH=src python -m repro_torch.remote.server <root> [--host H] [--port P]
        [--upload-token TOKEN]

or in-process (tests, benchmarks)::

    server = serve(root, port=0)      # ephemeral port, daemon thread
    ...
    server.shutdown()
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple
from urllib.parse import unquote, urlsplit

from ..core import io as raio
from ..core.spec import RawArrayError, env_str as _env_str

_COPY_CHUNK = 1 << 20


class ServerMetrics:
    """Thread-safe request/byte counters behind ``GET /metrics`` (DESIGN.md
    §14). Every handler of the threading server runs on its own thread, so
    all mutation happens under one lock — increments can never be lost to a
    read-modify-write race. Per-path hit counts are capped at ``max_paths``
    distinct paths (new paths beyond the cap are counted in the totals but
    not per-path) so a crawler cannot balloon server memory."""

    def __init__(self, max_paths: int = 1024):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests = 0   # guarded-by: _lock
        self.bytes_out = 0  # guarded-by: _lock
        self.bytes_in = 0   # guarded-by: _lock
        self.errors = 0     # guarded-by: _lock
        self._max_paths = max_paths
        self._path_hits: Dict[str, int] = {}  # guarded-by: _lock

    def record(self, path: str, status: int) -> None:
        with self._lock:
            self.requests += 1
            if status >= 400:
                self.errors += 1
            if path in self._path_hits or len(self._path_hits) < self._max_paths:
                self._path_hits[path] = self._path_hits.get(path, 0) + 1

    def add_bytes(self, out: int = 0, in_: int = 0) -> None:
        with self._lock:
            self.bytes_out += out
            self.bytes_in += in_

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "requests": self.requests,
                "bytes_out": self.bytes_out,
                "bytes_in": self.bytes_in,
                "errors": self.errors,
                "paths": dict(self._path_hits),
            }


def file_etag(st: os.stat_result) -> str:
    """Strong-enough validator from (mtime, size) — cheap, no content hash."""
    return f'"{st.st_mtime_ns:x}-{st.st_size:x}"'


class RangeRequestHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: one conn serves many ranges
    server_version = "RawArrayHTTP/1.0"
    # TCP_NODELAY: responses are written headers-then-body (two sends), and
    # with Nagle on, the body of a mid-size ranged GET sits behind the
    # client's delayed ACK — a flat ~40ms per request that dwarfs the
    # transfer itself on fast links
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet by default; --verbose re-enables
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def log_request(self, code="-", size="-"):
        # every send_response lands here exactly once — the one choke point
        # where request count and status can be recorded consistently
        m = getattr(self.server, "metrics", None)
        if m is not None:
            try:
                status = int(code)
            except (TypeError, ValueError):
                status = 0
            m.record(unquote(urlsplit(self.path).path), status)
        super().log_request(code, size)

    def _send_json(self, obj, status: int = 200, etag: Optional[str] = None) -> None:
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
            return
        m = getattr(self.server, "metrics", None)
        if m is not None:
            m.add_bytes(out=len(body))

    # ---- helpers -----------------------------------------------------------
    def _resolve(self, relpath: str) -> Optional[str]:
        """Map a URL path onto the served root; ``None`` if it escapes or is
        not a regular file."""
        root = self.server.root  # type: ignore[attr-defined]
        full = os.path.realpath(os.path.join(root, relpath.lstrip("/")))
        if full != root and not full.startswith(root + os.sep):
            return None
        if not os.path.isfile(full):
            return None
        return full

    def _fail(self, status: int, msg: str) -> None:
        # a PUT rejected before its body was consumed would leave the body
        # bytes on the keep-alive socket, where they'd be parsed as the next
        # request line — drain them (bounded) or give up on the connection
        if self.command == "PUT":
            self._drain_body()
        body = (msg + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass

    def _drain_body(self) -> None:
        """Read and discard any unread request body so the keep-alive
        connection stays usable; close the connection instead when the
        length is unknown/garbage."""
        try:
            left = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            left = -1
        if left < 0:
            self.close_connection = True
            return
        try:
            while left > 0:
                piece = self.rfile.read(min(_COPY_CHUNK, left))
                if not piece:
                    self.close_connection = True
                    return
                left -= len(piece)
        except OSError:
            self.close_connection = True

    def _parse_range(self, size: int) -> Optional[Tuple[int, int]]:
        """Parse a single-range ``Range`` header into ``(start, stop)``.

        Returns ``None`` for "serve the whole entity"; raises ``ValueError``
        for a syntactically valid but unsatisfiable range (→ 416)."""
        spec = self.headers.get("Range")
        if not spec or not spec.startswith("bytes="):
            return None
        spec = spec[len("bytes="):]
        if "," in spec:  # multipart ranges are overkill for slab reads
            return None
        a, _, b = spec.partition("-")
        if a == "":  # suffix range: last N bytes
            n = int(b)
            if n <= 0:
                raise ValueError("empty suffix range")
            return max(0, size - n), size
        start = int(a)
        stop = int(b) + 1 if b else size
        if start >= size or stop <= start:
            raise ValueError(f"range [{start}, {stop}) outside entity of {size}")
        return start, min(stop, size)

    def _send_entity(self, path: str, head_only: bool) -> None:
        # origin-distance simulation (benchmarks/tests only, DESIGN.md §14):
        # a per-entity-request sleep held under ONE server-wide lock models a
        # far-away origin with a constrained uplink — concurrent misses at an
        # edge replica serialize here exactly like they would on a thin WAN
        # link, which is what makes fleet cache-capacity scaling measurable
        # on a single box
        delay = getattr(self.server, "delay_s", 0.0)
        if delay:
            with self.server._delay_lock:  # type: ignore[attr-defined]
                time.sleep(delay)
        # latency_s models per-request NETWORK latency: concurrent requests
        # overlap their sleeps (no lock), so N parallel clients see ~one RTT
        # per wave — the signal the mesh's host-count scaling benchmark
        # measures (DESIGN.md §15), vs delay_s's serialized-uplink model
        latency = getattr(self.server, "latency_s", 0.0)
        if latency:
            time.sleep(latency)
        try:
            st = os.stat(path)
        except OSError:
            self._fail(404, "not found")
            return
        etag = file_etag(st)
        inm = self.headers.get("If-None-Match")
        if inm and (inm.strip() == "*" or etag in [t.strip() for t in inm.split(",")]):
            self.send_response(304)
            self.send_header("ETag", etag)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        size = st.st_size
        try:
            rng = self._parse_range(size)
        except ValueError:
            self.send_response(416)
            self.send_header("Content-Range", f"bytes */{size}")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if rng is None:
            start, stop = 0, size
            self.send_response(200)
        else:
            start, stop = rng
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {start}-{stop - 1}/{size}")
        count = stop - start
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("ETag", etag)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(count))
        self.end_headers()
        if head_only or count == 0:
            return
        with open(path, "rb") as f:
            self.wfile.flush()  # drain buffered headers before raw socket I/O
            sent = self._copy_range(f, start, count)
        m = getattr(self.server, "metrics", None)
        if m is not None:
            m.add_bytes(out=sent)

    def _copy_range(self, f, offset: int, count: int) -> int:
        """Entity bytes to the socket — ``os.sendfile`` zero-copy when the
        platform allows, buffered pread/write otherwise. The fallback resumes
        AFTER whatever sendfile already sent: re-sending from the range start
        would silently corrupt the fixed-Content-Length entity. Returns bytes
        actually put on the wire (for the ``/metrics`` counters)."""
        sock_fd = self.connection.fileno()
        sent_total = 0
        try:
            while sent_total < count:
                sent = os.sendfile(sock_fd, f.fileno(), offset + sent_total,
                                   count - sent_total)
                if sent == 0:
                    return sent_total  # peer went away; nothing more to do
                sent_total += sent
            return sent_total
        except (AttributeError, OSError):
            pass  # not a disk file / platform without sendfile: fall back
        f.seek(offset + sent_total)
        left = count - sent_total
        while left:
            chunk = f.read(min(_COPY_CHUNK, left))
            if not chunk:
                break
            try:
                self.wfile.write(chunk)
            except OSError:
                return sent_total
            left -= len(chunk)
            sent_total += len(chunk)
        return sent_total

    def _send_stat_json(self, relpath: str) -> None:
        """``GET /stat/<dir>``: one-round-trip version pin for every regular
        file directly under a served directory — ``{"files": {name: {size,
        etag}}}`` with the SAME etag values the entity responses carry, so
        a client can pin a whole checkpoint's version set with one request
        instead of a HEAD per leaf (the ranged reads that follow still
        verify each response's ETag against the pin)."""
        root = self.server.root  # type: ignore[attr-defined]
        full = os.path.realpath(os.path.join(root, relpath.lstrip("/")))
        if (full != root and not full.startswith(root + os.sep)) or not os.path.isdir(full):
            self._fail(404, "not found")
            return
        files = {}
        try:
            with os.scandir(full) as it:
                for de in it:
                    if de.is_file(follow_symlinks=True):
                        st = de.stat(follow_symlinks=True)
                        files[de.name] = {"size": st.st_size, "etag": file_etag(st)}
        except OSError as e:
            self._fail(500, f"stat failed: {e}")
            return
        self._send_json({"files": files})

    def _send_header_json(self, relpath: str) -> None:
        path = self._resolve(relpath)
        if path is None:
            self._fail(404, "not found")
            return
        try:
            hdr = raio.header_of(path)
        except RawArrayError as e:
            self._fail(422, f"not a RawArray file: {e}")
            return
        st = os.stat(path)
        self._send_json(
            {
                "flags": hdr.flags,
                "eltype": hdr.eltype,
                "elbyte": hdr.elbyte,
                "data_length": hdr.data_length,
                "ndims": hdr.ndims,
                "shape": list(hdr.shape),
                "header_bytes": hdr.nbytes,
                "dtype": str(hdr.dtype()),
                "file_size": st.st_size,
            },
            etag=file_etag(st),
        )

    # ---- upload plane (DESIGN.md §11) --------------------------------------
    def _resolve_write(self, relpath: str) -> Optional[str]:
        """Map a URL path onto a WRITABLE location under the root; ``None``
        if it escapes the root or names a directory. The file need not
        exist; missing parent directories are created."""
        root = self.server.root  # type: ignore[attr-defined]
        full = os.path.realpath(os.path.join(root, relpath.lstrip("/")))
        if full != root and not full.startswith(root + os.sep):
            return None
        if full == root or os.path.isdir(full):
            return None
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return full

    def _authorized(self) -> bool:
        token = getattr(self.server, "upload_token", None)
        if not token:
            self._fail(403, "server is read-only (start with --upload-token)")
            return False
        got = self.headers.get("Authorization", "")
        if got != f"Bearer {token}":
            self._fail(401, "missing or wrong upload token")
            return False
        return True

    def _read_body_to(self, f, offset: int) -> int:
        """Stream the request body into ``f`` at ``offset``; returns bytes
        written. Requires ``Content-Length`` (chunked encoding is not
        decoded by this server)."""
        length = self.headers.get("Content-Length")
        if length is None:
            self._fail(411, "Content-Length required")
            self.close_connection = True  # body length unknown: can't drain
            return -1
        try:
            left = int(length)
        except ValueError:
            left = -1
        if left < 0:
            self._fail(400, f"bad Content-Length: {length!r}")
            return -1
        f.seek(offset)
        while left:
            piece = self.rfile.read(min(_COPY_CHUNK, left))
            if not piece:
                break
            f.write(piece)
            left -= len(piece)
        if left:
            self._fail(400, "request body shorter than Content-Length")
            return -1
        m = getattr(self.server, "metrics", None)
        if m is not None:
            m.add_bytes(in_=int(length))
        return int(length)

    def _ok(self, status: int, path: Optional[str] = None, **extra) -> None:
        body_d = dict(extra)
        if path is not None and os.path.exists(path):
            st = os.stat(path)
            body_d["etag"] = file_etag(st)
            body_d["size"] = st.st_size
        body = (json.dumps(body_d) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except OSError:
            pass

    def do_PUT(self) -> None:
        """Upload plane (DESIGN.md §11). Dispatch on ``X-RA-Upload``:

        =========  ==========================================================
        (absent)   whole-object upload: body → same-dir temp, fsync, rename
        append     body → ``<path>.part`` at ``X-RA-Offset`` (must equal the
                   part's current size; 409 + current size otherwise)
        patch      body overwrites ``[offset, offset+len)`` INSIDE the part
                   (the finalize header patch; 416 if it sticks out)
        commit     fsync ``<path>.part``, atomically rename to ``<path>``
        abort      delete ``<path>.part``
        =========  ==========================================================
        """
        if not self._authorized():
            return
        relpath = unquote(urlsplit(self.path).path)
        full = self._resolve_write(relpath)
        if full is None:
            self._fail(404, "path escapes the served root or is a directory")
            return
        mode = (self.headers.get("X-RA-Upload") or "").strip().lower()
        try:
            if mode == "":
                tmp = f"{full}.upload-{threading.get_ident():x}"
                try:
                    with open(tmp, "wb") as f:
                        if self._read_body_to(f, 0) < 0:
                            return
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, full)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                self._ok(201, full)
            elif mode in ("append", "patch"):
                part = full + ".part"
                try:
                    offset = int(self.headers.get("X-RA-Offset", ""))
                except ValueError:
                    self._fail(400, "append/patch need an integer X-RA-Offset")
                    return
                size = os.path.getsize(part) if os.path.exists(part) else 0
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = -1
                if length < 0:
                    self._fail(400, "bad Content-Length")
                    return
                if mode == "append" and offset != size:
                    self._fail(409, f"append offset {offset} != part size {size}")
                    return
                if mode == "patch" and offset + length > size:
                    self._fail(416, f"patch [{offset}, {offset + length}) outside part of {size}")
                    return
                with open(part, "r+b" if os.path.exists(part) else "w+b") as f:
                    if self._read_body_to(f, offset) < 0:
                        return
                self._ok(200, part)
            elif mode == "commit":
                part = full + ".part"
                if not os.path.exists(part):
                    self._fail(404, "no upload session to commit (missing .part)")
                    return
                with open(part, "rb") as f:
                    os.fsync(f.fileno())
                os.replace(part, full)
                self._ok(201, full)
            elif mode == "abort":
                try:
                    os.unlink(full + ".part")
                except FileNotFoundError:
                    pass
                self._ok(200)
            else:
                self._fail(400, f"unknown X-RA-Upload mode {mode!r}")
        except OSError as e:
            self._fail(500, f"upload failed: {e}")

    # ---- verbs -------------------------------------------------------------
    def _route(self, head_only: bool) -> None:
        path = unquote(urlsplit(self.path).path)
        # a real file under a literal header/ directory wins over the JSON
        # endpoint, so the fast path can never shadow served bytes (the
        # client falls back to a ranged header read when JSON parsing fails)
        full = self._resolve(path)
        if full is None and not head_only:
            if path.startswith("/header/"):
                self._send_header_json(path[len("/header"):])
                return
            if path.startswith("/stat/"):
                self._send_stat_json(path[len("/stat"):])
                return
            if path == "/healthz":
                # liveness probe for the fleet router (DESIGN.md §14): tiny,
                # allocation-free, never touches the disk
                self._send_json({"ok": True, "role": "origin",
                                 "uptime_s": self.server.metrics.snapshot()["uptime_s"]})
                return
            if path == "/metrics":
                snap = self.server.metrics.snapshot()
                snap["role"] = "origin"
                self._send_json(snap)
                return
        if full is None:
            self._fail(404, "not found")
            return
        self._send_entity(full, head_only)

    def do_GET(self) -> None:
        self._route(head_only=False)

    def do_HEAD(self) -> None:
        self._route(head_only=True)


class ArrayServer(http.server.ThreadingHTTPServer):
    """Threaded byte-range server rooted at one directory.

    ``upload_token=None`` (default) keeps the server strictly read-only;
    passing a token enables the PUT upload plane (DESIGN.md §11) for
    requests carrying ``Authorization: Bearer <token>``."""

    daemon_threads = True
    # socketserver's default listen backlog (5) makes connection bursts —
    # a pool prewarm, a parallel read wave from a many-leaf checkpoint —
    # hit kernel SYN drops and 1s retransmit stalls; size it like a real
    # file server instead
    request_queue_size = 128

    def __init__(
        self,
        root: str,
        address=("127.0.0.1", 0),
        *,
        verbose: bool = False,
        upload_token: Optional[str] = None,
        delay_s: float = 0.0,
        latency_s: float = 0.0,
    ):
        self.root = os.path.realpath(root)
        if not os.path.isdir(self.root):
            raise RawArrayError(f"server root is not a directory: {root}")
        self.verbose = verbose
        self.upload_token = upload_token
        self.metrics = ServerMetrics()
        # delay_s > 0 simulates a far origin for fleet benchmarks/tests
        # (DESIGN.md §14): each entity request sleeps this long while holding
        # one server-wide lock, modelling a constrained origin uplink
        self.delay_s = float(delay_s)
        self._delay_lock = threading.Lock()
        # latency_s > 0 sleeps per request WITHOUT the lock — concurrent
        # network latency (requests in flight overlap), for mesh scaling
        self.latency_s = float(latency_s)
        super().__init__(address, RangeRequestHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        host = self.server_address[0]
        return f"http://{host}:{self.port}"


def serve(
    root: str,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    verbose: bool = False,
    upload_token: Optional[str] = None,
    delay_s: float = 0.0,
    latency_s: float = 0.0,
) -> ArrayServer:
    """Start an ``ArrayServer`` on a daemon thread; returns the (already
    listening) server — ``server.url`` is ready immediately, ``port=0``
    picks an ephemeral port. Stop with ``server.shutdown()``. Pass
    ``upload_token`` to enable authenticated uploads (DESIGN.md §11);
    ``delay_s`` simulates origin distance for fleet benchmarks (§14, one
    serialized uplink), ``latency_s`` per-request network latency that
    concurrent requests overlap (mesh scaling, §15)."""
    server = ArrayServer(root, (host, port), verbose=verbose,
                         upload_token=upload_token, delay_s=delay_s,
                         latency_s=latency_s)
    # ralint: allow=thread-lifecycle -- lifetime owned by the returned server;
    # server.shutdown() stops serve_forever and the daemon thread exits with it
    t = threading.Thread(target=server.serve_forever, daemon=True, name="ra-remote-srv")
    t.start()
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ra-serve", description=__doc__)
    p.add_argument("root", help="directory of .ra files / shard dirs / checkpoints")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8742)
    p.add_argument("--verbose", action="store_true", help="log each request")
    p.add_argument(
        "--upload-token",
        default=_env_str("RA_REMOTE_TOKEN") or None,
        help="enable authenticated PUT uploads with this bearer token "
        "(default: RA_REMOTE_TOKEN env var; omit for a read-only server)",
    )
    args = p.parse_args(argv)
    server = ArrayServer(
        args.root, (args.host, args.port),
        verbose=args.verbose, upload_token=args.upload_token,
    )
    mode = "read-write" if args.upload_token else "read-only"
    print(f"serving {server.root} at {server.url} [{mode}] (Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Async load-generation harness for the fleet tier (DESIGN.md §14).

Replays dataset-shaped read traces — ``gather`` (random block-aligned
ranges, the shuffled-training access pattern), ``rows`` (sequential
spans, sequential epochs), ``coldstart`` (whole objects largest-first,
the checkpoint-restore pattern) — from hundreds of concurrent clients
against any server speaking the RawArray byte-range dialect (origin,
edge, or router). Each client is one asyncio task holding one keep-alive
HTTP/1.1 connection, so a 300-client run costs 300 sockets and zero
threads; per-request latencies aggregate into p50/p99 milliseconds and
aggregate GB/s. ``benchmarks/bench_fleet.py`` drives this to produce
``BENCH_FLEET.json``; the CLI replays a trace against a live URL:
``python -m repro_torch.fleet.loadgen http://router:8100 --mode gather``.
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from ..core.spec import RawArrayError

# one trace entry: (url path, byte offset, byte length)
Request = Tuple[str, int, int]

_MAX_LINE = 1 << 16


# -- trace builders --------------------------------------------------------

def trace_gather(files: Sequence[Tuple[str, int]], *, req_bytes: int,
                 requests: int, seed: int = 0) -> List[Request]:
    """Random ``req_bytes``-aligned ranges across ``files`` — the shuffled
    gather pattern. ``files`` is ``[(path, size), ...]``."""
    rng = random.Random(seed)
    out: List[Request] = []
    usable = [(p, s) for p, s in files if s > 0]
    if not usable:
        raise RawArrayError("trace_gather: no non-empty files")
    for _ in range(requests):
        path, size = usable[rng.randrange(len(usable))]
        blocks = max(1, (size + req_bytes - 1) // req_bytes)
        off = rng.randrange(blocks) * req_bytes
        out.append((path, min(off, size - 1), min(req_bytes, size - min(off, size - 1))))
    return out


def trace_rows(files: Sequence[Tuple[str, int]], *, req_bytes: int,
               requests: int) -> List[Request]:
    """Sequential spans round-robined across files — the epoch-scan
    pattern. Wraps around each file as needed."""
    usable = [(p, s) for p, s in files if s > 0]
    if not usable:
        raise RawArrayError("trace_rows: no non-empty files")
    cursors = [0] * len(usable)
    out: List[Request] = []
    for i in range(requests):
        j = i % len(usable)
        path, size = usable[j]
        off = cursors[j] % size
        ln = min(req_bytes, size - off)
        out.append((path, off, ln))
        cursors[j] = (off + ln) % size
    return out


def trace_coldstart(files: Sequence[Tuple[str, int]], *,
                    req_bytes: int) -> List[Request]:
    """Every byte of every file, largest object first, chunked into
    ``req_bytes`` ranges — the checkpoint-restore pattern."""
    out: List[Request] = []
    for path, size in sorted(files, key=lambda fs: -fs[1]):
        for off in range(0, size, req_bytes):
            out.append((path, off, min(req_bytes, size - off)))
    return out


def files_from_stat(base_url: str, *, suffix: Optional[str] = None
                    ) -> List[Tuple[str, int]]:
    """File list for the trace builders from a live server's ``/stat/``
    directory listing (works through the router — ``/stat/`` routes by the
    underlying entity path)."""
    from ..remote.client import stat_dir

    entries = stat_dir(base_url.rstrip("/") + "/")
    out = [("/" + name, int(size)) for name, (size, _etag) in sorted(entries.items())
           if suffix is None or name.endswith(suffix)]
    if not out:
        raise RawArrayError(f"no files listed by {base_url}/stat/")
    return out


def build_trace(mode: str, files: Sequence[Tuple[str, int]], *, req_bytes: int,
                requests: int, seed: int = 0) -> List[Request]:
    if mode == "gather":
        return trace_gather(files, req_bytes=req_bytes, requests=requests, seed=seed)
    if mode == "rows":
        return trace_rows(files, req_bytes=req_bytes, requests=requests)
    if mode == "coldstart":
        return trace_coldstart(files, req_bytes=req_bytes)
    raise RawArrayError(f"unknown trace mode {mode!r} "
                        "(expected gather | rows | coldstart)")


# -- the async client -----------------------------------------------------

async def _read_response(reader: asyncio.StreamReader) -> Tuple[int, int]:
    """Parse one HTTP/1.1 response, drain the body, return
    ``(status, body_bytes)``. Assumes Content-Length framing (every server
    in this repo sets it on every status)."""
    status_line = await reader.readuntil(b"\r\n")
    status = int(status_line.split(b" ", 2)[1])
    clen = 0
    while True:
        line = await reader.readuntil(b"\r\n")
        if line == b"\r\n":
            break
        if len(line) > _MAX_LINE:
            raise RawArrayError("oversized response header")
        name, _, value = line.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            clen = int(value.strip())
    left = clen
    while left > 0:
        chunk = await reader.read(min(left, 1 << 20))
        if not chunk:
            raise RawArrayError("server closed mid-body")
        left -= len(chunk)
    return status, clen


async def _client(host: str, port: int, requests: Sequence[Request],
                  latencies: List[float], loop) -> Tuple[int, int]:
    """One keep-alive connection replaying its slice of the trace; returns
    ``(bytes_received, errors)``. One reconnect attempt per request."""
    reader = writer = None
    got = 0
    errors = 0

    async def connect():
        nonlocal reader, writer
        reader, writer = await asyncio.open_connection(host, port)

    for path, off, ln in requests:
        req = (f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Range: bytes={off}-{off + ln - 1}\r\n\r\n").encode()
        t0 = loop.time()
        for attempt in (0, 1):
            try:
                if writer is None:
                    await connect()
                writer.write(req)
                await writer.drain()
                status, nbytes = await _read_response(reader)
                break
            except (OSError, asyncio.IncompleteReadError, RawArrayError):
                if writer is not None:
                    writer.close()
                    reader = writer = None
                if attempt:
                    status, nbytes = 0, 0
        latencies.append(loop.time() - t0)
        if status in (200, 206):
            got += nbytes
        else:
            errors += 1
    if writer is not None:
        writer.close()
    return got, errors


async def _run_async(base_url: str, trace: Sequence[Request], clients: int
                     ) -> Dict[str, float]:
    parts = urlsplit(base_url)
    host, port = parts.hostname or "127.0.0.1", parts.port or 80
    loop = asyncio.get_running_loop()
    latencies: List[float] = []
    # interleave so every client mixes paths/offsets instead of one client
    # owning one file — that is what makes a herd a herd
    slices: List[List[Request]] = [list(trace[i::clients]) for i in range(clients)]
    t0 = loop.time()
    results = await asyncio.gather(
        *(_client(host, port, s, latencies, loop) for s in slices if s))
    elapsed = max(loop.time() - t0, 1e-9)
    total = sum(g for g, _ in results)
    errors = sum(e for _, e in results)
    latencies.sort()
    return {
        "clients": float(clients),
        "requests": float(len(latencies)),
        "errors": float(errors),
        "bytes": float(total),
        "seconds": elapsed,
        "gbps": total / elapsed / 1e9,
        "p50_ms": percentile(latencies, 0.50) * 1e3,
        "p99_ms": percentile(latencies, 0.99) * 1e3,
    }


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence (0 for an
    empty one — loadgen reports, it does not crash)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


def run(base_url: str, trace: Sequence[Request], *, clients: int = 64
        ) -> Dict[str, float]:
    """Replay ``trace`` against ``base_url`` from ``clients`` concurrent
    keep-alive connections; returns the latency/throughput report dict
    (keys: requests, errors, bytes, seconds, gbps, p50_ms, p99_ms)."""
    if not trace:
        raise RawArrayError("empty trace")
    clients = max(1, min(clients, len(trace)))
    return asyncio.run(_run_async(base_url, trace, clients))


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet.loadgen",
        description="Replay a dataset-shaped read trace against a RawArray "
                    "origin, edge, or router URL.")
    ap.add_argument("url")
    ap.add_argument("--mode", choices=("gather", "rows", "coldstart"),
                    default="gather")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--req-bytes", type=int, default=1 << 18)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--suffix", default=None,
                    help="only replay files with this suffix (e.g. .ra)")
    ap.add_argument("--json", default=None, help="also write the report here")
    args = ap.parse_args(argv)

    files = files_from_stat(args.url, suffix=args.suffix)
    trace = build_trace(args.mode, files, req_bytes=args.req_bytes,
                        requests=args.requests, seed=args.seed)
    report = run(args.url, trace, clients=args.clients)
    report["mode"] = args.mode
    print(f"{args.mode}: {int(report['requests'])} reqs, "
          f"{int(report['errors'])} errors, "
          f"{report['bytes'] / 1e6:.1f} MB in {report['seconds']:.2f}s "
          f"({report['gbps']:.3f} GB/s), "
          f"p50 {report['p50_ms']:.1f} ms, p99 {report['p99_ms']:.1f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    return 1 if report["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

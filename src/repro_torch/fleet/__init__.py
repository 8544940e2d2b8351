"""Serving fleet: consistent-hash edge tier over the remote plane
(DESIGN.md §14).

Composes three pieces into one scalable read path:

* ``router``  — consistent-hash HTTP proxy pinning each ``(path, block)``
  to one replica, with preference-list failover and health probing;
* ``edge``    — per-replica read-through cache (RAM block LRU → disk
  spill → origin) with single-flight request coalescing and ETag-scoped
  invalidation;
* ``loadgen`` — async trace-replay harness reporting p50/p99 latency and
  aggregate GB/s (feeds ``BENCH_FLEET.json``).

``fleet.serve(root, replicas=3)`` boots the whole thing in-process —
origin, N edges, router — and returns a ``Fleet`` handle whose ``.url``
any ``RemoteReader`` / ``ra.read`` / dataset call accepts transparently:
the router speaks the origin's byte-range dialect, so engine slab, span,
and gather waves run unchanged through the proxy.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
from typing import List, Optional

from .edge import EdgeServer, SingleFlight, SpillCache
from .loadgen import build_trace, files_from_stat
from .loadgen import run as run_load
from .router import HashRing, Router

__all__ = [
    "EdgeServer",
    "Fleet",
    "HashRing",
    "Router",
    "SingleFlight",
    "SpillCache",
    "build_trace",
    "files_from_stat",
    "run_load",
    "serve",
]


class Fleet:
    """Handle over an in-process fleet: ``origin`` (``ArrayServer`` or
    ``None`` when fronting an external origin URL), ``edges``, ``router``.
    ``url`` is the single client-facing entry point. Context-manager
    friendly; ``shutdown`` stops every server and removes edge spill
    directories it created."""

    def __init__(self, router: Router, edges: List[EdgeServer], origin,
                 spill_dirs: List[str], edge_kwargs: dict):
        self.router = router
        self.edges = edges
        self.origin = origin
        self._spill_dirs = spill_dirs
        self._edge_kwargs = edge_kwargs
        self._threads: List[threading.Thread] = []

    @property
    def url(self) -> str:
        return self.router.url

    @property
    def origin_url(self) -> Optional[str]:
        if self.origin is not None:
            return self.origin.url
        return self.router.origin_url

    def _start(self, server) -> None:
        t = threading.Thread(target=server.serve_forever, daemon=True,
                             name=f"ra-fleet-{server.server_address[1]}")
        t.start()
        self._threads.append(t)

    def add_replica(self) -> EdgeServer:
        """Boot one more edge over the same origin and fold it into the
        ring (the consistent hash moves ~1/N of the key space to it)."""
        edge, spill = _make_edge(self.origin_url, self._edge_kwargs)
        if spill:
            self._spill_dirs.append(spill)
        self.edges.append(edge)
        self._start(edge)
        self.router.add_replica(edge.url)
        return edge

    def remove_replica(self, edge: EdgeServer) -> None:
        """Take one edge out of rotation and stop it. In-flight requests
        racing the removal fail over via the router's preference list."""
        self.router.remove_replica(edge.url)
        if edge in self.edges:
            self.edges.remove(edge)
        edge.shutdown()
        edge.server_close()
        edge.close_readers()

    def shutdown(self) -> None:
        self.router.shutdown()
        self.router.server_close()
        for edge in list(self.edges):
            edge.shutdown()
            edge.server_close()
            edge.close_readers()
        if self.origin is not None:
            self.origin.shutdown()
            self.origin.server_close()
        # Regression note (ralint thread-lifecycle): the serve_forever
        # threads were fired and forgotten — after shutdown() a thread could
        # still be inside serve_forever's poll interval while the spill dirs
        # below were being deleted. server.shutdown() above blocks until the
        # loop exits, so these joins are bounded.
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        for d in self._spill_dirs:
            shutil.rmtree(d, ignore_errors=True)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _make_edge(origin_url: str, kwargs: dict):
    spill_dir = None
    if kwargs.get("spill", True) and kwargs.get("spill_bytes") != 0:
        spill_dir = tempfile.mkdtemp(prefix="ra-edge-spill-")
    edge = EdgeServer(
        origin_url,
        ("127.0.0.1", 0),
        cache_bytes=kwargs.get("cache_bytes"),
        block_bytes=kwargs.get("block_bytes"),
        spill_dir=spill_dir,
        spill_bytes=kwargs.get("spill_bytes"),
        revalidate_s=kwargs.get("revalidate_s"),
        verbose=kwargs.get("verbose", False),
    )
    return edge, spill_dir


def serve(
    root: Optional[str] = None,
    *,
    origin_url: Optional[str] = None,
    replicas: int = 3,
    host: str = "127.0.0.1",
    router_port: int = 0,
    delay_s: float = 0.0,
    upload_token: Optional[str] = None,
    cache_bytes: Optional[int] = None,
    block_bytes: Optional[int] = None,
    spill: bool = True,
    spill_bytes: Optional[int] = None,
    revalidate_s: Optional[float] = None,
    vnodes: Optional[int] = None,
    hash_block: Optional[int] = None,
    verbose: bool = False,
) -> Fleet:
    """Boot a full in-process fleet and return its ``Fleet`` handle.

    Either serve ``root`` via a new origin ``ArrayServer`` (``delay_s``
    simulates a slow uplink — each origin request sleeps that long under
    a server-wide lock, modeling a serialized thin pipe), or front an
    existing ``origin_url``. ``replicas`` edges each get a private RAM
    cache and (by default) a temporary disk spill dir; the router hashes
    across them. Writes (PUT) pass through the router to the origin.
    """
    from ..core.spec import RawArrayError

    if (root is None) == (origin_url is None):
        raise RawArrayError("fleet.serve: give exactly one of root or origin_url")

    origin = None
    if root is not None:
        from ..remote.server import ArrayServer

        origin = ArrayServer(root, (host, 0), upload_token=upload_token,
                             delay_s=delay_s, verbose=verbose)
        origin_url = origin.url

    edge_kwargs = dict(cache_bytes=cache_bytes, block_bytes=block_bytes,
                       spill=spill, spill_bytes=spill_bytes,
                       revalidate_s=revalidate_s, verbose=verbose)
    edges: List[EdgeServer] = []
    spill_dirs: List[str] = []
    for _ in range(max(1, replicas)):
        edge, spill_dir = _make_edge(origin_url, edge_kwargs)
        edges.append(edge)
        if spill_dir:
            spill_dirs.append(spill_dir)

    router = Router([e.url for e in edges], (host, router_port),
                    origin_url=origin_url, vnodes=vnodes,
                    hash_block=hash_block, verbose=verbose)
    fl = Fleet(router, edges, origin, spill_dirs, edge_kwargs)
    if origin is not None:
        fl._start(origin)
    for edge in edges:
        fl._start(edge)
    fl._start(router)
    return fl

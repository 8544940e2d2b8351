"""Remote RawArray data plane (DESIGN.md §9; upload plane §11).

Three layers:

* ``server``  — stdlib threaded HTTP byte-range server (``os.sendfile``
  zero-copy, ETag/304, ``/header/<path>`` JSON fast path) plus the
  authenticated PUT upload plane (append/patch/commit/abort sessions with
  atomic publish, DESIGN.md §11);
* ``client``  — ``RemoteReader``: the engine's positioned-read interface
  over pooled HTTP connections, so slab/gather waves run unchanged over
  the network; ``remote_read`` / ``remote_read_into`` /
  ``remote_header_of`` mirroring ``core.io``; and the write direction —
  ``upload_bytes`` (one atomic PUT) and ``RemoteWriter`` (the incremental
  ``RaWriter`` streaming over the upload session);
* ``cache``   — block-aligned LRU byte cache between client and sockets.

``core.io`` dispatches ``http(s)://`` paths here, which makes the whole
data plane URL-aware: sharded stores, datasets, the loader, checkpoint
restore — and, on the write side, ``write`` / checkpoint save — all
accept URLs.
"""

from .cache import BlockCache, reset_shared_cache, shared_cache
from .client import (
    CircuitBreaker,
    RemoteAuthError,
    RemoteReader,
    RemoteWriter,
    breaker_for,
    close_readers,
    default_token,
    fetch_bytes,
    get_reader,
    is_url,
    remote_header_of,
    remote_read,
    remote_read_into,
    remote_read_metadata,
    remote_read_stats,
    reset_breakers,
    stat_dir,
    upload_bytes,
)
from .server import ArrayServer, ServerMetrics, serve

__all__ = [
    "ArrayServer",
    "BlockCache",
    "CircuitBreaker",
    "RemoteAuthError",
    "RemoteReader",
    "RemoteWriter",
    "ServerMetrics",
    "breaker_for",
    "close_readers",
    "default_token",
    "fetch_bytes",
    "get_reader",
    "is_url",
    "remote_header_of",
    "remote_read",
    "remote_read_into",
    "remote_read_metadata",
    "remote_read_stats",
    "reset_breakers",
    "reset_shared_cache",
    "serve",
    "shared_cache",
    "stat_dir",
    "upload_bytes",
]

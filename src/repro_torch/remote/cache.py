"""Block-aligned LRU byte cache for the remote data plane (DESIGN.md §9).

Sits between ``RemoteReader`` and the sockets: every fetched byte lands in
fixed-size blocks keyed by ``(tag, block_index)`` where ``tag`` identifies
one remote object *version* (URL + ETag), so repeated epoch traversals of a
remote dataset are served from RAM instead of the wire, and a file that
changes on the server can never satisfy hits from its stale bytes.

Knobs (read at construction):

==========================  ====================================  =========
variable                    meaning                               default
==========================  ====================================  =========
``RA_REMOTE_BLOCK``         cache block size in bytes             256 KiB
``RA_REMOTE_CACHE_MB``      total cache capacity in MiB           256
==========================  ====================================  =========

256 KiB blocks keep read amplification low for scattered row gathers
(a sparse row costs one block, not megabytes) while bulk reads coalesce
runs of missing blocks into single large ranged requests anyway.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..core.spec import env_int as _env_int


def default_block_bytes() -> int:
    return max(1 << 12, _env_int("RA_REMOTE_BLOCK", 1 << 18))


def default_capacity_bytes() -> int:
    return max(0, _env_int("RA_REMOTE_CACHE_MB", 256)) << 20


class BlockCache:
    """Thread-safe LRU over fixed-size byte blocks with hit/miss/eviction
    counters. A zero capacity disables caching (every ``get`` is a miss and
    ``put`` is a no-op), which keeps call sites branch-free.

    Counter discipline (audited for the fleet tier, DESIGN.md §14): every
    counter mutation happens inside ``self._lock`` — the same lock that
    guards the block map — so concurrent readers (the threaded client pool,
    edge-tier request threads) can never lose increments to a read-modify-
    write race, and ``stats()`` always reports a consistent snapshot.
    External code must treat the bare ``hits``/``misses``/``evictions``
    attributes as read-only observables and go through ``stats()`` for
    anything that needs cross-counter consistency (e.g. ``hit_ratio``)."""

    def __init__(
        self,
        block_bytes: Optional[int] = None,
        capacity_bytes: Optional[int] = None,
    ):
        self.block_bytes = int(block_bytes or default_block_bytes())
        self.capacity_bytes = (
            default_capacity_bytes() if capacity_bytes is None else int(capacity_bytes)
        )
        self._lock = threading.Lock()
        self._blocks: "OrderedDict[Tuple[str, int], bytes]" = OrderedDict()  # guarded-by: _lock
        self._nbytes = 0        # guarded-by: _lock
        self.hits = 0           # guarded-by: _lock
        self.misses = 0         # guarded-by: _lock
        self.evictions = 0      # guarded-by: _lock
        self.invalidations = 0  # guarded-by: _lock

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def get(self, tag: str, block_index: int) -> Optional[bytes]:
        """Return the cached block (bumping it to most-recently-used), or
        ``None`` on a miss."""
        key = (tag, block_index)
        with self._lock:
            data = self._blocks.get(key)
            if data is None:
                self.misses += 1
                return None
            self._blocks.move_to_end(key)
            self.hits += 1
            return data

    def put(self, tag: str, block_index: int, data: bytes) -> None:
        if self.capacity_bytes <= 0 or len(data) > self.capacity_bytes:
            return
        key = (tag, block_index)
        with self._lock:
            old = self._blocks.pop(key, None)
            if old is not None:
                self._nbytes -= len(old)
            self._blocks[key] = data
            self._nbytes += len(data)
            while self._nbytes > self.capacity_bytes:
                _, victim = self._blocks.popitem(last=False)
                self._nbytes -= len(victim)
                self.evictions += 1

    def invalidate(self, tag: str) -> int:
        """Drop every block of one object version (the edge tier calls this
        when a path's origin ETag changes, DESIGN.md §14); returns blocks
        dropped."""
        with self._lock:
            keys = [k for k in self._blocks if k[0] == tag]
            for k in keys:
                self._nbytes -= len(self._blocks.pop(k))
            if keys:
                self.invalidations += 1
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._nbytes = 0

    def reset_stats(self) -> None:
        """Zero the counters without touching cached blocks (benchmarks:
        isolate one phase's traffic)."""
        with self._lock:
            self.hits = self.misses = self.evictions = self.invalidations = 0

    def stats(self) -> Dict[str, float]:
        """Consistent counter snapshot. ``hit_ratio`` is hits/(hits+misses)
        computed under the lock (0.0 before any traffic), so it can never
        mix a ``hits`` from one instant with a ``misses`` from another."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "blocks": len(self._blocks),
                "nbytes": self._nbytes,
                "hit_ratio": (self.hits / total) if total else 0.0,
            }


_shared: Optional[BlockCache] = None  # guarded-by: _shared_lock
_shared_lock = threading.Lock()


def shared_cache() -> BlockCache:
    """Process-wide cache shared by every ``RemoteReader`` by default, so
    readers over many shard files pool one capacity budget."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = BlockCache()
        return _shared


def reset_shared_cache() -> None:
    """Drop the shared cache (tests/benchmarks: guarantee a cold start)."""
    global _shared
    with _shared_lock:
        _shared = None

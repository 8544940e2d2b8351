"""Deterministic, resumable, prefetching loader over RaDataset.

* **Determinism**: per-epoch permutation from (seed, epoch) — every host
  derives the same global order and takes its own slice.
* **Resumability**: `LoaderState` (epoch, step) checkpoints with the model;
  `DataLoader.restore(state)` resumes mid-epoch exactly.
* **Data mesh** (``mesh=DataMesh(...)``, DESIGN.md §15): shard-ownership
  partitioning replaces the contiguous ``host_range`` split — this host
  materializes only the rows of shards it owns under the mesh's
  deterministic global shuffle, steps per epoch is the global minimum over
  hosts (lockstep-safe), and ``repartition()`` applies a membership change
  mid-epoch with no row duplicated or dropped. ``LoaderState`` then also
  carries the epoch's segment history, so elastic epochs are resumable.
* **Prefetch**: a background thread keeps ``prefetch`` batches ready, so
  host-side reads overlap device compute (the paper's I/O latency win,
  applied where it matters in training).
* **Buffer reuse** (``reuse_buffers=True``): the prefetch thread cycles
  through ``prefetch + 2`` preallocated batch buffers and streams each batch
  into them via ``RaDataset.gather/rows(out=...)`` — no per-batch allocation,
  no page-fault storm (DESIGN.md §8). The emitted arrays alias the ring, so
  a consumer must finish with (or copy) a batch before advancing more than
  ``prefetch + 1`` steps; that is exactly the train-loop pattern. Defaults to
  off to preserve the seed's value semantics.
* **Straggler visibility**: the loader tracks wait-time (device starved) vs
  ready-time; exported in ``stats()`` for the train-loop straggler monitor.
* **Remote datasets** (DESIGN.md §9): a loader over an ``http(s)://``
  ``RaDataset`` streams batches via parallel byte-range reads; with the
  block cache sized to the working set, epoch 2+ is served from RAM.
  ``stats()`` then also reports the cache hit/miss/eviction counters.
  The ``naive=True`` baseline indexes local mmaps and is refused remotely.
* **Predicate filtering** (``where=col("label") == 3``, DESIGN.md §16):
  the loader trains on only the matching rows. The match set is planned
  once with chunk-statistics pushdown (pruned chunks never fetch payload
  bytes), then shuffled/split per epoch exactly like the full dataset.
  Mutually exclusive with ``mesh=`` and ``naive=``.
* **Quantized fields** (DESIGN.md §12): fields stored as uint8 codes are
  dequantized on host by default (``dequant=True``) so consumers see the
  logical float batches; ``DeviceLoader`` wraps a ``dequant=False`` loader
  and moves the 4×-smaller uint8 bytes to the device instead, decoding
  there with the CUDA dequant kernel.
* **Failure semantics**: a producer error is STICKY — every subsequent
  ``next()`` re-raises it (never a hang on a dead prefetch thread), and
  ``stop()`` verifies the producer actually exited before the buffer ring
  may be handed to a successor (a zombie thread can never alias batches a
  restarted loader emits).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..core.spec import RawArrayError
from .dataset import RaDataset


@dataclass
class LoaderState:
    epoch: int = 0
    step: int = 0  # batches already emitted within this epoch
    # mesh loaders only: the epoch's segment history [(start_step, [hosts])]
    # — everything a (re)joining host needs to rebuild the exact schedule
    mesh_segments: Optional[list] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"epoch": self.epoch, "step": self.step}
        if self.mesh_segments is not None:
            d["mesh_segments"] = [[int(t), list(m)] for t, m in self.mesh_segments]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoaderState":
        segs = d.get("mesh_segments")
        return cls(
            epoch=int(d["epoch"]),
            step=int(d["step"]),
            mesh_segments=[(int(t), tuple(m)) for t, m in segs] if segs else None,
        )


class DataLoader:
    def __init__(
        self,
        dataset: RaDataset,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        host_id: int = 0,
        host_count: int = 1,
        prefetch: int = 2,
        drop_last: bool = True,
        reuse_buffers: bool = False,
        naive: bool = False,
        dequant: bool = True,
        mesh: Optional[Any] = None,
        where: Optional[Any] = None,
    ):
        if not drop_last:
            raise NotImplementedError("fixed-shape training wants drop_last")
        if where is not None and mesh is not None:
            raise ValueError(
                "where= filters rows with predicate pushdown; the mesh "
                "partitions by shard ownership — combine them by filtering "
                "at ingest instead"
            )
        if where is not None and naive:
            raise ValueError("naive=True is the seed baseline; it has no where mode")
        if naive and getattr(dataset, "is_remote", False):
            raise ValueError(
                "naive=True gathers via local mmaps and cannot stream a "
                "remote dataset; use the default engine path"
            )
        if mesh is not None and naive:
            raise ValueError("naive=True is the seed baseline; it has no mesh mode")
        self.mesh = mesh  # repro.distributed.data_mesh.DataMesh (duck-typed)
        if mesh is not None:
            host_id, host_count = mesh.host_index, mesh.host_count
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.host_id = host_id
        self.host_count = host_count
        self.prefetch = prefetch
        # queue capacity must be finite or the producer laps the buffer ring
        # (prefetch=0 would mean queue.Queue(maxsize=0) = unbounded)
        self._qcap = max(1, prefetch)
        self.reuse_buffers = reuse_buffers and not naive
        self.naive = naive  # seed-era produce path (benchmark baseline)
        # predicate-filtered loading (DESIGN.md §16): the matching global
        # row set is planned ONCE via chunk-stats pushdown; epochs then
        # shuffle/split only the matching rows
        self.where = where
        self._where_rows: Optional[np.ndarray] = None
        # host-side dequantization of quantized fields (DESIGN.md §12);
        # DeviceLoader turns this off and decodes on device instead
        self.dequant = dequant
        self._ring: list = []  # preallocated batch dicts when reuse_buffers
        # Regression note (ralint guarded-by): the epoch-plan memos are
        # written by the prefetch thread (epoch rollover) AND the consumer
        # (steps_per_epoch / _invalidate_plans) — the dict clear+insert used
        # to run with no lock at all. Same for the stats counters: producer
        # writes _produce_s while the consumer writes _wait_s/_n_batches.
        self._plans_lock = threading.Lock()
        self._plans: Dict[int, Any] = {}  # guarded-by: _plans_lock
        self._order_memo = None           # guarded-by: _plans_lock
        self._last_state: Optional[LoaderState] = None  # last DELIVERED batch
        self.state = LoaderState()
        self._stats_lock = threading.Lock()
        self._wait_s = 0.0    # guarded-by: _stats_lock
        self._produce_s = 0.0  # guarded-by: _stats_lock
        self._n_batches = 0   # guarded-by: _stats_lock
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        # fresh Event per prefetch thread (see _start_prefetch): stop() of a
        # wedged producer must not be undone by the next start's clear()
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None  # sticky producer error

    # ---- order ------------------------------------------------------------
    def _matched_rows(self) -> np.ndarray:
        """Global rows matching ``where`` (sorted), computed once per loader
        via ``RaDataset.select_indices`` — chunk pruning means the plan
        decodes only predicate columns of undecided chunks."""
        if self._where_rows is None:
            self._where_rows = self.ds.select_indices(self.where)
        return self._where_rows

    def _host_rows(self) -> np.ndarray:
        if self.where is not None:
            rows = self._matched_rows()
            per = len(rows) // self.host_count
            start = self.host_id * per
            stop = start + per if self.host_id < self.host_count - 1 else len(rows)
            return rows[start:stop]
        start, stop = self.ds.host_range(self.host_id, self.host_count)
        return np.arange(start, stop)

    def _mesh_plan(self, epoch: int):
        """The mesh's pure epoch schedule (DESIGN.md §15), memoized — plans
        are invalidated whenever the segment history can change (restore /
        repartition / seek)."""
        with self._plans_lock:
            plan = self._plans.get(epoch)
        if plan is None:
            # plan() is pure in (seed, epoch, ...): two threads racing here
            # compute identical plans, so only the memo writes need the lock
            plan = self.mesh.plan(
                [s.rows for s in self.ds.shards],
                seed=self.seed,
                epoch=epoch,
                batch_size=self.batch_size,
                shuffle=self.shuffle,
            )
            with self._plans_lock:
                if len(self._plans) > 4:
                    self._plans.clear()
                self._plans[epoch] = plan
        return plan

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.mesh is not None:
            return self._mesh_plan(epoch).host_order(self.mesh.host)
        rows = self._host_rows()
        if not self.shuffle:
            return rows
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(rows)

    def _cached_order(self, epoch: int) -> np.ndarray:
        """The permutation is a pure function of (seed, epoch): compute it
        once per epoch, not once per batch (the seed path recomputed it every
        ``_produce`` — measurable at high batch rates). Returns the LOCAL
        tuple's order, so a concurrent caller on another epoch (a zombie
        producer racing its successor) can't swap the memo underneath us."""
        cached = self._order_memo
        if cached is None or cached[0] != epoch:
            cached = (epoch, self._epoch_order(epoch))
            with self._plans_lock:
                self._order_memo = cached
        return cached[1]

    def steps_per_epoch(self) -> int:
        """Steps the CURRENT epoch runs — the GLOBAL MINIMUM over hosts, so
        lockstep collectives never hang on one host's remainder tail (the
        ``host_range`` split hands the last host the extra rows; the floor
        division used to give it a different step count). The dropped tail
        is exposed in ``stats()['dropped_tail_rows']``."""
        return self._spe(self.state.epoch)

    def _spe(self, epoch: int) -> int:
        if self.mesh is not None:
            # mesh epochs re-deal ownership, so the minimum-owner step count
            # is genuinely per-epoch (and per segment history)
            return self._mesh_plan(epoch).steps()
        if self.where is not None:
            return (len(self._matched_rows()) // self.host_count) // self.batch_size
        return (self.ds.total_rows // self.host_count) // self.batch_size

    def _dropped_tail(self, epoch: int) -> int:
        """Rows the epoch never delivers GLOBALLY (identical on every host)."""
        if self.mesh is not None:
            return self._mesh_plan(epoch).dropped_rows()
        total = (len(self._matched_rows()) if self.where is not None
                 else self.ds.total_rows)
        return total - self._spe(epoch) * self.batch_size * self.host_count

    # ---- synchronous iteration ---------------------------------------------
    def _make_ring(self) -> list:
        """qcap+2 preallocated batch dicts (stored dtypes): one held by the
        consumer, up to ``qcap`` queued, one being filled. Built on the
        consumer thread BEFORE the producer starts, and handed to it by
        reference — a zombie producer that outlived its join keeps its own
        (discarded) ring object and can never touch a successor's."""
        nbufs = self._qcap + 2
        specs = {f: self._stored_spec(f) for f in self.ds.fields}
        return [
            {
                f: np.empty((self.batch_size,) + shape, dtype)
                for f, (shape, dtype) in specs.items()
            }
            for _ in range(nbufs)
        ]

    def _stored_spec(self, field: str):
        """Stored (on-disk) row spec — uint8 for quantized fields; staging
        buffers and reads are planned in stored terms (DESIGN.md §12)."""
        spec = getattr(self.ds, "stored_spec", None)
        if spec is not None:
            return spec(field)
        info = self.ds.fields[field]
        return tuple(info["shape"]), np.dtype(info["dtype"])

    def _produce(
        self, epoch: int, step: int, out: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[str, np.ndarray]:
        if self.naive:
            order = self._epoch_order(epoch)  # seed behavior: fresh every batch
        else:
            order = self._cached_order(epoch)
        lo = step * self.batch_size
        idx = order[lo : lo + self.batch_size]
        if self.mesh is not None:
            if idx.size < self.batch_size or int(idx.min()) < 0:
                raise RawArrayError(
                    f"host {self.mesh.host!r} is not a mesh member at epoch "
                    f"{epoch} step {step} (left the membership?)"
                )
            # owned rows are non-contiguous even with shuffle=False — always
            # gather; the planner opens only this host's owned shards
            batch = self.ds.gather(idx, out=out)
        elif self.naive and self.shuffle:
            batch = self.ds.gather_naive(idx)
        elif self.shuffle or self.where is not None:
            # predicate-filtered rows are non-contiguous even unshuffled
            batch = self.ds.gather(idx, out=out)
        else:
            batch = self.ds.rows(int(idx[0]), int(idx[-1]) + 1, out=out)
        if self.dequant:
            for f, info in getattr(self.ds, "quant", {}).items():
                if f in batch:
                    # float32 affine decode — allocates a fresh logical array,
                    # so the emitted field never aliases the uint8 ring
                    batch[f] = info.dequantize(batch[f])
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._exc is not None:
            # sticky: the prefetch thread put ONE exception and exited — a
            # second get() would block forever on the empty queue, so every
            # subsequent next() re-raises instead (restart via stop()/restore)
            raise self._exc
        if self._q is None:
            self._start_prefetch()
        t0 = time.perf_counter()
        batch = self._q.get()
        with self._stats_lock:
            self._wait_s += time.perf_counter() - t0
            self._n_batches += 1
        if isinstance(batch, Exception):
            self._exc = batch
            raise batch
        # the last DELIVERED position anchors repartition(): queued-but-
        # undelivered prefetch batches are discarded and their rows re-dealt
        self._last_state = batch["_state"]
        return batch

    # ---- prefetch thread ---------------------------------------------------
    def _start_prefetch(self) -> None:
        # the queue AND the stop event are private to this thread (captured
        # by closure, not read back off self): a zombie predecessor that
        # outlived its join timeout can neither be revived by this clear-less
        # start nor push a stale batch into the new queue
        q = self._q = queue.Queue(maxsize=self._qcap)
        stop = self._stop = threading.Event()
        self._exc = None
        ring: Optional[list] = None
        if self.reuse_buffers:
            if not self._ring:
                self._ring = self._make_ring()
            ring = self._ring

        def run():
            epoch, step = self.state.epoch, self.state.step
            spe = self._spe(epoch)
            pos = 0
            while not stop.is_set():
                if spe <= 0:
                    # surface instead of spinning: with a mesh this means the
                    # smallest owner holds fewer than batch_size rows
                    e: Exception = RawArrayError(
                        f"epoch {epoch} has zero steps (batch_size="
                        f"{self.batch_size} exceeds the smallest host's rows)"
                    )
                    while not stop.is_set():
                        try:
                            q.put(e, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    return
                if step >= spe:
                    epoch, step = epoch + 1, 0
                    # a mesh re-deals ownership per epoch: the minimum-owner
                    # step count must be re-derived at every rollover
                    spe = self._spe(epoch)
                    continue
                try:
                    t0 = time.perf_counter()
                    buf = None
                    if ring is not None:
                        buf = ring[pos % len(ring)]
                        pos += 1
                    b = self._produce(epoch, step, buf)
                    with self._stats_lock:
                        self._produce_s += time.perf_counter() - t0
                except Exception as e:  # surface in consumer (sticky there)
                    while not stop.is_set():
                        try:
                            q.put(e, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    return
                b["_state"] = (
                    LoaderState(epoch, step)
                    if self.mesh is None
                    else LoaderState(epoch, step, self.mesh.segments_for(epoch))
                )
                step += 1
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True, name="ra-prefetch")
        self._thread.start()

    def restore(self, state: LoaderState) -> None:
        """Resume exactly after the batch `state` describes. A mesh state
        carries the epoch's segment history, so restoring mid-elastic-epoch
        rebuilds the identical schedule the original fleet was running."""
        self.stop()
        if self.mesh is not None and state.mesh_segments:
            self.mesh.load_segments(state.epoch, state.mesh_segments)
        self._invalidate_plans()
        self.state = LoaderState(state.epoch, state.step + 1)
        if self.state.step >= self._spe(state.epoch):
            self.state = LoaderState(state.epoch + 1, 0)

    def seek(self, epoch: int, step: int) -> None:
        """Position so the NEXT batch emitted is ``(epoch, step)`` — the
        joining-host entry point: build a ``DataMesh``, load the handed-over
        segment history (or call ``mesh.repartition``), then seek to the
        boundary step."""
        self.stop()
        self._invalidate_plans()
        self.state = LoaderState(int(epoch), int(step))

    def repartition(self, hosts) -> LoaderState:
        """Apply a mesh membership change effective at the next UNDELIVERED
        batch: the prefetch thread is stopped and its queued batches are
        discarded (their rows stay unconsumed in the segment replay, so they
        re-deal under the new ownership — exactly-once is preserved w.r.t.
        batches actually delivered), the mesh records the segment boundary,
        and prefetch restarts lazily under the new plan. No epoch restart.
        Returns the boundary position every surviving host must agree on."""
        if self.mesh is None:
            raise RawArrayError("repartition() requires a mesh loader")
        last = self._last_state
        if last is None:
            nxt = LoaderState(self.state.epoch, self.state.step)
        else:
            nxt = LoaderState(last.epoch, last.step + 1)
            if nxt.step >= self._spe(last.epoch):
                nxt = LoaderState(last.epoch + 1, 0)
        self.stop()
        self.mesh.repartition(hosts, epoch=nxt.epoch, step=nxt.step)
        self._invalidate_plans()
        self.state = LoaderState(nxt.epoch, nxt.step)
        return self.state

    def _invalidate_plans(self) -> None:
        with self._plans_lock:
            self._plans.clear()
            self._order_memo = None
        self._last_state = None

    def stop(self, join_timeout: float = 2.0) -> None:
        """Stop the prefetch thread and VERIFY it exited. If the join times
        out (a producer wedged in a slow read), the buffer ring is discarded
        so the zombie can never write into buffers a restarted loader hands
        out — the successor allocates a fresh ring; the zombie's private
        stop event stays set and its queue is orphaned, so the worst it can
        do is finish one produce into memory nobody reads."""
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                # zombie still running: it may be mid-_produce into the ring,
                # so orphan it — the next start allocates fresh buffers
                self._ring = []
        self._q = None
        self._thread = None
        self._exc = None

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            wait_s, produce_s, n = self._wait_s, self._produce_s, self._n_batches
        out = {
            "loader_wait_s": wait_s,
            "loader_produce_s": produce_s,
            "batches": float(n),
            # host identity + the lockstep tail (global, identical on every
            # host) — inputs to data_mesh.aggregate_stats
            "host_id": float(
                self.mesh.host_index if self.mesh is not None else self.host_id
            ),
            "host_count": float(
                self.mesh.host_count if self.mesh is not None else self.host_count
            ),
            "dropped_tail_rows": float(self._dropped_tail(self.state.epoch)),
        }
        io_stats = getattr(self.ds, "io_stats", None)
        if io_stats is not None:
            for k, v in io_stats().items():
                # chunk decode counters (DESIGN.md §10) are not cache stats
                key = k if k.startswith("chunk_") else f"remote_cache_{k}"
                out[key] = float(v)
        return out

"""Device feed plane for PyTorch: prefetch-to-device loader with on-device
dequant (DESIGN.md §12).

The host ``DataLoader`` ends at numpy batches in host RAM; a train step
would then pay the host→device copy inside its critical path. The torch
``DeviceLoader`` takes that copy off it:

* a feeder thread pulls host batches (the loader's prefetch ring is the
  staging buffer), copies every field into a pinned host slot and from
  there to the card with ``non_blocking`` copies on a side CUDA stream,
  keeping up to ``RA_DEVICE_BUFS`` (default 2) batches resident on the
  device;
* quantized fields (DESIGN.md §12) cross the link as uint8 — 4× fewer
  bytes than float32 — and are decoded on the card by the hand-written
  CUDA kernel ``repro_torch.kernels.ops.dequant_rows``, launched by the
  feeder on the same side stream; the wrapped loader's host-side
  dequantization is turned off automatically;
* ``stats()`` folds ``h2d_s`` (time inside device transfers), ``h2d_bytes``
  (bytes actually moved) and ``device_wait_s`` (consumer starved on the
  device queue) into the wrapped loader's counters.

Buffer safety: after queueing a batch's copies the feeder records a
copy-done event and waits on it before it pulls the next host batch, so
neither the wrapped loader's ``reuse_buffers`` ring nor a pinned slot is
rewritten while a copy from it is in flight. A ready event recorded after
the decode travels with the batch; ``__next__`` makes the consumer's
current stream wait on it and marks every tensor as used by that stream,
so the caching allocator never hands the memory out early.

On ``device="cpu"`` the batch fields become tensors over the host arrays
(copied first when the loader reuses its buffers) and the decode runs the
plain PyTorch version. With no ``device`` the loader runs on the current
CUDA device, and raises when there is none.

Producer errors are sticky exactly like the host loader's: every ``next()``
after a failure re-raises instead of hanging.

Usage::

    loader = DeviceLoader(DataLoader(RaDataset(root), batch, ...))
    batch = next(loader)        # fields are torch tensors on the card
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.spec import RawArrayError, env_int
from .loader import DataLoader, LoaderState

#: logical dtypes a quantized field may decode to
_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


def default_device_bufs() -> int:
    """Device-resident batch depth (knob ``RA_DEVICE_BUFS``, default 2)."""
    return max(1, env_int("RA_DEVICE_BUFS", 2))


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device. With neither, raise: nothing here carries on on
    the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RawArrayError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def torch_dtype(orig_dtype: Any) -> torch.dtype:
    """The torch dtype of a quantized field's logical (``orig_dtype``) type."""
    name = str(orig_dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise RawArrayError(
            f"quantized field decodes to {name}, which the device decode "
            f"cannot write (supported: {', '.join(_TORCH_DTYPES)})"
        ) from None


class DeviceLoader:
    """Wrap a ``DataLoader`` so consumers receive batches as torch tensors
    on ``device`` (default: the current CUDA device).

    ``bufs`` device batches (knob ``RA_DEVICE_BUFS``) are kept in flight;
    quantized fields are moved as uint8 and dequantized on the card by the
    CUDA kernel (DESIGN.md §12). The wrapped loader must not have started
    iterating yet (its prefetch pipeline is reconfigured here).
    ``block_rows`` is accepted for parity with the JAX package and passed
    to ``ops.dequant_rows``, which does not use it.
    """

    def __init__(
        self,
        loader: DataLoader,
        *,
        bufs: Optional[int] = None,
        device: Any = None,
        block_rows: Optional[int] = None,
        global_arrays: Optional[bool] = None,
    ):
        if loader._q is not None or loader._thread is not None:
            raise RawArrayError(
                "DeviceLoader must wrap a DataLoader that has not started "
                "iterating (stop() it first)"
            )
        mesh = getattr(loader, "mesh", None)
        if global_arrays or (global_arrays is None and mesh is not None):
            raise NotImplementedError(
                "global batch assembly over a data mesh is not ported yet "
                "(ROADMAP.md, modules to port: data-mesh device assembly)"
            )
        self.device = resolve_device(device)
        self.loader = loader
        # device decode replaces host decode: raw uint8 over the wire
        loader.dequant = False
        self.bufs = max(1, bufs if bufs is not None else default_device_bufs())
        self._block_rows = block_rows
        self._quant_dev: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.dtype]] = {}
        # the feeder thread writes the h2d_* counters while the consumer
        # writes _wait_s/_n_batches and stats() reads both
        self._stats_lock = threading.Lock()
        self._h2d_s = 0.0      # guarded-by: _stats_lock
        self._h2d_bytes = 0    # guarded-by: _stats_lock
        self._h2d_n = 0        # guarded-by: _stats_lock
        self._wait_s = 0.0     # guarded-by: _stats_lock
        self._n_batches = 0    # guarded-by: _stats_lock
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

    # ---- quantized-field kernel parameters ---------------------------------
    def _quant_params(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.dtype]]:
        """Per-field ``(scale, bias, out_dtype)`` with scale/bias already on
        the device, built once: the dequant kernel wants ``(C,)`` float32
        for the last axis of each quantized field."""
        if not self._quant_dev:
            for f, info in getattr(self.loader.ds, "quant", {}).items():
                shape, _ = self.loader.ds.logical_spec(f)
                if not shape:
                    raise RawArrayError(
                        f"quantized field {f!r} has a scalar row shape"
                    )
                scale, bias = info.channel_params(int(shape[-1]))
                self._quant_dev[f] = (
                    torch.from_numpy(scale).to(self.device),
                    torch.from_numpy(bias).to(self.device),
                    torch_dtype(info.orig_dtype),
                )
        return self._quant_dev

    # ---- feeder thread ------------------------------------------------------
    def _start(self) -> None:
        q = self._q = queue.Queue(maxsize=self.bufs)
        stop = self._stop = threading.Event()
        self._exc = None
        dev = self.device
        # captured by value: a zombie feeder that outlives its join timeout
        # keeps THIS loader object (and its own pinned slots) even after
        # stop() swaps in a fresh one, so it can never steal batches from
        # (or poison the sticky-error state of) a restarted pipeline
        loader = self.loader
        detach = bool(getattr(loader, "reuse_buffers", False))
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        pinned: Dict[str, torch.Tensor] = {}

        def run():
            while not stop.is_set():
                try:
                    batch = next(loader)
                    state = batch.pop("_state", None)
                    nbytes = sum(int(v.nbytes) for v in batch.values())
                    t0 = time.perf_counter()
                    if stream is None:
                        moved = {k: _host_tensor(v, detach) for k, v in batch.items()}
                        ready = None
                    else:
                        moved, ready = self._to_cuda(batch, pinned, stream)
                    with self._stats_lock:
                        self._h2d_s += time.perf_counter() - t0
                        self._h2d_bytes += nbytes
                        self._h2d_n += 1
                    if stream is None:
                        self._dequant_on_device(moved)
                    item: Any = (moved, state, ready)
                except Exception as e:  # surface in consumer (sticky there)
                    item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=run, daemon=True, name="ra-h2d")
        self._thread.start()

    def _to_cuda(
        self,
        batch: Dict[str, np.ndarray],
        pinned: Dict[str, torch.Tensor],
        stream: torch.cuda.Stream,
    ) -> Tuple[Dict[str, torch.Tensor], torch.cuda.Event]:
        """Host batch → pinned slots → the card on ``stream``; the decode
        is queued behind the copies on the same stream. Returns the device
        fields and the event that marks them ready. Blocks until the copies
        (not the decode) are done, so the host buffers may be reused."""
        moved: Dict[str, torch.Tensor] = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                slot = pinned.get(k)
                if slot is None or tuple(slot.shape) != v.shape or slot.numpy().dtype != v.dtype:
                    slot = torch.empty(v.shape, dtype=_torch_of(v.dtype), pin_memory=True)
                    pinned[k] = slot
                np.copyto(slot.numpy(), v)
                moved[k] = slot.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
            self._dequant_on_device(moved)
            ready = torch.cuda.Event()
            ready.record(stream)
        copied.synchronize()
        return moved, ready

    # ---- iteration ----------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def _dequant_on_device(self, moved: Dict[str, torch.Tensor]) -> None:
        """Decode quantized fields in place (uint8 on the device → float
        out; DESIGN.md §12). Runs on the feeder thread, on the current
        stream, so decode overlaps the consumer's train step."""
        quant = self._quant_params()
        if not quant:
            return
        from ..kernels import ops

        for f, (scale, bias, out_dtype) in quant.items():
            if f in moved:
                moved[f] = ops.dequant_rows(
                    moved[f], scale, bias, out_dtype=out_dtype,
                    block_rows=self._block_rows,
                )

    def __next__(self) -> Dict[str, Any]:
        if self._exc is not None:
            raise self._exc  # sticky, same contract as DataLoader.__next__
        if self._q is None:
            self._start()
        t0 = time.perf_counter()
        item = self._q.get()
        with self._stats_lock:
            self._wait_s += time.perf_counter() - t0
        if isinstance(item, Exception):
            self._exc = item
            raise item
        moved, state, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in moved.values():
                t.record_stream(consumer)
        moved["_state"] = state
        with self._stats_lock:
            self._n_batches += 1
        return moved

    # ---- lifecycle ----------------------------------------------------------
    def stop(self) -> None:
        """Stop the feeder and VERIFY it exited, then stop the wrapped
        loader. A feeder wedged past the join timeout (blocked inside the
        wrapped loader) keeps only its captured references: the wrapped
        loader is REPLACED with an equivalent fresh one, so the zombie can
        never steal a batch from — or stick a stale error onto — a
        restarted pipeline."""
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                self.loader = self._detached_clone(self.loader)
        self._q = None
        self._thread = None
        self._exc = None
        self.loader.stop()

    @staticmethod
    def _detached_clone(old: DataLoader) -> DataLoader:
        """A fresh DataLoader equivalent to ``old`` (same dataset, order,
        position) sharing none of its queues, events, or buffers; ``old``
        stays with the zombie feeder that still references it."""
        old_q = old._q
        old.stop()  # best-effort: signals old's own producer too
        if old_q is not None:
            # wake a feeder blocked in old.__next__'s q.get(): the sentinel
            # error makes next() raise, and the feeder's (set) stop event
            # then ends the thread instead of leaking it on an orphaned get
            try:
                old_q.put_nowait(
                    RawArrayError("loader detached from a wedged device feeder")
                )
            except queue.Full:
                pass
        new = DataLoader(
            old.ds, old.batch_size, seed=old.seed, shuffle=old.shuffle,
            host_id=old.host_id, host_count=old.host_count,
            prefetch=old.prefetch, reuse_buffers=old.reuse_buffers,
            naive=old.naive, dequant=old.dequant, mesh=old.mesh,
        )
        new.state = LoaderState(old.state.epoch, old.state.step)
        return new

    def restore(self, state: LoaderState) -> None:
        """Resume exactly after the batch ``state`` describes (drains the
        device pipeline, then delegates to the wrapped loader)."""
        self.stop()
        self.loader.restore(state)

    def steps_per_epoch(self) -> int:
        return self.loader.steps_per_epoch()

    @property
    def ds(self):
        return self.loader.ds

    @property
    def state(self) -> LoaderState:
        return self.loader.state

    def stats(self) -> Dict[str, float]:
        """Wrapped loader counters plus the device feed's: ``h2d_s`` (time
        inside host→device transfers), ``h2d_bytes`` (bytes moved — 4×
        smaller for quantized fields), ``device_wait_s`` (consumer starved
        on the device queue: the straggler signal), ``device_batches``."""
        out = dict(self.loader.stats())
        with self._stats_lock:
            out.update(
                h2d_s=self._h2d_s,
                h2d_bytes=float(self._h2d_bytes),
                h2d_batches=float(self._h2d_n),  # feeder runs ahead of consumer
                device_wait_s=self._wait_s,
                device_batches=float(self._n_batches),
            )
        return out


def _torch_of(dtype: np.dtype) -> torch.dtype:
    """The torch dtype with the same bytes as a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _host_tensor(v: np.ndarray, detach: bool) -> torch.Tensor:
    """A CPU tensor of one host field. A reused ring buffer (``detach``) or
    a read-only array is copied, so the batch never changes under the
    consumer when the ring recycles."""
    if detach or not v.flags.writeable:
        v = np.array(v, copy=True)
    return torch.from_numpy(np.ascontiguousarray(v))

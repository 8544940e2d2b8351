"""Cold-start restore engine: checkpoint directory → tensors on the card in
one overlapped pipeline (DESIGN.md §13), the torch twin of the JAX package's
``checkpoint/coldstart.py`` for local checkpoints.

``load_checkpoint`` reads phase by phase and leaves the upload to the
caller. ``restore_pipelined`` overlaps the phases:

1. **pin wave** — every leaf file is pinned by inode identity (mtime and
   size, plus a held fd), so a checkpoint overwritten mid-restore fails
   fast instead of silently mixing generations;
2. **bounded streaming** — leaves are admitted largest-first under an
   in-flight byte budget (knob ``RA_COLDSTART_INFLIGHT``); each admitted
   leaf's driver resolves its header, chunk table and quant schema and fans
   its slab reads or chunk decodes onto the shared engine pool, straight
   into a pinned host tensor;
3. **overlapped device upload** — whichever pool thread completes a leaf
   queues its ``non_blocking`` copy to the card and, for a quantized-u8
   leaf, the ``dequant_u8`` CUDA kernel (``ops.dequant_rows``: uint8
   crosses the link, floats appear on the card) without waiting, while
   later leaves are still being read; one ``torch.cuda.synchronize`` of the
   target device at the end is the barrier.

The kernel library is built and loaded on a side thread while the first
leaves are read. ``restore_naive`` keeps the phase-by-phase baseline.
Sharded placements (``shardings``) and URL checkpoints are not ported yet.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import core as ra
from ..core.spec import env_int
from ..data.device_loader import resolve_device, torch_dtype
from .store import Leaf, _load_manifest, _read_leaves_parallel, dequant_host, flatten, numel, unflatten


def default_inflight_bytes() -> int:
    """In-flight host-buffer budget (knob ``RA_COLDSTART_INFLIGHT``, default
    1 GiB): peak host bytes held by leaves that are read but not yet queued
    to the device. Quantized leaves count their stored (uint8) size."""
    return max(1, env_int("RA_COLDSTART_INFLIGHT", 1 << 30))


@dataclass
class ColdStartStats:
    """Filled in by :func:`restore_pipelined` (pass one in to collect)."""

    leaves: int = 0
    logical_bytes: int = 0         # sum of restored (post-dequant) leaf bytes
    stored_bytes: int = 0          # sum of on-disk payload bytes
    resolve_s: float = 0.0         # wave 1: version pins
    restore_s: float = 0.0         # total time to all-weights-resident
    h2d_s: float = 0.0             # time queueing copies + dequant, and the final barrier
    h2d_bytes: int = 0             # bytes crossing the host->device boundary
    dequant_leaves: int = 0        # leaves decoded from u8
    peak_inflight_bytes: int = 0   # observed max of the scheduler's budget
    inflight_cap: int = 0          # the budget it ran under


def _no_shardings(shardings: Any, opt_shardings: Any) -> None:
    if shardings is not None or opt_shardings is not None:
        raise NotImplementedError(
            "sharded restore is not ported yet (ROADMAP.md, modules to port, item 8)"
        )


def shardings_from_specs(mesh, tree: Any) -> Any:
    raise NotImplementedError(
        "sharded restore is not ported yet (ROADMAP.md, modules to port, item 8)"
    )


@dataclass
class _Plan:
    leaf: Leaf
    want: Tuple[int, ...] = ()
    cost: int = 0                  # budget charge while in flight
    pin: Any = None                # (mtime_ns, size)
    pinned: Any = None             # Event: pin taken (or failed)
    pin_err: Any = None
    out: Any = None                # the restored tensor


def _local_pin(fpath: str) -> Tuple[int, int]:
    st = os.stat(fpath)
    return (st.st_mtime_ns, st.st_size)


def _check_pin(plan: _Plan) -> None:
    """Fail fast when a leaf file was replaced mid-restore."""
    leaf = plan.leaf
    try:
        now = _local_pin(leaf.fpath)
    except OSError as e:
        raise ra.RawArrayError(
            f"{leaf.name}: checkpoint leaf {leaf.fpath} vanished during restore ({e})"
        ) from None
    if now != plan.pin:
        raise ra.RawArrayError(
            f"{leaf.name}: checkpoint leaf {leaf.fpath} changed during restore "
            "(checkpoint overwritten?); restart the restore"
        )


class _Budget:
    """In-flight byte accounting: admit (blocking), release, peak tracking."""

    def __init__(self, cap: int):
        self.cap = cap
        self.used = 0   # guarded-by: _cond
        self.peak = 0   # guarded-by: _cond
        self._cond = threading.Condition()
        self._aborted = False  # guarded-by: _cond

    def admit(self, cost: int) -> bool:
        """Block until ``cost`` fits (a single over-budget leaf is admitted
        alone). Returns False if the restore aborted."""
        with self._cond:
            while not self._aborted and self.used > 0 and self.used + cost > self.cap:
                self._cond.wait(timeout=0.5)
            if self._aborted:
                return False
            self.used += cost
            self.peak = max(self.peak, self.used)
            return True

    def release(self, cost: int) -> None:
        with self._cond:
            self.used -= cost
            self._cond.notify_all()

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


def _upload(quant: Any, buf: torch.Tensor, device: torch.device) -> Tuple[torch.Tensor, bool]:
    """Queue one leaf's host buffer to ``device`` (no wait); a u8 leaf
    (``quant`` its ``QuantInfo``) is decoded there by the dequant kernel.
    Returns (tensor, dequantized)."""
    from ..kernels import ops

    if quant is not None and buf.dim() == 0:  # 0-d quantized: decode on the host
        return dequant_host(buf, quant).to(device, non_blocking=True), True
    moved = buf.to(device, non_blocking=True)
    if quant is None:
        return moved, False
    scale, bias = (torch.from_numpy(a).to(device, non_blocking=True)
                   for a in quant.channel_params(int(buf.shape[-1])))
    return ops.dequant_rows(moved, scale, bias, out_dtype=torch_dtype(quant.orig_dtype)), True


def _start_warmup(plans: List[_Plan], device: torch.device) -> Optional[threading.Thread]:
    """Build and load the dequant kernel's library while the first leaves
    are read, when the checkpoint has quantized leaves for the card. The
    caller joins the thread before returning."""
    if device.type != "cuda" or not any(p.leaf.entry.get("quant") for p in plans):
        return None

    def run() -> None:
        try:
            from ..kernels import _build

            _build.load("dequant_u8.cu")
        except Exception:
            pass  # best-effort; the first real launch surfaces errors

    # ralint: allow=thread-lifecycle -- returned to restore_pipelined, which
    # joins it in its finally block; a bounded build-and-load body
    t = threading.Thread(target=run, daemon=True, name="ra-coldstart-warm")
    t.start()
    return t


def _plans(path: str, manifest: Dict[str, Any], trees, st: ColdStartStats):
    plans: List[_Plan] = []
    tree_meta = []
    for prefix, tree in trees:
        flat = flatten(tree, prefix)
        for name, like in flat.items():
            entry = manifest["leaves"].get(name)
            if entry is None:
                raise ra.RawArrayError(f"{name}: missing from checkpoint manifest")
            want = tuple(int(d) for d in like.shape)
            if "shape" in entry and tuple(entry["shape"]) != want:
                raise ValueError(f"{name}: checkpoint {tuple(entry['shape'])} vs model {want}")
            plan = _Plan(Leaf(name, ra.join_path(path, entry["file"]), entry), want=want)
            elems = numel(want)
            if entry.get("quant") is not None:
                orig = torch_dtype(entry["quant"].get("orig_dtype", "float32"))
                st.logical_bytes += elems * orig.itemsize
                plan.cost = elems  # uint8 codes on the host
            else:
                logical = elems * like.element_size() if hasattr(like, "element_size") \
                    else int(getattr(like, "nbytes", elems))
                st.logical_bytes += logical
                plan.cost = max(logical, 1)
            plans.append(plan)
        tree_meta.append((prefix, tree, list(flat)))
    return plans, tree_meta


def restore_pipelined(
    path: str,
    params_like: Any,
    opt_like: Any = None,
    *,
    device: Any = None,
    shardings: Any = None,
    opt_shardings: Any = None,
    inflight_bytes: Optional[int] = None,
    stats: Optional[ColdStartStats] = None,
    _after_resolve: Optional[Callable[[], None]] = None,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """Restore a checkpoint with read, decode, upload and dequant overlapped.

    Same contract as ``load_checkpoint(path, params_like, opt_like)`` except
    that the leaves land on ``device`` (default: the current CUDA device;
    raises without one unless ``device="cpu"`` is passed):

    * ``inflight_bytes`` — override the ``RA_COLDSTART_INFLIGHT`` budget;
    * ``stats`` — a :class:`ColdStartStats` to fill in;
    * ``_after_resolve`` — test hook, called between the pin wave and
      streaming (changing the checkpoint here must trip the pins).

    Raises ``RawArrayError`` when a leaf file changes between its pin and
    its upload (never a silently mixed checkpoint)."""
    _no_shardings(shardings, opt_shardings)
    device = resolve_device(device)
    pin_host = device.type == "cuda"
    st = stats if stats is not None else ColdStartStats()
    st.inflight_cap = cap = max(1, inflight_bytes if inflight_bytes is not None
                                else default_inflight_bytes())
    t_all = time.perf_counter()
    manifest = _load_manifest(path)
    trees = [("param", params_like)] + ([("opt", opt_like)] if opt_like is not None else [])
    plans, tree_meta = _plans(path, manifest, trees, st)
    by_name = {p.leaf.name: p for p in plans}
    st.leaves = len(plans)

    t0 = time.perf_counter()
    warmup: Optional[threading.Thread] = None
    # a finished leaf hands over to the next through the GIL; CPython's 5 ms
    # switch interval would be the latency of each such wake while the pool
    # runs, so the restore tightens it for its own window
    prev_switch = sys.getswitchinterval()
    sys.setswitchinterval(min(prev_switch, 0.001))
    budget = _Budget(cap)
    try:
        warmup = _start_warmup(plans, device)
        order = sorted(plans, key=lambda p: p.cost, reverse=True)
        first_err: List[BaseException] = []
        err_lock = threading.Lock()
        stats_lock = threading.Lock()
        all_done = threading.Event()
        done_count = [0]
        pins_done = threading.Event()
        pins_left = [len(order)]

        def _fail(e: BaseException) -> None:
            with err_lock:
                if not first_err:
                    first_err.append(e)
            budget.abort()
            all_done.set()

        def _count_done() -> None:
            with stats_lock:
                done_count[0] += 1
                if done_count[0] == len(order):
                    all_done.set()

        def _pin_task(plan: _Plan) -> None:
            try:
                plan.pin = _local_pin(plan.leaf.fpath)
                plan.leaf.open()
            except BaseException as e:  # noqa: BLE001 — re-raised by the driver
                plan.pin_err = e
            finally:
                plan.pinned.set()
                with stats_lock:
                    pins_left[0] -= 1
                    if pins_left[0] == 0:
                        st.resolve_s = time.perf_counter() - t0
                        pins_done.set()

        inline = (ra.engine.workers() == 1 or ra.engine.sequential_forced()
                  or ra.engine.on_engine_thread())
        pool = None if inline else ra.engine.get_pool()
        for plan in order:
            plan.pinned = threading.Event()
        for plan in order:
            if pool is None:
                _pin_task(plan)
            else:
                pool.submit(_pin_task, plan)
        if not order:
            pins_done.set()
            all_done.set()
        if _after_resolve is not None:
            pins_done.wait()
            _after_resolve()

        def _finish_leaf(plan: _Plan, buf: torch.Tensor) -> None:
            """Pin check, then the device copy (+ dequant) queued without
            waiting, on whichever pool thread finished the leaf's reads."""
            try:
                _check_pin(plan)
                t1 = time.perf_counter()
                plan.out, dequant = _upload(plan.leaf.quant, buf, device)
                with stats_lock:
                    st.h2d_s += time.perf_counter() - t1
                    st.h2d_bytes += buf.numel() * buf.element_size()
                    st.dequant_leaves += int(dequant)
            except BaseException as e:  # noqa: BLE001 — forwarded
                _fail(e)
            finally:
                budget.release(plan.cost)
                _count_done()

        def _drive_leaf(plan: _Plan) -> None:
            """Resolve the leaf, then fan out its payload tasks."""
            try:
                plan.pinned.wait()
                if plan.pin_err is not None:
                    raise plan.pin_err
                plan.leaf.resolve(plan.want)
                with stats_lock:
                    st.stored_bytes += int(plan.leaf.hdr.data_length)
                buf = plan.leaf.buffer(pin=pin_host)
                tasks = plan.leaf.tasks(buf)
            except BaseException as e:  # noqa: BLE001 — forwarded
                budget.release(plan.cost)
                _fail(e)
                _count_done()
                return
            if not tasks:
                _finish_leaf(plan, buf)
                return
            remaining = [len(tasks)]
            rlock = threading.Lock()

            def _wrap(task: Callable[[], None]) -> None:
                try:
                    if not first_err:
                        task()
                except BaseException as e:  # noqa: BLE001 — forwarded
                    _fail(e)
                finally:
                    with rlock:
                        remaining[0] -= 1
                        last = remaining[0] == 0
                if last and not first_err:
                    _finish_leaf(plan, buf)
                elif last:
                    budget.release(plan.cost)
                    _count_done()

            for task in tasks:
                if pool is None:
                    _wrap(task)
                else:
                    pool.submit(_wrap, task)

        for plan in order:
            if not budget.admit(plan.cost):
                _count_done()  # never scheduled; keep the ledger whole
                continue
            if first_err:
                budget.release(plan.cost)
                _count_done()
                continue
            if pool is None:
                _drive_leaf(plan)
            else:
                pool.submit(_drive_leaf, plan)
        all_done.wait()
        if first_err:
            raise first_err[0]
        # one barrier for every copy and decode the pool threads queued
        t1 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        st.h2d_s += time.perf_counter() - t1
    finally:
        sys.setswitchinterval(prev_switch)
        if warmup is not None:
            warmup.join()
        for p in plans:
            p.leaf.close()

    st.peak_inflight_bytes = budget.peak
    st.restore_s = time.perf_counter() - t_all
    outs = [unflatten(tree, prefix, {n: by_name[n].out for n in names})
            for prefix, tree, names in tree_meta]
    return outs[0], (outs[1] if opt_like is not None else None), manifest.get("extra", {})


def restore_naive(
    path: str,
    params_like: Any,
    opt_like: Any = None,
    *,
    device: Any = None,
    shardings: Any = None,
    opt_shardings: Any = None,
    stats: Optional[ColdStartStats] = None,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """Phase-by-phase restore: read every leaf to the host first, then copy
    (and dequantize on the card) leaf by leaf, waiting for each. The same
    per-leaf decode as :func:`restore_pipelined`, so the two are bit-exact
    and differ only in overlap. The baseline and the escape hatch."""
    _no_shardings(shardings, opt_shardings)
    device = resolve_device(device)
    st = stats if stats is not None else ColdStartStats()
    t_all = time.perf_counter()
    manifest = _load_manifest(path)
    trees = [("param", params_like)] + ([("opt", opt_like)] if opt_like is not None else [])
    outs: List[Any] = []
    for prefix, tree in trees:
        flat = flatten(tree, prefix)
        quants: Dict[str, Any] = {}
        host = _read_leaves_parallel(path, manifest, list(flat), quants_out=quants)
        moved: Dict[str, torch.Tensor] = {}
        for name, like in flat.items():
            buf = host[name]
            want = tuple(int(d) for d in like.shape)
            if tuple(buf.shape) != want:
                raise ValueError(f"{name}: checkpoint {tuple(buf.shape)} vs model {want}")
            quant = quants.get(name)
            st.leaves += 1
            st.logical_bytes += buf.numel() * (
                torch_dtype(quant.orig_dtype).itemsize if quant is not None else buf.element_size()
            )
            t0 = time.perf_counter()
            moved[name], dequant = _upload(quant, buf, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            st.h2d_s += time.perf_counter() - t0
            st.h2d_bytes += buf.numel() * buf.element_size()
            st.dequant_leaves += int(dequant)
        outs.append(unflatten(tree, prefix, moved))
    st.restore_s = time.perf_counter() - t_all
    return outs[0], (outs[1] if opt_like is not None else None), manifest.get("extra", {})

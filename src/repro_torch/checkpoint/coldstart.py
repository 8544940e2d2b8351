"""Cold-start restore engine: checkpoint (path or URL) → tensors on the card
in one overlapped pipeline (DESIGN.md §13), the torch twin of the JAX
package's ``checkpoint/coldstart.py``.

``load_checkpoint`` reads phase by phase and leaves the upload to the
caller. ``restore_pipelined`` overlaps the phases:

1. **pin wave** — the whole remote version set pins in ONE ``/stat``
   listing round trip per checkpoint directory (sizes + ETags; servers
   without the route fall back to per-leaf HEADs), local leaves by inode
   identity (mtime and size, plus a held fd), so a checkpoint overwritten
   mid-restore fails fast instead of silently mixing generations; a
   bounded number of keep-alive sockets pre-warm for the fetch wave;
2. **bounded streaming** — leaves are admitted largest-first under an
   in-flight byte budget (knob ``RA_COLDSTART_INFLIGHT``); each admitted
   leaf's driver resolves its header, chunk table and quant schema and fans
   its slab reads (local preads or pooled ranged requests) or chunk decodes
   onto the shared engine pool, straight into a pinned host tensor;
3. **overlapped device upload** — whichever pool thread completes a leaf
   queues its ``non_blocking`` copy to the card and, for a quantized-u8
   leaf, the ``dequant_u8`` CUDA kernel (``ops.dequant_rows``: uint8
   crosses the link, floats appear on the card) without waiting, while
   later leaves are still being read; one ``torch.cuda.synchronize`` of the
   target device at the end is the barrier.

The kernel library is built and loaded on a side thread while the first
leaves are read. ``restore_naive`` keeps the phase-by-phase baseline.
``shardings`` restores onto a ``DeviceMesh`` (see :func:`shardings_from_specs`):
each process builds its own block of a sharded leaf with
``DTensor.from_local``, as ``jax.device_put(arr, sharding)`` does when every
process holds the host array.
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
    resolve_s: float = 0.0         # wave 1: version pins + socket pre-warm
    restore_s: float = 0.0         # total time to all-weights-resident
    h2d_s: float = 0.0             # time queueing copies + dequant, and the final barrier
    h2d_bytes: int = 0             # bytes crossing the host->device boundary
    dequant_leaves: int = 0        # leaves decoded from u8
    prewarmed_conns: int = 0       # sockets opened by pool pre-warm
    peak_inflight_bytes: int = 0   # observed max of the scheduler's budget
    inflight_cap: int = 0          # the budget it ran under


def _is_spec(x: Any) -> bool:
    """A partition spec: None, or a tuple of one mesh-axis name or None per
    dimension (what a ``PartitionSpec`` holds)."""
    return x is None or (isinstance(x, tuple)
                         and all(e is None or isinstance(e, str) for e in x))


def _is_placement(x: Any) -> bool:
    """A per-leaf placement: None (the ``device`` path), or ``(mesh,
    placements)`` as :func:`shardings_from_specs` makes it."""
    from torch.distributed.device_mesh import DeviceMesh

    return x is None or (isinstance(x, tuple) and len(x) == 2
                         and isinstance(x[0], DeviceMesh))


def _flatten_shardings(tree: Any) -> List[Any]:
    """The placements of a shardings tree in ``store.flatten``'s leaf order
    (dict keys sorted), None leaves kept: one entry per parameter leaf."""
    out: List[Any] = []

    def walk(node: Any) -> None:
        if _is_placement(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            raise TypeError(f"not a placement or a tree of them: {node!r}")

    walk(tree)
    return out


def shardings_from_specs(mesh, tree: Any) -> Any:
    """Map a tree of partition specs (None, or a tuple of one mesh-axis name
    or None per dimension) to ``(mesh, placements)`` per leaf on the
    ``DeviceMesh`` ``mesh``: ``Shard(d)`` on the mesh dimension a spec names
    for dimension ``d``, ``Replicate()`` elsewhere (None replicates the whole
    leaf). The bridge from per-leaf rule specs to the placement
    :func:`restore_pipelined` consumes."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())

    def one(spec: Any) -> Tuple[Any, Tuple[Any, ...]]:
        placements: List[Any] = [Replicate()] * mesh.ndim
        for dim, axis in enumerate(spec or ()):
            if axis is None:
                continue
            if axis not in names:
                raise ValueError(f"mesh axis {axis!r} of spec {spec} is not in mesh {names}")
            i = names.index(axis)
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {axis!r} is named twice in spec {spec}")
            placements[i] = Shard(dim)
        return mesh, tuple(placements)

    def walk(node: Any) -> Any:
        if _is_spec(node):
            return one(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"not a partition spec or a tree of them: {node!r}")

    return walk(tree)


def _shardings_list(shtree: Any, n: int, prefix: str) -> List[Any]:
    if shtree is None:
        return [None] * n
    flat = _flatten_shardings(shtree)
    if len(flat) != n:
        raise ValueError(f"shardings tree has {len(flat)} leaves, {prefix} tree has {n}")
    return flat


def _place_sharded(quant: Any, buf: torch.Tensor, sharding: Any, name: str) -> torch.Tensor:
    """This process's block of a sharded leaf as a ``DTensor``. A quantized
    leaf is decoded on the host first (the reference's algorithm, so the
    result is bit-equal to the host decode); the block goes to this
    process's device. A sharded dimension must divide over its mesh
    dimension, as ``jax.device_put`` to a ``NamedSharding`` requires."""
    from torch.distributed.tensor import DTensor, Shard

    from ..distributed.data_mesh import mesh_device

    if quant is not None:
        buf = dequant_host(buf, quant)
    mesh, placements = sharding
    coord = mesh.get_coordinate()
    local = buf
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n, d = mesh.size(i), p.dim
        if buf.shape[d] % n:
            raise ValueError(
                f"{name}: dimension {d} of {tuple(buf.shape)} does not divide over "
                f"the {n} devices of mesh axis {mesh.mesh_dim_names[i]!r}")
        per = buf.shape[d] // n
        local = local.narrow(d, coord[i] * per, per)
    local = local.to(mesh_device(mesh), non_blocking=True, copy=True)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=buf.shape, stride=buf.stride())


@dataclass
class _Plan:
    leaf: Leaf
    want: Tuple[int, ...] = ()
    cost: int = 0                  # budget charge while in flight
    pin: Any = None                # (mtime_ns, size) local | ETag str remote
    pinned: Any = None             # Event: pin taken (or failed)
    pin_err: Any = None
    sharding: Any = None           # (mesh, placements), or None: ``device``
    out: Any = None                # the restored tensor


def _local_pin(fpath: str) -> Tuple[int, int]:
    st = os.stat(fpath)
    return (st.st_mtime_ns, st.st_size)


def _pin_leaf(plan: _Plan, stat_pins: Optional[Dict[str, Tuple[int, Optional[str]]]] = None) -> None:
    """Pin one leaf's version — local leaves by inode identity (mtime+size,
    plus a held fd), remote leaves by ETag: from the checkpoint directory's
    one-shot ``/stat`` listing when available (zero per-leaf round trips),
    else a revalidating HEAD. Touches no payload bytes."""
    leaf = plan.leaf
    if ra.is_url(leaf.fpath):
        from .. import remote

        ent = stat_pins.get(leaf.fpath) if stat_pins else None
        if ent is not None:
            # a stale listing cannot slip through: every ranged response's
            # ETag is checked against this pin, so a leaf replaced between
            # listing and read fails loudly on its first byte
            reader = remote.get_reader(leaf.fpath, pinned=ent)
        else:
            # revalidate: the pin must be the server's CURRENT generation,
            # not whatever an earlier traversal cached
            reader = remote.get_reader(leaf.fpath, revalidate=True)
        leaf.src = reader
        plan.pin = reader.etag
    else:
        plan.pin = _local_pin(leaf.fpath)
        leaf.open()


def _stat_pins(plans: List[_Plan]) -> Dict[str, Tuple[int, Optional[str]]]:
    """Version-set pinning in one round trip per checkpoint directory: a
    ``/stat`` listing returns (size, ETag) for every file, the HTTP
    analogue of S3's ListObjectsV2; servers without the route leave the map
    empty and leaves HEAD-pin individually."""
    urls = [p.leaf.fpath for p in plans if ra.is_url(p.leaf.fpath)]
    if not urls:
        return {}
    from .. import remote

    pins: Dict[str, Tuple[int, Optional[str]]] = {}
    for d in sorted({u.rsplit("/", 1)[0] for u in urls}):
        try:
            listing = remote.stat_dir(d)
        except remote.RemoteAuthError:
            raise  # denial is authoritative — don't retry it once per leaf
        except ra.RawArrayError:
            continue  # no /stat route (older server) — fall back per leaf
        for name, ent in listing.items():
            pins[f"{d}/{name}"] = ent
    return pins


def _prewarm_alloc(plans: List[_Plan]) -> Dict[str, int]:
    """Socket pre-warm budget, per leaf: the fetch wave runs at most
    ``engine.workers()`` tasks at once, so that is the total number of
    sockets worth holding open across all leaves, spent largest-first (those
    leaves are admitted first and are the only ones whose chunk fetches fan
    out over several connections). Each reader's construction HEAD already
    parks one socket, which ``prewarm`` counts."""
    alloc: Dict[str, int] = {}
    left = ra.engine.workers()
    for p in sorted(plans, key=lambda p: p.cost, reverse=True):
        if left <= 0:
            break
        if not ra.is_url(p.leaf.fpath):
            continue
        est = max(1, min(-(-p.cost // max(1, ra.engine.chunk_bytes())), left))
        n = min(est, left)  # RemoteReader.prewarm re-caps at RA_REMOTE_CONNS
        alloc[p.leaf.name] = n
        left -= n
    return alloc


def _check_pin(plan: _Plan) -> None:
    """Fail fast when a local leaf file was replaced mid-restore (the
    remote twin is the per-response ETag check inside ``RemoteReader``)."""
    if not isinstance(plan.pin, tuple):
        return
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


def _place(quant: Any, buf: torch.Tensor, device: torch.device, sharding: Any,
           name: str) -> Tuple[torch.Tensor, bool, int]:
    """One leaf's placement: this process's block of a sharded leaf, else
    the whole leaf on ``device`` (a u8 leaf through the dequant kernel).
    Returns (tensor, dequantized, bytes that crossed to the device)."""
    if sharding is None:
        out, dequant = _upload(quant, buf, device)
        return out, dequant, buf.numel() * buf.element_size()
    out = _place_sharded(quant, buf, sharding, name)
    local = out.to_local()
    return out, quant is not None, local.numel() * local.element_size()


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
    for prefix, tree, shtree in trees:
        flat = flatten(tree, prefix)
        shards = _shardings_list(shtree, len(flat), prefix)
        for (name, like), sh in zip(flat.items(), shards):
            entry = manifest["leaves"].get(name)
            if entry is None:
                raise ra.RawArrayError(f"{name}: missing from checkpoint manifest")
            want = tuple(int(d) for d in like.shape)
            if "shape" in entry and tuple(entry["shape"]) != want:
                raise ValueError(f"{name}: checkpoint {tuple(entry['shape'])} vs model {want}")
            plan = _Plan(Leaf(name, ra.join_path(path, entry["file"]), entry), want=want,
                         sharding=sh)
            elems = numel(want)
            if entry.get("quant") is not None:
                orig = torch_dtype(entry["quant"].get("orig_dtype", "float32"))
                st.logical_bytes += elems * orig.itemsize
                # uint8 codes on the host, but a sharded leaf is decoded there
                plan.cost = elems * (orig.itemsize if sh is not None else 1)
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
    prewarm: bool = True,
    stats: Optional[ColdStartStats] = None,
    _after_resolve: Optional[Callable[[], None]] = None,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """Restore a checkpoint with read, decode, upload and dequant overlapped.

    Same contract as ``load_checkpoint(path, params_like, opt_like)`` except
    that the leaves land on ``device`` (default: the current CUDA device;
    raises without one unless ``device="cpu"`` is passed):

    * ``shardings``/``opt_shardings`` — optional trees (matching
      ``params_like``/``opt_like``) of ``(mesh, placements)`` per leaf, or
      None for ``device``, for a resharded restore onto a live mesh (see
      :func:`shardings_from_specs`); a sharded leaf comes back as a
      ``DTensor`` holding this process's block, a sharded quantized leaf
      decoded on the host first;
    * ``inflight_bytes`` — override the ``RA_COLDSTART_INFLIGHT`` budget;
    * ``prewarm`` — open keep-alive sockets for a URL checkpoint's fetch
      wave during the pin wave;
    * ``stats`` — a :class:`ColdStartStats` to fill in;
    * ``_after_resolve`` — test hook, called between the pin wave and
      streaming (changing the checkpoint here must trip the pins).

    Raises ``RawArrayError`` when any leaf's pinned version (local
    mtime+size, remote ETag) changes mid-restore, and propagates auth and
    transport errors unchanged (never a silently mixed checkpoint)."""
    device = resolve_device(device)
    pin_host = device.type == "cuda"
    st = stats if stats is not None else ColdStartStats()
    st.inflight_cap = cap = max(1, inflight_bytes if inflight_bytes is not None
                                else default_inflight_bytes())
    t_all = time.perf_counter()
    manifest = _load_manifest(path)
    trees = [("param", params_like, shardings)] + (
        [("opt", opt_like, opt_shardings)] if opt_like is not None else [])
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
        # one listing per checkpoint dir pins the whole remote version set
        stat_pins = _stat_pins(plans)
        alloc = _prewarm_alloc(plans) if prewarm else {}
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
                _pin_leaf(plan, stat_pins)
                n = alloc.get(plan.leaf.name, 0)
                if n and ra.is_url(plan.leaf.fpath):
                    got = plan.leaf.src.prewarm(n)
                    with stats_lock:
                        st.prewarmed_conns += got
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
                plan.out, dequant, nbytes = _place(plan.leaf.quant, buf, device,
                                                   plan.sharding, plan.leaf.name)
                with stats_lock:
                    st.h2d_s += time.perf_counter() - t1
                    st.h2d_bytes += nbytes
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
            e = first_err[0]
            if isinstance(e, ra.RawArrayError) and "changed on server during read" in str(e):
                raise ra.RawArrayError(f"checkpoint overwritten during restore: {e}") from e
            raise e
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
    device = resolve_device(device)
    st = stats if stats is not None else ColdStartStats()
    t_all = time.perf_counter()
    manifest = _load_manifest(path)
    trees = [("param", params_like, shardings)] + (
        [("opt", opt_like, opt_shardings)] if opt_like is not None else [])
    outs: List[Any] = []
    for prefix, tree, shtree in trees:
        flat = flatten(tree, prefix)
        shards = _shardings_list(shtree, len(flat), prefix)
        quants: Dict[str, Any] = {}
        host = _read_leaves_parallel(path, manifest, list(flat), quants_out=quants)
        moved: Dict[str, torch.Tensor] = {}
        for (name, like), sh in zip(flat.items(), shards):
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
            moved[name], dequant, nbytes = _place(quant, buf, device, sh, name)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            st.h2d_s += time.perf_counter() - t0
            st.h2d_bytes += nbytes
            st.dequant_leaves += int(dequant)
        outs.append(unflatten(tree, prefix, moved))
    st.restore_s = time.perf_counter() - t_all
    return outs[0], (outs[1] if opt_like is not None else None), manifest.get("extra", {})

"""Runtime concurrency sanitizer for the threaded data plane (DESIGN.md §17).

Two instruments, installed by a caller (:func:`install`, :func:`watch_all`;
the JAX package's copy is also activated under pytest with
``--ra-sanitize``):

1. **Instrumented locks.**  :func:`install` replaces ``threading.Lock`` /
   ``RLock`` / ``Condition`` with drop-in wrappers — but only for locks
   *created from this repo's source files* (the creating frame's filename
   is checked), so stdlib machinery (queues, socketserver, executors) stays
   raw and the overhead stays bounded.  Every wrapper records its creation
   site (``file:line``); acquisitions feed a process-global acquisition
   graph keyed by site.  Detected:

   * **lock-order inversion** — acquiring B while holding A after the
     graph already established B →* A (a potential deadlock even if this
     run never interleaved badly);
   * **long hold** — a lock held longer than ``RA_TSAN_HOLD_MS``
     (warning, not error: the edge tier deliberately holds a path lock
     across an origin revalidation);
   * **acquire-after-finalize** — taking a lock whose owner declared the
     protected object dead (:meth:`finalize`); the loader ring's old zombie writer
     is exactly a finalized-lock acquirer.

   Same-site edges are ignored: two instances of one class (e.g. two
   ``BlockCache``\\ s) share a site, and ordering within a site class is
   the owning module's business.

2. **Guarded-field write tracer.**  :func:`watch_class` patches a class's
   ``__setattr__`` to check every write of a ``# guarded-by:`` annotated
   field (maps come from ``repro_torch.devtools.guards``' comment scanner via
   :func:`watch_module`): if the field was already initialized, the named
   lock exists and is *not held by the writing thread*, and the writer is
   not the thread that constructed the object, an **unguarded-write**
   error is recorded.  The block cache's old counter race (``cache.hits += 1``
   outside ``_lock``) is the canonical catch.

Reports accumulate in a global list; :func:`drain` empties it (the pytest
plugin fails any test that leaves error-severity reports behind).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..core.spec import env_float as _env_float

# Real primitives, captured before any patching can occur.
_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_condition = threading.Condition

# ------------------------------------------------------------------ reports
@dataclass(frozen=True)
class Report:
    kind: str       # lock-order-inversion | long-hold | acquire-after-finalize | unguarded-write
    severity: str   # "error" | "warn"
    message: str
    where: str      # site or object description
    thread: str

    def __str__(self) -> str:
        return f"[{self.kind}/{self.severity}] {self.where}: {self.message} (thread {self.thread})"


_reports: List[Report] = []
_reports_lock = _real_lock()


def record(kind: str, severity: str, message: str, where: str) -> None:
    rep = Report(kind, severity, message, where, threading.current_thread().name)
    with _reports_lock:
        _reports.append(rep)


def reports(errors_only: bool = False) -> List[Report]:
    with _reports_lock:
        out = list(_reports)
    return [r for r in out if r.severity == "error"] if errors_only else out


def drain() -> List[Report]:
    """Return all accumulated reports and clear the buffer."""
    with _reports_lock:
        out = list(_reports)
        _reports.clear()
    return out


# ------------------------------------------------- per-thread held-lock stack
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


# ------------------------------------------------------- acquisition graph
_graph: Dict[str, Set[str]] = {}
_graph_lock = _real_lock()
_reported_pairs: Set[Tuple[str, str]] = set()


def _reaches(a: str, b: str) -> bool:
    """True when the graph has a path a ->* b (callers hold _graph_lock)."""
    seen = {a}
    stack = [a]
    while stack:
        n = stack.pop()
        if n == b:
            return True
        for m in _graph.get(n, ()):
            if m not in seen:
                seen.add(m)
                stack.append(m)
    return False


def _note_acquire_edges(lock: "_TsanLockBase") -> None:
    held_sites = {e[0].site for e in _held() if e[0] is not lock}
    held_sites.discard(lock.site)  # same-site: ordering is the class's business
    if not held_sites:
        return
    tgt = lock.site
    with _graph_lock:
        for s in held_sites:
            _graph.setdefault(s, set()).add(tgt)
        for s in held_sites:
            if (s, tgt) not in _reported_pairs and _reaches(tgt, s):
                _reported_pairs.add((s, tgt))
                record(
                    "lock-order-inversion",
                    "error",
                    f"acquiring {tgt} while holding {s}, but the order "
                    f"{tgt} -> ... -> {s} was already established elsewhere "
                    "(potential deadlock)",
                    tgt,
                )


def acquisition_graph() -> Dict[str, Set[str]]:
    """Snapshot of the site-level lock-order graph (DESIGN.md §17 catalog)."""
    with _graph_lock:
        return {k: set(v) for k, v in _graph.items()}


# ---------------------------------------------------------- lock wrappers
class _TsanLockBase:
    _reentrant = False

    def __init__(self, raw, site: str):
        self._raw = raw
        self.site = site
        self._finalized = False

    # -- bookkeeping helpers
    def _held_by_current(self) -> bool:
        return any(e[0] is self for e in _held())

    # -- the Lock protocol
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._finalized:
            record(
                "acquire-after-finalize",
                "error",
                "lock acquired after finalize() declared its protected "
                "state dead (zombie thread still running?)",
                self.site,
            )
        if not (self._reentrant and self._held_by_current()):
            _note_acquire_edges(self)
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            _held().append((self, time.monotonic()))
        return ok

    def release(self):
        self._raw.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                _, t0 = held.pop(i)
                dt_ms = (time.monotonic() - t0) * 1000.0
                if dt_ms > _hold_ms():
                    record(
                        "long-hold",
                        "warn",
                        f"lock held {dt_ms:.0f} ms "
                        f"(> RA_TSAN_HOLD_MS={_hold_ms():g})",
                        self.site,
                    )
                return
        # release without a matching acquire record (e.g. lock taken before
        # install): delegate silently

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        try:
            return self._raw.locked()
        except AttributeError:  # pragma: no cover - old RLock without .locked
            return self._held_by_current()

    def finalize(self) -> None:
        """Declare the protected state dead; later acquires are errors."""
        self._finalized = True

    def __repr__(self):
        return f"<tsan {type(self).__name__} site={self.site}>"


class _TsanLock(_TsanLockBase):
    """Instrumented non-reentrant lock (wraps ``threading.Lock``)."""

    # Condition-protocol delegation: keep our bookkeeping exact instead of
    # letting Condition fall back to acquire(False) probes (which would
    # pollute the acquisition graph with probe edges).
    def _release_save(self):
        self.release()

    def _acquire_restore(self, _state):
        self.acquire()

    def _is_owned(self):
        return self._held_by_current()


class _TsanRLock(_TsanLockBase):
    """Instrumented reentrant lock (wraps ``threading.RLock``)."""

    _reentrant = True

    def _release_save(self):
        held = _held()
        mine = [i for i, e in enumerate(held) if e[0] is self]
        for i in reversed(mine):
            held.pop(i)
        return (self._raw._release_save(), len(mine))

    def _acquire_restore(self, state_n):
        state, n = state_n
        self._raw._acquire_restore(state)
        now = time.monotonic()
        _held().extend([(self, now)] * max(1, n))

    def _is_owned(self):
        return self._raw._is_owned()


# ------------------------------------------------------------- installation
_installed = False
_scope: Tuple[str, ...] = ()
_hold_ms_override: Optional[float] = None


def _hold_ms() -> float:
    if _hold_ms_override is not None:
        return _hold_ms_override
    return _env_float("RA_TSAN_HOLD_MS", 500.0)


def _default_scope() -> Tuple[str, ...]:
    sep = os.sep
    return (f"{sep}repro_torch{sep}", f"{sep}tests{sep}", f"{sep}benchmarks{sep}")


def _site_of(depth: int) -> Optional[str]:
    """Creation site of the caller ``depth`` frames up, or None if out of
    scope (stdlib, third-party) — out-of-scope callers get raw locks."""
    fr = sys._getframe(depth)
    fn = fr.f_code.co_filename
    if not any(p in fn for p in _scope):
        return None
    parts = fn.replace(os.sep, "/").rsplit("/", 2)
    short = "/".join(parts[-2:])
    return f"{short}:{fr.f_lineno}"


def _make_lock():
    site = _site_of(2)
    raw = _real_lock()
    return raw if site is None else _TsanLock(raw, site)


def _make_rlock(_depth: int = 2):
    site = _site_of(_depth)
    raw = _real_rlock()
    return raw if site is None else _TsanRLock(raw, site)


def _make_condition(lock=None):
    if lock is None:
        lock = _make_rlock(_depth=3)  # attribute the site to Condition()'s caller
    return _real_condition(lock)


def install(scope: Optional[Tuple[str, ...]] = None, hold_ms: Optional[float] = None) -> None:
    """Patch ``threading.Lock``/``RLock``/``Condition`` with the wrappers.

    Idempotent.  ``scope`` is a tuple of path fragments; only locks created
    from matching files are instrumented (default: this repo's ``src``,
    ``tests`` and ``benchmarks`` trees).
    """
    global _installed, _scope, _hold_ms_override
    _scope = tuple(scope) if scope else _default_scope()
    _hold_ms_override = hold_ms
    if _installed:
        return
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    _installed = True


def uninstall() -> None:
    """Restore the real primitives and forget graph state (reports stay
    until :func:`drain`)."""
    global _installed
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    threading.Condition = _real_condition
    _installed = False
    with _graph_lock:
        _graph.clear()
        _reported_pairs.clear()


def installed() -> bool:
    return _installed


# ------------------------------------------------------ guarded-field tracer
# class -> (original __setattr__, {field: lock attr name})
_watched: Dict[type, Tuple[object, Dict[str, str]]] = {}
# id(obj) -> creating thread ident (id-keyed: works for __slots__ classes
# too; only populated while watching, cleared by unwatch_all)
_creators: Dict[int, int] = {}
_creators_lock = _real_lock()


def _lock_held_by_me(lock) -> Optional[bool]:
    """True/False when ownership is decidable, None when it is not."""
    if isinstance(lock, _TsanLockBase):
        return lock._held_by_current()
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is not None:
        try:
            return bool(is_owned())
        except Exception:  # pragma: no cover - exotic lock
            return None
    locked = getattr(lock, "locked", None)
    if locked is not None:
        try:
            # raw Lock: held by *someone* -> can't attribute, assume ok;
            # not held at all -> definitely unguarded
            return None if locked() else False
        except Exception:  # pragma: no cover
            return None
    return None


def _check_guarded_write(obj, name: str, lockname: str, cls: type) -> None:
    if not hasattr(obj, name):
        # first write = construction; remember who built the object
        with _creators_lock:
            _creators.setdefault(id(obj), threading.get_ident())
        return
    lock = getattr(obj, lockname, None)
    if lock is None:
        return  # lock lives elsewhere (e.g. on the owning Router) — static rule covers it
    held = _lock_held_by_me(lock)
    if held is not False:
        return
    me = threading.get_ident()
    with _creators_lock:
        creator = _creators.get(id(obj))
    if creator == me:
        # single-owner mutation by the constructing thread is the loader
        # ring idiom; cross-thread writes are what race
        return
    record(
        "unguarded-write",
        "error",
        f"write to {cls.__name__}.{name} (guarded-by: {lockname}) without "
        f"holding the lock, from a thread that did not construct the object",
        f"{cls.__module__}.{cls.__name__}.{name}",
    )


def watch_class(cls: type, fields: Dict[str, str]) -> None:
    """Trace writes to ``fields`` (``{field: lock_attr}``) on ``cls``."""
    if not fields:
        return
    if cls in _watched:
        _watched[cls][1].update(fields)
        return
    orig = cls.__setattr__
    fmap = dict(fields)

    def traced_setattr(self, name, value, _orig=orig, _fmap=fmap, _cls=cls):
        lockname = _fmap.get(name)
        if lockname is not None:
            _check_guarded_write(self, name, lockname, _cls)
        _orig(self, name, value)

    cls.__setattr__ = traced_setattr
    _watched[cls] = (orig, fmap)


def watch_module(module) -> List[str]:
    """Watch every ``# guarded-by:`` annotated class of ``module`` (the
    map comes from ralint's comment scanner). Returns watched class names."""
    from .guards import collect_guards

    path = getattr(module, "__file__", None)
    if not path or not os.path.isfile(path):
        return []
    watched = []
    for clsname, fields in collect_guards(path).items():
        cls = getattr(module, clsname, None)
        if isinstance(cls, type):
            watch_class(cls, fields)
            watched.append(clsname)
    return watched


#: the threaded modules of this package that :func:`watch_all` traces
DEFAULT_WATCH_MODULES = (
    "repro_torch.remote.cache",
    "repro_torch.remote.client",
    "repro_torch.remote.server",
    "repro_torch.fleet.edge",
    "repro_torch.fleet.router",
    "repro_torch.data.loader",
    "repro_torch.data.device_loader",
    "repro_torch.checkpoint.coldstart",
)


def watch_all(modules: Tuple[str, ...] = DEFAULT_WATCH_MODULES) -> List[str]:
    import importlib

    watched = []
    for name in modules:
        mod = importlib.import_module(name)
        for cls in watch_module(mod):
            watched.append(f"{name}.{cls}")
    return watched


def unwatch_all() -> None:
    for cls, (orig, _fields) in _watched.items():
        cls.__setattr__ = orig
    _watched.clear()
    with _creators_lock:
        _creators.clear()

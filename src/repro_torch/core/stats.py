"""Per-chunk statistics + predicate pushdown (DESIGN.md §16).

Two halves, one module:

1. The ``rastats`` block — a versioned, ``od``-introspectable metadata
   block (like ``rachunks``) holding min / max / NaN-count / count per
   *stats window* per field.  A stats window is the run of elements whose
   byte span intersects ``[i*chunk_bytes, (i+1)*chunk_bytes)``; for
   chunked files the windows coincide exactly with the chunk table's
   chunks, for plain files they are virtual chunks at multiples of the
   same default.  Elements straddling a boundary are counted in *both*
   windows, so every window's ``[min, max]`` interval conservatively
   covers every element it touches.  All arrays are little-endian:
   counts/nan-counts as ``<u8``, bounds as f64 (integer bounds are
   rounded *outward* via nextafter so pruning can never overshoot).

2. The predicate engine — a small composable AST (``col("label") == 3``,
   ``(col("t") >= a) & (col("t") < b)``, ``&``/``|``/``~``) that maps a
   predicate plus per-field stats to per-row verdicts
   {take-all, prune, scan} using exact three-valued interval logic.
   A comparison is row-true iff **all** elements of that field's row
   satisfy it; NaN fails every comparison except ``!=`` (IEEE-754).
   Verdicts are conservative: a row is *pruned* only when the stats
   prove every element fails, *taken* only when they prove every
   element passes; anything else is *scanned* (decoded + masked), so
   missing, corrupt, or unknown-version stats degrade to a full scan —
   never a wrong answer.

Wire format (all little-endian, 40 + 32*nchunks bytes, prepended to the
user-metadata region after the chunk table)::

    u64 magic        = "rastats_"
    u64 version      = 1
    u64 block_bytes  = 40 + 32*nchunks
    u64 nchunks      (number of stats windows)
    u64 chunk_bytes  (window width in payload bytes)
    u64 count[nchunks]   elements per window (straddlers counted twice)
    u64 nan_count[nchunks]
    f64 min[nchunks]     NaN when the window holds no numeric value
    f64 max[nchunks]
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

import numpy as np

from . import layouts
from .spec import RawArrayError

RASTATS_MAGIC: int = layouts.RASTATS.magic_int
RASTATS_MAGIC_BYTES: bytes = layouts.RASTATS.magic
STATS_VERSION = 1

_HEAD = layouts.RASTATS.head_struct  # magic, version, block_bytes, nchunks, chunk_bytes
HEAD_BYTES = layouts.RASTATS.head_bytes  # 40
ENTRY_BYTES = layouts.RASTATS.entry_bytes  # u64 count + u64 nan_count + f64 min + f64 max


def stats_supported(dtype) -> bool:
    """True when per-chunk min/max statistics are defined for ``dtype``.

    Covers bool, signed/unsigned integers and IEEE floats (DESIGN.md
    §16); complex, strings and exotic dtypes get no stats block and
    therefore always full-scan.
    """
    return np.dtype(dtype).kind in "biuf"


def _f64_down(x) -> float:
    """Largest-or-equal f64 lower bound of exact value ``x`` (int)."""
    f = float(x)
    return f if f <= x else float(np.nextafter(f, -np.inf))


def _f64_up(x) -> float:
    """Smallest-or-equal f64 upper bound of exact value ``x`` (int)."""
    f = float(x)
    return f if f >= x else float(np.nextafter(f, np.inf))


# --------------------------------------------------------------------------
# the rastats block
# --------------------------------------------------------------------------
@dataclass
class ChunkStats:
    """Decoded ``rastats`` block: per-window statistics (DESIGN.md §16).

    ``mins``/``maxs`` are f64 with integer bounds rounded outward; a NaN
    bound means the window holds no numeric (non-NaN) value at all.
    """

    chunk_bytes: int
    counts: np.ndarray      # u64 [nchunks]
    nan_counts: np.ndarray  # u64 [nchunks]
    mins: np.ndarray        # f64 [nchunks]
    maxs: np.ndarray        # f64 [nchunks]
    version: int = STATS_VERSION

    @property
    def nchunks(self) -> int:
        return len(self.counts)

    @property
    def nbytes(self) -> int:
        return HEAD_BYTES + ENTRY_BYTES * self.nchunks

    def encode(self) -> bytes:
        """Serialize to the little-endian wire form (DESIGN.md §16)."""
        n = self.nchunks
        head = _HEAD.pack(RASTATS_MAGIC, self.version,
                          HEAD_BYTES + ENTRY_BYTES * n, n, self.chunk_bytes)
        return (head
                + np.ascontiguousarray(self.counts, dtype="<u8").tobytes()
                + np.ascontiguousarray(self.nan_counts, dtype="<u8").tobytes()
                + np.ascontiguousarray(self.mins, dtype="<f8").tobytes()
                + np.ascontiguousarray(self.maxs, dtype="<f8").tobytes())

    @classmethod
    def decode(cls, buf: bytes) -> "ChunkStats":
        """Strict decode of one block; raises RawArrayError on any damage."""
        st, rest = split_stats(buf, strict=True)
        if st is None:
            raise RawArrayError("rastats: no statistics block found")
        return st


def split_stats(meta: bytes, *, strict: bool = False
                ) -> Tuple[Optional[ChunkStats], bytes]:
    """Split a trailing-metadata region into ``(stats, user_metadata)``.

    Files written before the stats era (or with stats off) simply have
    no ``rastats_`` magic and pass through as ``(None, meta)``.  A block
    with damaged framing (truncated, impossible geometry) yields
    ``(None, meta)`` with a warning — callers then full-scan rather than
    trust bad bounds (DESIGN.md §16).  With ``strict=True`` damage
    raises RawArrayError instead (used by ``racat verify``).
    """
    b = bytes(meta)
    if len(b) < HEAD_BYTES or not b.startswith(RASTATS_MAGIC_BYTES):
        return None, b

    def _bad(msg: str):
        if strict:
            raise RawArrayError(f"rastats: {msg}")
        warnings.warn(f"rastats: {msg}; ignoring statistics (full scan)",
                      RuntimeWarning, stacklevel=3)
        return None, b

    magic, version, block_bytes, n, chunk_bytes = _HEAD.unpack_from(b)
    if n > (len(b) - HEAD_BYTES) // ENTRY_BYTES:
        return _bad(f"truncated block ({n} chunks, {len(b)} bytes available)")
    if block_bytes != HEAD_BYTES + ENTRY_BYTES * n:
        return _bad(f"block_bytes {block_bytes} inconsistent with nchunks {n}")
    if n > 0 and chunk_bytes <= 0:
        return _bad(f"invalid chunk_bytes {chunk_bytes}")
    rest = b[block_bytes:]
    if version != STATS_VERSION:
        # framing is sound, content rules unknown: strip but don't trust
        if strict:
            raise RawArrayError(f"rastats: unknown version {version}")
        warnings.warn(f"rastats: unknown version {version}; ignoring "
                      "statistics (full scan)", RuntimeWarning, stacklevel=3)
        return None, rest
    off = HEAD_BYTES
    counts = np.frombuffer(b, dtype="<u8", count=n, offset=off)
    nans = np.frombuffer(b, dtype="<u8", count=n, offset=off + 8 * n)
    mins = np.frombuffer(b, dtype="<f8", count=n, offset=off + 16 * n)
    maxs = np.frombuffer(b, dtype="<f8", count=n, offset=off + 24 * n)
    if bool(np.any(nans.astype(np.int64) > counts.astype(np.int64))):
        return _bad("nan_count exceeds count")
    return ChunkStats(chunk_bytes=int(chunk_bytes), counts=counts,
                      nan_counts=nans, mins=mins, maxs=maxs,
                      version=int(version)), rest


class StatsAccumulator:
    """Streaming min/max/NaN/count accumulator (DESIGN.md §16).

    Feed it the payload as it is produced — either typed batches via
    :meth:`add` (``RaWriter.write_rows``) or raw stored-order bytes via
    :meth:`feed` (``ChunkStreamCompressor``) — and collect the finished
    :class:`ChunkStats` with :meth:`finish`.  Both entry points produce
    byte-identical blocks for the same payload, which is what keeps the
    streamed writers byte-identical to the monolithic ``io.write``.
    """

    def __init__(self, dtype, chunk_bytes: int):
        dt = np.dtype(dtype)
        if not stats_supported(dt):
            raise RawArrayError(f"rastats: unsupported dtype {dt}")
        if int(chunk_bytes) <= 0:
            raise RawArrayError(f"rastats: invalid chunk_bytes {chunk_bytes}")
        self._dt = dt              # stored-order dtype (for feed())
        self._eb = dt.itemsize
        self._cb = int(chunk_bytes)
        self._isfloat = dt.kind == "f"
        self._carry = b""
        self._elems = 0
        self._counts: list = []
        self._nans: list = []
        self._mins: list = []
        self._maxs: list = []

    def feed(self, data) -> None:
        """Accumulate raw payload bytes (stored byte order, any framing)."""
        b = bytes(data)
        if self._carry:
            b = self._carry + b
        n = len(b) // self._eb
        self._carry = b[n * self._eb:]
        if n:
            self._update(np.frombuffer(b, dtype=self._dt, count=n))

    def add(self, arr) -> None:
        """Accumulate a typed batch (rows in logical order, any shape)."""
        a = np.ascontiguousarray(arr).reshape(-1)
        if a.size:
            self._update(a)

    def _grow(self, upto: int) -> None:
        while len(self._counts) <= upto:
            self._counts.append(0)
            self._nans.append(0)
            self._mins.append(float("nan"))
            self._maxs.append(float("nan"))

    def _update(self, vals: np.ndarray) -> None:
        e0, n, eb, cb = self._elems, vals.size, self._eb, self._cb
        ci0 = (e0 * eb) // cb
        ci1 = ((e0 + n) * eb - 1) // cb
        self._grow(ci1)
        for ci in range(ci0, ci1 + 1):
            lo = max(e0, (ci * cb) // eb)
            hi = min(e0 + n, -(-((ci + 1) * cb) // eb))
            if hi <= lo:
                continue
            seg = vals[lo - e0:hi - e0]
            self._counts[ci] += seg.size
            if self._isfloat:
                self._nans[ci] += int(np.count_nonzero(np.isnan(seg)))
                mn = float(np.fmin.reduce(seg.astype(np.float64, copy=False)))
                mx = float(np.fmax.reduce(seg.astype(np.float64, copy=False)))
            else:
                mn = _f64_down(int(seg.min()))
                mx = _f64_up(int(seg.max()))
            self._mins[ci] = float(np.fmin(self._mins[ci], mn))
            self._maxs[ci] = float(np.fmax(self._maxs[ci], mx))
        self._elems += n

    def finish(self) -> ChunkStats:
        """Return the accumulated block (empty payload -> zero windows)."""
        return ChunkStats(
            chunk_bytes=self._cb,
            counts=np.asarray(self._counts, dtype="<u8"),
            nan_counts=np.asarray(self._nans, dtype="<u8"),
            mins=np.asarray(self._mins, dtype="<f8"),
            maxs=np.asarray(self._maxs, dtype="<f8"),
        )


def compute_stats(arr, chunk_bytes: int) -> ChunkStats:
    """One-shot stats for a whole logical array (monolithic ``io.write``)."""
    acc = StatsAccumulator(np.asarray(arr).dtype, chunk_bytes)
    acc.add(arr)
    return acc.finish()


# --------------------------------------------------------------------------
# predicate engine
# --------------------------------------------------------------------------
def _round2(value) -> Tuple[float, float, bool]:
    """(v_down, v_up, exact): outward f64 bounds of a comparison value."""
    v = float(value)
    if v == value:
        return v, v, True
    if v < value:
        return v, float(np.nextafter(v, np.inf)), False
    return float(np.nextafter(v, -np.inf)), v, False


class Expr:
    """Composable predicate over dataset fields (DESIGN.md §16).

    Build leaves with :func:`col` and combine with ``&`` / ``|`` / ``~``.
    A comparison is row-true iff *all* elements of the field's row
    satisfy it (NaN satisfies only ``!=``).
    """

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __bool__(self):
        raise TypeError(
            "predicates combine with & | ~ (not and/or/not or chained "
            "comparisons); e.g. (col('t') >= a) & (col('t') < b)")

    def fields(self) -> Set[str]:
        """Names of every field this predicate reads."""
        raise NotImplementedError

    def mask(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Exact per-row boolean mask over decoded rows."""
        raise NotImplementedError

    def row_verdicts(self, nrows: int, field_info) -> Tuple[np.ndarray, np.ndarray]:
        """Conservative per-row ``(definitely_true, definitely_false)``.

        ``field_info`` maps field name -> ``(ChunkStats | None,
        row_nbytes)``.  Rows in neither array must be scanned.  Missing
        stats or geometry that disagrees with ``nrows * row_nbytes``
        (stale block) degrade that leaf to scan-everything.
        """
        raise NotImplementedError


def _as_expr(e) -> "Expr":
    if not isinstance(e, Expr):
        raise TypeError(f"expected a predicate Expr, got {type(e).__name__}")
    return e


def _row_intervals(st: Optional[ChunkStats], nrows: int, row_nbytes: int):
    """Per-row abstract value set from window intervals, or None to scan.

    Returns ``(mn, mx, has_nan, has_num)`` f64/bool arrays of length
    ``nrows`` where each row's interval is the fmin/fmax union over every
    window its byte span intersects (straddling windows painted on both
    sides — the dual of the writer's double-counting).
    """
    if st is None or nrows <= 0:
        return None
    total = nrows * row_nbytes
    expected = -(-total // st.chunk_bytes) if (total > 0 and st.chunk_bytes > 0) else 0
    if st.nchunks != expected:
        warnings.warn(
            f"rastats: window count {st.nchunks} does not match payload "
            f"geometry (expected {expected}); ignoring statistics (full "
            "scan)", RuntimeWarning, stacklevel=4)
        return None
    mn = np.full(nrows, np.nan)
    mx = np.full(nrows, np.nan)
    has_nan = np.zeros(nrows, dtype=bool)
    has_num = np.zeros(nrows, dtype=bool)
    cb, rnb = st.chunk_bytes, row_nbytes
    win_num = ~np.isnan(st.mins)
    win_nan = st.nan_counts > 0
    for ci in range(st.nchunks):
        r0 = (ci * cb) // rnb
        r1 = min(nrows, -(-min((ci + 1) * cb, total) // rnb))
        if r1 <= r0:
            continue
        s = slice(r0, r1)
        mn[s] = np.fmin(mn[s], st.mins[ci])
        mx[s] = np.fmax(mx[s], st.maxs[ci])
        if win_nan[ci]:
            has_nan[s] = True
        if win_num[ci]:
            has_num[s] = True
    return mn, mx, has_nan, has_num


_OPS = {
    "eq": lambda a, v: a == v,
    "ne": lambda a, v: a != v,
    "lt": lambda a, v: a < v,
    "le": lambda a, v: a <= v,
    "gt": lambda a, v: a > v,
    "ge": lambda a, v: a >= v,
}


class Cmp(Expr):
    """Leaf comparison ``col(field) <op> value`` (DESIGN.md §16)."""

    def __init__(self, field: str, op: str, value):
        if op not in _OPS:
            raise RawArrayError(f"unknown predicate op {op!r}")
        self.field, self.op, self.value = field, op, value

    def __repr__(self):
        sym = dict(eq="==", ne="!=", lt="<", le="<=", gt=">", ge=">=")[self.op]
        return f"(col({self.field!r}) {sym} {self.value!r})"

    def fields(self) -> Set[str]:
        return {self.field}

    def mask(self, batch):
        a = batch[self.field]
        m = _OPS[self.op](a, self.value)
        if m.ndim > 1:
            m = m.all(axis=tuple(range(1, m.ndim)))
        return np.asarray(m, dtype=bool)

    def row_verdicts(self, nrows, field_info):
        st, rnb = field_info[self.field]
        if rnb <= 0:
            # zero-width rows: the all-elements quantifier is vacuously true
            return np.ones(nrows, dtype=bool), np.zeros(nrows, dtype=bool)
        iv = _row_intervals(st, nrows, rnb)
        if iv is None:
            z = np.zeros(nrows, dtype=bool)
            return z, z.copy()
        mn, mx, has_nan, has_num = iv
        v_dn, v_up, exact = _round2(self.value)
        op = self.op
        if op == "eq":
            dt_num = (mn == v_dn) & (mx == v_dn) if exact \
                else np.zeros(nrows, dtype=bool)
            df_num = (mx < v_dn) | (mn > v_up)
        elif op == "ne":
            dt_num = (mx < v_dn) | (mn > v_up)
            df_num = (mn == v_dn) & (mx == v_dn) if exact \
                else np.zeros(nrows, dtype=bool)
        elif op == "lt":
            dt_num, df_num = mx < v_dn, mn >= v_up
        elif op == "le":
            dt_num, df_num = mx <= v_dn, mn > v_up
        elif op == "gt":
            dt_num, df_num = mn > v_up, mx <= v_dn
        else:  # ge
            dt_num, df_num = mn >= v_up, mx < v_dn
        nan_true = op == "ne"  # IEEE-754: NaN fails everything but !=
        dt = (~has_num | dt_num) & (True if nan_true else ~has_nan)
        df = (~has_num | df_num) & (~has_nan if nan_true else True)
        return dt, df


class IsNan(Expr):
    """Leaf ``col(field).isnan()`` — row-true iff every element is NaN."""

    def __init__(self, field: str):
        self.field = field

    def __repr__(self):
        return f"col({self.field!r}).isnan()"

    def fields(self) -> Set[str]:
        return {self.field}

    def mask(self, batch):
        a = batch[self.field]
        m = np.isnan(a) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
        if m.ndim > 1:
            m = m.all(axis=tuple(range(1, m.ndim)))
        return np.asarray(m, dtype=bool)

    def row_verdicts(self, nrows, field_info):
        st, rnb = field_info[self.field]
        if rnb <= 0:
            return np.ones(nrows, dtype=bool), np.zeros(nrows, dtype=bool)
        iv = _row_intervals(st, nrows, rnb)
        if iv is None:
            z = np.zeros(nrows, dtype=bool)
            return z, z.copy()
        _, _, has_nan, has_num = iv
        return ~has_num, ~has_nan


class And(Expr):
    """Conjunction of two row predicates."""

    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def __repr__(self):
        return f"({self.a!r} & {self.b!r})"

    def fields(self):
        return self.a.fields() | self.b.fields()

    def mask(self, batch):
        return self.a.mask(batch) & self.b.mask(batch)

    def row_verdicts(self, nrows, field_info):
        dta, dfa = self.a.row_verdicts(nrows, field_info)
        dtb, dfb = self.b.row_verdicts(nrows, field_info)
        return dta & dtb, dfa | dfb


class Or(Expr):
    """Disjunction of two row predicates."""

    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def __repr__(self):
        return f"({self.a!r} | {self.b!r})"

    def fields(self):
        return self.a.fields() | self.b.fields()

    def mask(self, batch):
        return self.a.mask(batch) | self.b.mask(batch)

    def row_verdicts(self, nrows, field_info):
        dta, dfa = self.a.row_verdicts(nrows, field_info)
        dtb, dfb = self.b.row_verdicts(nrows, field_info)
        return dta | dtb, dfa & dfb


class Not(Expr):
    """Negation of a row predicate (swaps the two verdict sides)."""

    def __init__(self, a: Expr):
        self.a = a

    def __repr__(self):
        return f"~{self.a!r}"

    def fields(self):
        return self.a.fields()

    def mask(self, batch):
        return ~self.a.mask(batch)

    def row_verdicts(self, nrows, field_info):
        dt, df = self.a.row_verdicts(nrows, field_info)
        return df, dt


class Col:
    """Named-field handle; comparison operators build :class:`Cmp` leaves."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"col({self.name!r})"

    def __eq__(self, other):  # type: ignore[override]
        return Cmp(self.name, "eq", other)

    def __ne__(self, other):  # type: ignore[override]
        return Cmp(self.name, "ne", other)

    def __lt__(self, other):
        return Cmp(self.name, "lt", other)

    def __le__(self, other):
        return Cmp(self.name, "le", other)

    def __gt__(self, other):
        return Cmp(self.name, "gt", other)

    def __ge__(self, other):
        return Cmp(self.name, "ge", other)

    def isnan(self) -> Expr:
        return IsNan(self.name)

    __hash__ = None  # == builds an Expr, so Col must not be hashable


def col(name: str) -> Col:
    """Start a predicate leaf: ``col("label") == 3`` (DESIGN.md §16)."""
    return Col(name)

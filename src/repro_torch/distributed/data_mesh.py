"""Multi-host data mesh: shard-aware distributed ingest with elastic
ownership (DESIGN.md §15).

The per-host data plane (engine waves, remote ranged reads, device feed)
never knew about the process mesh: every host took a contiguous
``host_range`` row block and permuted it privately, so (a) the last host
ran a different step count, (b) rows never mixed across hosts, and (c)
every host still had to be *able* to read every shard. This module makes
the shard — the unit the paper's byte layout already hands us — the unit
of distribution:

* **Shard ownership** — a deterministic assignment of manifest shards to
  hosts via consistent hashing (the fleet's ``HashRing``, DESIGN.md §14):
  ``owner(s) = HashRing(members).lookup("shard:<s>#e<epoch>")``. Pure
  function of ``(members, epoch)``, identical on every host, and a
  membership change moves only ~1/N of the shards. The epoch salt
  re-deals shards every epoch so rows DO mix across hosts between epochs
  (knob ``RA_MESH_EPOCH_REOWN``); within an epoch a host opens and
  fetches only the shard bytes it owns.
* **Deterministic global shuffle** — a pure function of ``(seed, epoch)``
  evaluated identically everywhere but materialized only for owned rows:
  a global permutation of *shard order* plus an independent permutation
  *within* each shard. No host reads a byte it does not own, yet the
  composition of every global batch changes each epoch.
* **Elastic epochs** — ``EpochPlan`` is pure over a *segment history*
  ``[(start_step, members), ...]``: a host joining or leaving mid-epoch
  appends a segment, every host re-derives the per-shard consumed counts
  by replaying the closed segments (pure arithmetic — no coordination
  traffic), and the remaining rows re-partition under the new ownership
  with no row duplicated or dropped and no epoch restart. The history
  rides in the extended ``LoaderState``, so elastic epochs are resumable.
* **Lockstep steps** — steps per epoch is the GLOBAL MINIMUM over hosts,
  so a collective never hangs on another host's tail batch; the dropped
  tail is an explicit counter, not a silent divergence.

``DataLoader(mesh=DataMesh(...))`` is the entry point (``repro_torch.data``);
``DeviceLoader`` assembles the per-host local batches into global
``DTensor``s (``Shard(0)`` over a 1-D ``DeviceMesh`` of the process group,
one process per card) via ``DTensor.from_local``, the counterpart of the
JAX package's ``jax.make_array_from_single_device_arrays``.
``aggregate_stats`` folds the per-host loader counters into one
straggler summary; ``racat owners`` prints the ownership table for any
manifest without reading a payload byte.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.spec import RawArrayError, env_int, env_str
from ..fleet.router import HashRing

# rng stream salts: shard-order vs within-shard permutations must never
# collide for the same (seed, epoch)
_SHARD_STREAM = 0x5A
_ROW_STREAM = 0xB0


def default_mesh_vnodes() -> int:
    """Virtual nodes per host on the ownership ring (``RA_MESH_VNODES``,
    default 64 — same default as the fleet router's ring)."""
    return max(1, env_int("RA_MESH_VNODES", 64))


def epoch_reown() -> bool:
    """Whether ownership is re-dealt every epoch (``RA_MESH_EPOCH_REOWN``,
    default 1). With 0 a shard stays pinned to one host across epochs —
    cheaper fd/cache churn, but rows never migrate between hosts."""
    return env_int("RA_MESH_EPOCH_REOWN", 1) != 0


def shard_owners(
    nshards: int,
    members: Sequence[str],
    epoch: int = 0,
    *,
    vnodes: Optional[int] = None,
) -> List[str]:
    """Deterministic shard → host assignment: one consistent-hash ring
    over ``members`` (BLAKE2b — identical in every process), looked up
    per shard. A membership change moves only ~1/len(members) of the
    shards; the epoch salt re-deals the assignment each epoch (see
    ``epoch_reown``)."""
    if not members:
        raise RawArrayError("shard ownership needs at least one host")
    ring = HashRing(members, vnodes=default_mesh_vnodes() if vnodes is None else vnodes)
    salt = f"#e{int(epoch)}" if epoch_reown() else ""
    return [ring.lookup(f"shard:{i}{salt}") for i in range(nshards)]


def shard_perm(seed: int, epoch: int, nshards: int, shuffle: bool = True) -> np.ndarray:
    """Global permutation of shard order — the coarse half of the global
    shuffle. Pure function of ``(seed, epoch)``."""
    if not shuffle:
        return np.arange(nshards, dtype=np.int64)
    rng = np.random.default_rng((seed, epoch, _SHARD_STREAM))
    return rng.permutation(nshards).astype(np.int64)


def within_perm(seed: int, epoch: int, shard: int, rows: int, shuffle: bool = True) -> np.ndarray:
    """Permutation of one shard's local rows — the fine half of the global
    shuffle. Pure function of ``(seed, epoch, shard)``, so any host (owner
    or not) derives the same order without reading the shard."""
    if not shuffle:
        return np.arange(rows, dtype=np.int64)
    rng = np.random.default_rng((seed, epoch, _ROW_STREAM, shard))
    return rng.permutation(rows).astype(np.int64)


Segment = Tuple[int, Tuple[str, ...]]


def _normalize_segments(segments) -> List[Segment]:
    out: List[Segment] = []
    for step, members in segments:
        members = tuple(str(m) for m in members)
        if not members:
            raise RawArrayError("mesh segment with empty membership")
        if out and int(step) < out[-1][0]:
            raise RawArrayError(
                f"mesh segments must be step-monotone: {int(step)} after {out[-1][0]}"
            )
        if out and int(step) == out[-1][0]:
            out[-1] = (int(step), members)  # same-boundary replace
        else:
            out.append((int(step), members))
    if not out:
        raise RawArrayError("mesh needs at least one segment")
    if out[0][0] != 0:
        raise RawArrayError(f"first mesh segment must start at step 0, got {out[0][0]}")
    return out


class EpochPlan:
    """The global schedule of one epoch — a pure function of
    ``(shard_rows, seed, epoch, segments, batch_size)``; every host
    evaluates the identical plan and materializes only its own rows.

    Within a segment, host ``h``'s stream is the concatenation, in global
    shard-permutation order, of the *not yet consumed* slice of
    ``within_perm`` for every shard it owns; it consumes ``batch_size``
    rows per step. Steps per segment is the minimum over members (lockstep
    collectives never outrun the smallest owner). Closed segments replay
    into per-shard consumed counts — which is pure length arithmetic, so
    a joining host reconstructs the epoch's exact position from
    ``(seed, epoch, segment history)`` alone.
    """

    def __init__(
        self,
        shard_rows: Sequence[int],
        *,
        seed: int,
        epoch: int,
        segments: Sequence[Tuple[int, Sequence[str]]],
        batch_size: int,
        shuffle: bool = True,
        vnodes: Optional[int] = None,
    ):
        if batch_size < 1:
            raise RawArrayError(f"batch_size must be >= 1, got {batch_size}")
        self.shard_rows = tuple(int(r) for r in shard_rows)
        self.seed, self.epoch = int(seed), int(epoch)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.vnodes = vnodes
        self.segments = _normalize_segments(segments)
        self.total_rows = int(sum(self.shard_rows))
        self._row_offset = np.concatenate(
            [[0], np.cumsum(self.shard_rows)]
        ).astype(np.int64)
        self._perm = shard_perm(self.seed, self.epoch, len(self.shard_rows), shuffle)
        self._wperm: Dict[int, np.ndarray] = {}  # shard -> within_perm memo
        self._build()

    # -- schedule construction -------------------------------------------

    def _build(self) -> None:
        B = self.batch_size
        consumed = np.zeros(len(self.shard_rows), dtype=np.int64)
        # per segment: (t0, steps, members, runs_by_host); a run is
        # (shard, lo, hi) into within_perm(shard) in shard-perm order
        self._seg: List[Tuple[int, int, Tuple[str, ...], Dict[str, List[Tuple[int, int, int]]]]] = []
        for k, (t0, members) in enumerate(self.segments):
            owners = shard_owners(
                len(self.shard_rows), members, self.epoch, vnodes=self.vnodes
            )
            runs: Dict[str, List[Tuple[int, int, int]]] = {m: [] for m in members}
            for s in self._perm:
                s = int(s)
                lo, hi = int(consumed[s]), self.shard_rows[s]
                if lo < hi:
                    runs[owners[s]].append((s, lo, hi))
            avail = {
                m: sum(hi - lo for _, lo, hi in rs) for m, rs in runs.items()
            }
            if k + 1 < len(self.segments):
                steps = self.segments[k + 1][0] - t0
                short = [m for m in members if avail[m] < steps * B]
                if short:
                    raise RawArrayError(
                        f"mesh segment at step {t0} runs {steps} steps but "
                        f"host(s) {short} own fewer than {steps * B} rows"
                    )
            else:
                steps = min(avail[m] // B for m in members) if members else 0
            # replay this segment's consumption into the per-shard counts
            for m in members:
                need = steps * B
                for s, lo, hi in runs[m]:
                    if need <= 0:
                        break
                    take = min(hi - lo, need)
                    consumed[s] += take
                    need -= take
            self._seg.append((t0, steps, tuple(members), runs))
        self._consumed_end = consumed

    # -- queries ----------------------------------------------------------

    def steps(self) -> int:
        """Total steps this epoch delivers (identical on every host)."""
        t0, steps, _, _ = self._seg[-1]
        return t0 + steps

    def members_at(self, step: int) -> Tuple[str, ...]:
        members = self._seg[0][2]
        for t0, _, m, _ in self._seg:
            if step >= t0:
                members = m
        return members

    def dropped_rows(self) -> int:
        """Rows this epoch never delivers (the lockstep tail): global, and
        by construction the same number on every host."""
        return self.total_rows - int(self._consumed_end.sum())

    def owned_shards(self, host: str) -> List[int]:
        """Every shard ``host`` owns in ANY segment of this epoch — the
        superset of shards it may legitimately open or fetch."""
        owned = set()
        for _, _, members, runs in self._seg:
            for s, _, _ in runs.get(host, ()):
                owned.add(s)
        return sorted(owned)

    def _within(self, s: int) -> np.ndarray:
        w = self._wperm.get(s)
        if w is None:
            w = within_perm(self.seed, self.epoch, s, self.shard_rows[s], self.shuffle)
            self._wperm[s] = w
        return w

    def host_stream(self, host: str, segment: int = -1) -> np.ndarray:
        """Every global row id ``host`` could deliver in one segment
        (default: the final one), unbounded by the step count — union over
        hosts of a segment's streams is exactly the epoch's undelivered
        rows at that segment's start."""
        _, _, _, runs = self._seg[segment]
        parts = [
            self._row_offset[s] + self._within(s)[lo:hi]
            for s, lo, hi in runs.get(host, ())
        ]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def host_order(self, host: str) -> np.ndarray:
        """Global row ids ``host`` delivers this epoch, as one array of
        length ``steps() * batch_size`` indexed by step — position
        ``[t*B:(t+1)*B]`` is batch ``t``. Steps where ``host`` was not a
        member are filled with -1 (a loader positioned there raises)."""
        B = self.batch_size
        order = np.full(self.steps() * B, -1, dtype=np.int64)
        for t0, steps, members, _ in self._seg:
            if host not in members or steps == 0:
                continue
            need = steps * B
            seg_rows = self.host_stream(host, self._seg_index(t0))[:need]
            order[t0 * B : t0 * B + len(seg_rows)] = seg_rows
        return order

    def _seg_index(self, t0: int) -> int:
        for i, (t, _, _, _) in enumerate(self._seg):
            if t == t0:
                return i
        raise RawArrayError(f"no mesh segment starts at step {t0}")


class DataMesh:
    """One host's view of the data mesh: its identity, the ordered member
    list, and the per-epoch segment history that records membership
    changes. Construction is cheap; all scheduling is in ``EpochPlan``.

    ``DataMesh.from_env()`` builds one from ``RA_MESH_HOSTS`` (comma-
    separated member names) + ``RA_MESH_HOST`` (this host) — the CLI /
    multi-process entry point.
    """

    def __init__(self, host: str, hosts: Sequence[str], *, vnodes: Optional[int] = None):
        members = tuple(str(h) for h in hosts)
        if len(set(members)) != len(members):
            raise RawArrayError(f"duplicate mesh host names: {members}")
        if str(host) not in members:
            raise RawArrayError(f"host {host!r} not in mesh members {members}")
        self.host = str(host)
        self.vnodes = vnodes
        self._members = members
        self._segments: Dict[int, List[Segment]] = {}

    @classmethod
    def from_env(cls) -> Optional["DataMesh"]:
        hosts = env_str("RA_MESH_HOSTS")
        host = env_str("RA_MESH_HOST")
        names = [h.strip() for h in hosts.split(",") if h.strip()]
        if not names or not host:
            return None
        return cls(host, names)

    # -- membership --------------------------------------------------------

    @property
    def hosts(self) -> Tuple[str, ...]:
        """Current membership (the last recorded segment's)."""
        return self._members

    @property
    def host_count(self) -> int:
        return len(self._members)

    @property
    def host_index(self) -> int:
        """Position of this host in the current membership — the data-axis
        block it feeds when batches assemble into global arrays. -1 once the
        host has left the membership (its loader then only drains stats)."""
        try:
            return self._members.index(self.host)
        except ValueError:
            return -1

    def segments_for(self, epoch: int) -> List[Segment]:
        """Segment history of ``epoch``; an epoch with no recorded change
        is one segment of the current membership from step 0."""
        segs = self._segments.get(int(epoch))
        return list(segs) if segs else [(0, self._members)]

    def repartition(self, hosts: Sequence[str], *, epoch: int, step: int) -> None:
        """Record a membership change effective at ``(epoch, step)``. Every
        surviving host must record the identical change at the identical
        step (it is part of the deterministic schedule); a joining host
        records the history it was handed and seeks to ``step``."""
        members = tuple(str(h) for h in hosts)
        if len(set(members)) != len(members):
            raise RawArrayError(f"duplicate mesh host names: {members}")
        segs = self.segments_for(int(epoch))
        segs = _normalize_segments(segs + [(int(step), members)])
        self._segments = {int(epoch): segs}  # older epochs are closed history
        self._members = members

    def load_segments(self, epoch: int, segments) -> None:
        """Restore the segment history of ``epoch`` (from an extended
        ``LoaderState``); membership becomes the last segment's."""
        segs = _normalize_segments(segments)
        self._segments = {int(epoch): segs}
        self._members = segs[-1][1]

    # -- scheduling --------------------------------------------------------

    def plan(
        self,
        shard_rows: Sequence[int],
        *,
        seed: int,
        epoch: int,
        batch_size: int,
        shuffle: bool = True,
    ) -> EpochPlan:
        return EpochPlan(
            shard_rows,
            seed=seed,
            epoch=epoch,
            segments=self.segments_for(epoch),
            batch_size=batch_size,
            shuffle=shuffle,
            vnodes=self.vnodes,
        )


# -------------------------------------------------------------------------
# global assembly (torch deferred: the mesh schedule itself is numpy)
# -------------------------------------------------------------------------


def world_size() -> int:
    """Processes in the default process group (1 before there is one, as
    ``jax.process_count()`` is 1 without ``jax.distributed``)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def data_sharding(axis_name: str = "data", *, device: Any = None):
    """``(DeviceMesh, (Shard(0),))`` splitting axis 0 over EVERY process of
    the default group (a 1-D ``(data,)`` mesh, one process per device).
    With one process per mesh host, host ``h``'s device holds global rows
    ``[h*local_B, (h+1)*local_B)`` — exactly the block its loader
    materializes. ``device`` picks the mesh's device type (default: the
    current CUDA device, raising without one; ``"cpu"`` on a host).

    With no process group yet, this starts a one-rank group over an
    in-memory ``HashStore`` (NCCL for CUDA, gloo for the CPU): that is
    process-global state, as jax's backend is, and a caller that wants it
    gone calls ``torch.distributed.destroy_process_group()``. A group of
    several processes is the launcher's to start first (torchrun's
    ``env://`` and ``init_process_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from ..data.device_loader import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
        )
    mesh = init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))
    return mesh, (Shard(0),)


def mesh_device(mesh):
    """This process's device on ``mesh`` (one process drives one device)."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def global_block(local, host_count: int, sharding):
    """Declare ``local`` (this process's rows, on its device) as its shard
    of the ``(host_count * local_B, ...)`` global ``DTensor``. Metadata
    only: ``run_check=False`` keeps the shape check's collective off the
    caller's thread (the device feeder runs no collective)."""
    import torch
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding
    if mesh.size() != host_count:
        raise RawArrayError(
            f"global batch over {host_count} mesh hosts needs a mesh of "
            f"{host_count} devices, got {mesh.size()}"
        )
    gshape = (int(local.shape[0]) * host_count,) + tuple(local.shape[1:])
    stride = torch.empty(gshape, device="meta").stride()  # contiguous
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=gshape, stride=stride
    )


def make_global_batch(
    local_fields: Dict[str, Any],
    host_count: int,
    *,
    sharding=None,
    local_devices=None,
    detach: bool = False,
):
    """Assemble this host's local batch (numpy arrays or tensors) into
    global ``DTensor``s: each field's rows go to this process's device and
    are declared its ``Shard(0)`` block of a ``(host_count * local_B,
    ...)`` global tensor. One process drives one device, so
    ``local_devices`` (default: the mesh's device for this process) holds
    one device.

    Requires one process per mesh host (``world_size() == host_count``);
    ``detach=True`` copies rows out of a reused staging ring before the
    transfer."""
    import torch

    if sharding is None:
        sharding = data_sharding()
    if local_devices is None:
        local_devices = [mesh_device(sharding[0])]
    nd = len(local_devices)
    out: Dict[str, Any] = {}
    for name, v in local_fields.items():
        n = int(v.shape[0])
        if n % nd:
            raise RawArrayError(
                f"{name}: local batch of {n} rows does not split over "
                f"{nd} local devices"
            )
        if nd != 1:
            raise RawArrayError(
                f"{name}: one process drives one device, got {nd} local devices"
            )
        if isinstance(v, torch.Tensor):
            local = v.clone() if detach else v
        else:
            copy = detach or not v.flags.writeable
            local = torch.from_numpy(np.array(v, copy=True) if copy else v)
        out[name] = global_block(local.to(local_devices[0]), host_count, sharding)
    return out


# -------------------------------------------------------------------------
# observability: ownership table + cross-host stats aggregation
# -------------------------------------------------------------------------


def _manifest_shards(root: str) -> Tuple[List[int], List[int]]:
    """``(rows, bytes)`` per shard of a dataset root / ``manifest.json`` /
    sharded-store dir — manifest only, ZERO payload (or header) reads.
    Bytes are stored row bytes (uint8 for quantized fields)."""
    path = root
    if os.path.isdir(root):
        for name in ("manifest.json", "index.json"):
            cand = os.path.join(root, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise RawArrayError(f"{root}: no manifest.json or index.json")
    with open(path) as f:
        man = json.load(f)
    if man.get("format") == "rawarray-dataset-v1":
        row_nbytes = 0
        for info in man["fields"].values():
            dt = np.dtype("uint8") if info.get("quant") else np.dtype(info["dtype"])
            row_nbytes += dt.itemsize * int(np.prod(info["shape"], dtype=np.int64))
        rows = [int(s["rows"]) for s in man["shards"]]
        return rows, [r * row_nbytes for r in rows]
    if man.get("format") == "rawarray-sharded-v1":
        offs = man["offsets"]
        rows = [int(b) - int(a) for a, b in zip(offs, offs[1:])]
        # index stores the logical shape; rows run along man["axis"]
        shape = [int(d) for d in man["shape"]]
        per_row = int(np.prod(shape, dtype=np.int64)) // max(1, shape[int(man.get("axis", 0))])
        row_nbytes = np.dtype(man["dtype"]).itemsize * per_row
        return rows, [r * row_nbytes for r in rows]
    raise RawArrayError(f"{path}: not a dataset manifest or sharded index")


def owners_table(
    root: str,
    hosts: Sequence[str],
    *,
    epoch: int = 0,
    vnodes: Optional[int] = None,
) -> Dict[str, Any]:
    """Shard → host assignment for a manifest: per-shard
    ``(shard, rows, bytes, owner)`` rows plus per-host totals and the
    byte imbalance ratio (max host bytes / mean host bytes). Reads only
    the manifest — never a payload byte."""
    rows, nbytes = _manifest_shards(root)
    owners = shard_owners(len(rows), hosts, epoch, vnodes=vnodes)
    shards = [
        {"shard": i, "rows": rows[i], "bytes": nbytes[i], "owner": owners[i]}
        for i in range(len(rows))
    ]
    per_host = {
        h: {"shards": 0, "rows": 0, "bytes": 0} for h in (str(h) for h in hosts)
    }
    for s in shards:
        t = per_host[s["owner"]]
        t["shards"] += 1
        t["rows"] += s["rows"]
        t["bytes"] += s["bytes"]
    byte_totals = [t["bytes"] for t in per_host.values()]
    mean = sum(byte_totals) / max(1, len(byte_totals))
    imbalance = (max(byte_totals) / mean) if mean else 1.0
    return {
        "epoch": int(epoch),
        "hosts": [str(h) for h in hosts],
        "shards": shards,
        "per_host": per_host,
        "total_rows": sum(rows),
        "total_bytes": sum(nbytes),
        "imbalance": imbalance,
    }


def aggregate_stats(per_host: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Fold per-host ``DataLoader`` / ``DeviceLoader`` ``stats()`` dicts
    (each tagged with ``host_id``) into one fleet view: counters sum,
    every ``*_s`` timing also reports ``_max`` / ``_mean`` plus the
    straggler summary — ``straggler_host`` is the host with the largest
    produce time and ``produce_skew`` its ratio over the mean (the same
    slow-host signal the fleet's ``/metrics`` counters expose per
    replica)."""
    per_host = [dict(d) for d in per_host]
    if not per_host:
        return {"hosts": 0.0}
    out: Dict[str, float] = {"hosts": float(len(per_host))}
    keys = sorted({k for d in per_host for k in d if k != "host_id"})
    for k in keys:
        vals = [float(d[k]) for d in per_host if k in d]
        out[k] = float(sum(vals))
        if k.endswith("_s"):
            out[f"{k}_max"] = float(max(vals))
            out[f"{k}_mean"] = float(sum(vals) / len(vals))
    produce = [float(d.get("loader_produce_s", 0.0)) for d in per_host]
    worst = int(np.argmax(produce))
    out["straggler_host"] = float(per_host[worst].get("host_id", worst))
    mean = sum(produce) / len(produce)
    out["produce_skew"] = float(produce[worst] / mean) if mean else 1.0
    # lockstep sanity: dropped tails are global, so they must agree
    tails = {float(d["dropped_tail_rows"]) for d in per_host if "dropped_tail_rows" in d}
    if len(tails) == 1:
        out["dropped_tail_rows"] = tails.pop()
    return out

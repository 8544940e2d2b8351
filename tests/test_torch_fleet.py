"""The port's serving fleet, held to the JAX package's tests: a mirror of
``tests/test_fleet.py`` with the targets in ``repro_torch``.

Serving fleet (DESIGN.md §14): consistent-hash ring math, the
router/proxy, the edge read-through tiers, single-flight coalescing,
failover, ETag invalidation, and the loadgen trace builders.

Every networked test runs a real in-process fleet — origin + edge
replicas + router on ephemeral loopback ports, actual sockets."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import repro_torch.core as ra
from repro_torch import fleet, remote
from repro_torch.data.dataset import RaDataset, RaDatasetWriter
from repro_torch.fleet.edge import SingleFlight, SpillCache
from repro_torch.fleet.loadgen import (
    build_trace,
    percentile,
    trace_coldstart,
    trace_gather,
    trace_rows,
)
from repro_torch.fleet.router import HashRing, route_key


# ------------------------------------------------------------- ring math
def test_ring_deterministic_and_balanced():
    nodes = [f"http://127.0.0.1:{9000 + i}" for i in range(3)]
    r1 = HashRing(nodes, vnodes=64)
    r2 = HashRing(list(reversed(nodes)), vnodes=64)
    keys = [f"/shard{i}.ra#{j}" for i in range(40) for j in range(50)]
    owners = {}
    for k in keys:
        o = r1.lookup(k)
        # deterministic across instances and insertion orders
        assert o == r2.lookup(k)
        assert o == r1.preference(k)[0]
        owners[o] = owners.get(o, 0) + 1
    assert set(owners) == set(nodes)
    for n, cnt in owners.items():
        assert cnt > len(keys) * 0.15, f"{n} owns only {cnt}/{len(keys)} keys"


def test_ring_minimal_disruption_on_removal():
    nodes = [f"n{i}" for i in range(4)]
    ring = HashRing(nodes, vnodes=64)
    keys = [f"k{i}" for i in range(1000)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("n2")
    moved = sum(1 for k in keys
                if before[k] != "n2" and ring.lookup(k) != before[k])
    # keys not owned by the removed node must not move at all
    assert moved == 0
    # and the removed node's keys redistribute across the survivors
    heirs = {ring.lookup(k) for k in keys if before[k] == "n2"}
    assert heirs <= {"n0", "n1", "n3"} and len(heirs) > 1


def test_ring_preference_distinct_and_empty():
    ring = HashRing([], vnodes=8)
    assert ring.lookup("x") is None and ring.preference("x") == []
    for n in ("a", "b", "c"):
        ring.add(n)
    pref = ring.preference("some-key")
    assert sorted(pref) == ["a", "b", "c"]
    assert ring.preference("some-key", limit=2) == pref[:2]


def test_route_key_colocates_metadata_with_bytes():
    assert route_key("/a.ra", 0, 1 << 20) == route_key("/header/a.ra", 0, 1 << 20)
    assert route_key("/a.ra", 0, 1 << 20) == route_key("/stat/a.ra", 0, 1 << 20)
    # different blocks of one path spread across the ring
    assert route_key("/a.ra", 0, 1 << 20) != route_key("/a.ra", 1 << 20, 1 << 20)


# ------------------------------------------------------ fleet end-to-end
@pytest.fixture()
def fleet3(tmp_path):
    """(root, Fleet) with 3 edges over a local origin; revalidates every
    request so overwrite tests see changes immediately."""
    fl = fleet.serve(str(tmp_path), replicas=3, revalidate_s=0.0)
    try:
        yield str(tmp_path), fl
    finally:
        fl.shutdown()
        remote.close_readers()
        remote.reset_shared_cache()
        remote.reset_breakers()


def _metrics(url):
    with urllib.request.urlopen(url + "/metrics") as resp:
        return json.load(resp)


def test_byte_identity_through_router(fleet3):
    root, fl = fleet3
    rng = np.random.default_rng(0)
    plain = rng.normal(size=(200, 33)).astype(np.float64)
    ra.write(os.path.join(root, "plain.ra"), plain)
    chunked = rng.integers(0, 255, size=500_000, dtype=np.uint8)
    ra.write(os.path.join(root, "chunked.ra"), chunked, chunked=True)

    got_p = ra.read(f"{fl.url}/plain.ra")
    got_c = ra.read(f"{fl.url}/chunked.ra")
    assert got_p.dtype == plain.dtype and np.array_equal(got_p, plain)
    assert got_c.dtype == chunked.dtype and np.array_equal(got_c, chunked)
    # metadata views route through to the origin
    assert tuple(remote.remote_header_of(f"{fl.url}/plain.ra").shape) == plain.shape
    listing = remote.stat_dir(fl.url + "/")
    assert {"plain.ra", "chunked.ra"} <= set(listing)


def test_dataset_gather_through_router(fleet3):
    root, fl = fleet3
    rng = np.random.default_rng(6)
    w = RaDatasetWriter(os.path.join(root, "ds"),
                        {"tok": ((8,), "uint32"), "y": ((), "float32")},
                        shard_rows=64)
    w.append(tok=rng.integers(0, 1000, size=(200, 8)).astype(np.uint32),
             y=rng.normal(size=200).astype(np.float32))
    w.finish()
    local = RaDataset(os.path.join(root, "ds"))
    prox = RaDataset(f"{fl.url}/ds")
    try:
        idx = np.random.default_rng(7).permutation(local.total_rows)[:64]
        gl, gp = local.gather(idx), prox.gather(idx)
        for f in ("tok", "y"):
            assert np.array_equal(gp[f], gl[f])
    finally:
        prox.close()
        local.close()


def test_healthz_and_metrics_endpoints(fleet3):
    root, fl = fleet3
    ra.write(os.path.join(root, "a.ra"), np.arange(1000, dtype=np.float32))
    ra.read(f"{fl.url}/a.ra")

    with urllib.request.urlopen(fl.url + "/healthz") as resp:
        h = json.load(resp)
    assert h["ok"] and h["role"] == "router" and h["replicas"] == 3

    rm = _metrics(fl.url)
    assert rm["role"] == "router" and rm["requests"] > 0
    assert set(rm["replicas"]) == {e.url for e in fl.edges}

    served = 0
    for e in fl.edges:
        em = _metrics(e.url)
        assert em["role"] == "edge" and em["origin"] == fl.origin.url
        assert em["ram"]["hits"] + em["ram"]["misses"] >= em["origin_fetches"]
        served += em["origin_fetches"]
    assert served > 0

    om = _metrics(fl.origin.url)
    assert om["role"] == "origin" and om["bytes_out"] > 0


def test_single_flight_coalesces_a_herd(tmp_path):
    ra.write(os.path.join(str(tmp_path), "hot.ra"),
             np.arange(500_000, dtype=np.float32))
    # a slow origin makes the race window real: the herd arrives while the
    # leader's fetch is still in flight
    fl = fleet.serve(str(tmp_path), replicas=3, delay_s=0.05,
                     revalidate_s=30.0)
    try:
        block = fl.edges[0].block_bytes
        rep = fleet.run_load(fl.url, [("/hot.ra", 0, block)] * 40, clients=40)
        assert rep["errors"] == 0
        fetches = sum(e._fetches_by_path.get("/hot.ra", 0) for e in fl.edges)
        assert fetches == 1, f"herd cost {fetches} origin fetches, wanted 1"
        assert sum(e.flights.coalesced_waits for e in fl.edges) > 0
    finally:
        fl.shutdown()
        remote.close_readers()
        remote.reset_shared_cache()
        remote.reset_breakers()


def test_single_flight_unit_exactly_one_call():
    sf = SingleFlight()
    calls = []
    gate = threading.Event()

    def work():
        calls.append(1)
        gate.wait(2.0)
        return b"payload"

    results = []
    threads = [threading.Thread(target=lambda: results.append(sf.do(("t", 0), work)))
               for _ in range(16)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # let every follower park on the flight
    gate.set()
    for t in threads:
        t.join(5.0)
    assert len(calls) == 1 and results == [b"payload"] * 16
    assert sf.coalesced_waits == 15 and sf.leaders == 1
    # errors propagate to every waiter, and the flight table drains
    with pytest.raises(RuntimeError):
        sf.do(("t", 1), lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert not sf._flights


def test_failover_on_replica_death(fleet3):
    root, fl = fleet3
    arr = np.arange(200_000, dtype=np.int32)
    ra.write(os.path.join(root, "f.ra"), arr)
    assert np.array_equal(ra.read(f"{fl.url}/f.ra"), arr)

    # kill the replica that OWNS the file's routing key, so the next read
    # must walk the preference list
    owner = fl.router.plan(route_key("/f.ra", 0, fl.router.hash_block))[0]
    victim = next(e for e in fl.edges if e.url == owner)
    victim.shutdown()
    victim.server_close()
    remote.close_readers()
    remote.reset_shared_cache()
    remote.reset_breakers()

    # every key still resolves: dead replica's keys walk to the next ring node
    assert np.array_equal(ra.read(f"{fl.url}/f.ra"), arr)
    rm = _metrics(fl.url)
    assert rm["failovers"] > 0 and rm["fallback_served"] > 0
    assert rm["replicas"][victim.url]["down"] is True


def test_membership_change_rebalances(fleet3):
    root, fl = fleet3
    arr = np.random.default_rng(1).normal(size=60_000).astype(np.float32)
    ra.write(os.path.join(root, "m.ra"), arr)
    assert np.array_equal(ra.read(f"{fl.url}/m.ra"), arr)

    added = fl.add_replica()
    assert added.url in fl.router.replica_urls()
    remote.close_readers()
    remote.reset_shared_cache()
    assert np.array_equal(ra.read(f"{fl.url}/m.ra"), arr)

    fl.remove_replica(added)
    assert added.url not in fl.router.replica_urls()
    remote.close_readers()
    remote.reset_shared_cache()
    assert np.array_equal(ra.read(f"{fl.url}/m.ra"), arr)


def test_etag_change_invalidates_edges(fleet3):
    root, fl = fleet3
    p = os.path.join(root, "v.ra")
    v1 = np.zeros(50_000, dtype=np.float32)
    ra.write(p, v1)
    assert np.array_equal(ra.read(f"{fl.url}/v.ra"), v1)

    time.sleep(0.01)  # mtime_ns tick so the ETag provably changes
    v2 = np.ones(50_000, dtype=np.float32)
    ra.write(p, v2)
    remote.close_readers()
    remote.reset_shared_cache()

    got = ra.read(f"{fl.url}/v.ra")
    assert np.array_equal(got, v2), "edge served stale blocks after overwrite"
    assert sum(e.invalidated_paths for e in fl.edges) >= 1
    assert sum(e.cache.stats()["invalidations"] for e in fl.edges) >= 1


def test_edge_serves_origin_etag_and_304(fleet3):
    root, fl = fleet3
    ra.write(os.path.join(root, "e.ra"), np.arange(10_000, dtype=np.uint16))
    req = urllib.request.Request(f"{fl.url}/e.ra", headers={"Range": "bytes=0-99"})
    with urllib.request.urlopen(req) as resp:
        etag = resp.headers["ETag"]
        assert resp.status == 206 and etag
    st = os.stat(os.path.join(root, "e.ra"))
    from repro_torch.remote.server import file_etag

    assert etag == file_etag(st)  # edge relays the ORIGIN's version
    req = urllib.request.Request(f"{fl.url}/e.ra",
                                 headers={"If-None-Match": etag})
    try:
        with urllib.request.urlopen(req) as resp:
            status = resp.status
    except urllib.error.HTTPError as exc:  # urllib treats 304 as an error
        status = exc.code
    assert status == 304


def test_edge_rejects_writes_but_router_forwards_put(tmp_path):
    fl = fleet.serve(str(tmp_path), replicas=2, upload_token="tok",
                     revalidate_s=0.0)
    try:
        arr = np.arange(5_000, dtype=np.float32)
        os.environ["RA_REMOTE_TOKEN"] = "tok"
        try:
            ra.write(f"{fl.url}/up.ra", arr)  # PUT through the router
        finally:
            os.environ.pop("RA_REMOTE_TOKEN", None)
        assert os.path.exists(os.path.join(str(tmp_path), "up.ra"))
        assert np.array_equal(ra.read(f"{fl.url}/up.ra"), arr)
        # direct PUT at an edge is refused: replicas are read-only
        req = urllib.request.Request(fl.edges[0].url + "/nope.ra",
                                     data=b"x", method="PUT")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 405
    finally:
        fl.shutdown()
        remote.close_readers()
        remote.reset_shared_cache()
        remote.reset_breakers()


# ------------------------------------------------------------- spill tier
def test_spill_cache_roundtrip_lru_and_invalidate(tmp_path):
    sp = SpillCache(str(tmp_path / "spill"), capacity_bytes=3 * 100)
    blob = bytes(100)
    sp.put("t@1", 0, blob)
    sp.put("t@1", 1, blob)
    sp.put("u@1", 0, blob)
    assert sp.get("t@1", 0) == blob
    assert sp.get("missing", 9) is None
    sp.put("u@1", 1, blob)  # over capacity: evicts the LRU entry (t@1,1)
    s = sp.stats()
    assert s["evictions"] == 1 and s["blocks"] == 3
    assert sp.get("t@1", 1) is None
    dropped = sp.invalidate("u@1")
    assert dropped == 2 and sp.get("u@1", 0) is None
    # only the surviving block's file remains on disk
    files = [f for f in os.listdir(tmp_path / "spill") if f.endswith(".blk")]
    assert len(files) == 1


def test_edge_promotes_from_disk_after_ram_flush(tmp_path):
    arr = np.arange(300_000, dtype=np.float32)
    ra.write(os.path.join(str(tmp_path), "d.ra"), arr)
    fl = fleet.serve(str(tmp_path), replicas=1, revalidate_s=30.0)
    try:
        assert np.array_equal(ra.read(f"{fl.url}/d.ra"), arr)
        edge = fl.edges[0]
        before = edge.origin_fetches
        assert before > 0 and edge.spill is not None
        # drop the RAM tier; the spill tier must refill it without origin I/O
        edge.cache.clear()
        remote.close_readers()
        remote.reset_shared_cache()
        assert np.array_equal(ra.read(f"{fl.url}/d.ra"), arr)
        assert edge.origin_fetches == before
        assert edge.spill.stats()["hits"] > 0
    finally:
        fl.shutdown()
        remote.close_readers()
        remote.reset_shared_cache()
        remote.reset_breakers()


# ----------------------------------------------------------------- loadgen
def test_trace_builders_shapes_and_bounds():
    files = [("/a.ra", 1_000_000), ("/b.ra", 300_000)]
    g = trace_gather(files, req_bytes=1 << 16, requests=50, seed=3)
    assert len(g) == 50
    sizes = dict(files)
    for path, off, ln in g:
        assert 0 <= off < sizes[path] and 0 < ln <= 1 << 16
        assert off + ln <= sizes[path]
    r = trace_rows(files, req_bytes=1 << 16, requests=20)
    assert len(r) == 20 and r[0][0] == "/a.ra" and r[1][0] == "/b.ra"
    c = trace_coldstart(files, req_bytes=1 << 17)
    assert sum(ln for _, _, ln in c) == sum(sizes.values())
    assert c[0][0] == "/a.ra"  # largest object first
    with pytest.raises(ra.RawArrayError):
        build_trace("nope", files, req_bytes=1, requests=1)


def test_percentile_nearest_rank():
    assert percentile([], 0.99) == 0.0
    vals = sorted(float(i) for i in range(100))
    assert percentile(vals, 0.50) == 50.0
    assert percentile(vals, 0.99) == 99.0


def test_loadgen_against_live_fleet(fleet3):
    root, fl = fleet3
    ra.write(os.path.join(root, "lg.ra"),
             np.arange(250_000, dtype=np.float32))
    files = fleet.files_from_stat(fl.url, suffix=".ra")
    assert ("/lg.ra", os.path.getsize(os.path.join(root, "lg.ra"))) in files
    trace = build_trace("gather", files, req_bytes=1 << 15, requests=48, seed=5)
    rep = fleet.run_load(fl.url, trace, clients=12)
    assert rep["errors"] == 0 and rep["requests"] == 48
    assert rep["bytes"] > 0 and rep["p99_ms"] >= rep["p50_ms"] >= 0

"""The port's remote data plane, held to the JAX package's tests: a mirror
of ``tests/test_remote.py`` with the targets in ``repro_torch``.

Remote data plane (DESIGN.md §9): byte-range server, parallel-range
client, block cache, and the URL-aware paths through sharded stores,
datasets, the loader, and checkpoint restore (the port's store takes and
returns tensors; numpy leaves are taken too).

Everything runs against a real in-process ``ThreadingHTTPServer`` on an
ephemeral loopback port — no fixtures, no mocks, the actual wire."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

import repro_torch.core as ra
from repro_torch import remote
from repro_torch.checkpoint import store
from repro_torch.data.dataset import RaDataset, RaDatasetWriter
from repro_torch.data.loader import DataLoader
from repro_torch.remote.cache import BlockCache


@pytest.fixture()
def served(tmp_path):
    """(root, base_url) with a live server; readers/caches reset after."""
    server = remote.serve(str(tmp_path), port=0)
    try:
        yield str(tmp_path), server.url
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()
        remote.reset_shared_cache()


def _write(root, name, arr, **kw):
    p = os.path.join(root, name)
    ra.write(p, arr, **kw)
    return p


# ------------------------------------------------------------------ server
def test_range_request_semantics(served):
    root, base = served
    arr = np.arange(4096, dtype=np.uint8)
    _write(root, "x.ra", arr)
    size = os.path.getsize(os.path.join(root, "x.ra"))

    req = urllib.request.Request(f"{base}/x.ra", headers={"Range": "bytes=64-127"})
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 206
        assert resp.headers["Content-Range"] == f"bytes 64-127/{size}"
        body = resp.read()
    assert body == open(os.path.join(root, "x.ra"), "rb").read()[64:128]

    # suffix range
    req = urllib.request.Request(f"{base}/x.ra", headers={"Range": "bytes=-16"})
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 206
        assert resp.read() == open(os.path.join(root, "x.ra"), "rb").read()[-16:]

    # whole entity advertises range support + ETag
    with urllib.request.urlopen(f"{base}/x.ra") as resp:
        assert resp.status == 200
        assert resp.headers["Accept-Ranges"] == "bytes"
        etag = resp.headers["ETag"]
        assert etag

    # If-None-Match revalidation
    req = urllib.request.Request(f"{base}/x.ra", headers={"If-None-Match": etag})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 304


def test_unsatisfiable_range_is_416(served):
    root, base = served
    _write(root, "x.ra", np.zeros(8, np.uint8))
    size = os.path.getsize(os.path.join(root, "x.ra"))
    req = urllib.request.Request(f"{base}/x.ra", headers={"Range": f"bytes={size + 10}-"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 416


def test_path_escape_and_missing_are_404(served):
    root, base = served
    for path in ("/nope.ra", "/../../etc/passwd", "/%2e%2e/%2e%2e/etc/passwd"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + path)
        assert ei.value.code == 404


def test_header_endpoint_json(served):
    root, base = served
    arr = np.zeros((5, 7, 2), np.int16)
    _write(root, "h.ra", arr)
    with urllib.request.urlopen(f"{base}/header/h.ra") as resp:
        d = json.loads(resp.read())
    assert d["shape"] == [5, 7, 2]
    assert d["eltype"] == ra.ELTYPE_INT
    assert d["elbyte"] == 2
    assert d["header_bytes"] == 48 + 8 * 3


# ------------------------------------------------------------------ client
def test_remote_read_matches_local(served):
    root, base = served
    arr = np.random.default_rng(0).normal(size=(513, 37)).astype(np.float32)
    p = _write(root, "x.ra", arr)
    got = ra.read(f"{base}/x.ra")
    assert got.dtype == arr.dtype and np.array_equal(got, ra.read(p))


def test_remote_header_of_fast_path_and_fallback(served):
    root, base = served
    arr = np.zeros((9, 4), np.complex64)
    p = _write(root, "c.ra", arr)
    assert ra.header_of(f"{base}/c.ra") == ra.header_of(p)
    # fallback path (ranged header read) must agree with the endpoint
    reader = remote.get_reader(f"{base}/c.ra")
    from repro_torch.core.header import decode_header

    assert decode_header(reader.read_range(0, min(reader.size, 4096))) == ra.header_of(p)


def test_remote_flagged_payloads_and_metadata(served):
    root, base = served
    arr = np.tile(np.arange(100, dtype=np.float64), 7)
    _write(root, "z.ra", arr, compress=True, crc32=True, metadata=b"tail")
    got, meta = ra.read(f"{base}/z.ra", with_metadata=True)
    assert np.array_equal(got, arr) and meta == b"tail"
    assert ra.read_metadata(f"{base}/z.ra") == b"tail"


def test_remote_read_into_zero_alloc_path(served):
    root, base = served
    arr = np.random.default_rng(2).normal(size=(64, 33)).astype(np.float32)
    _write(root, "r.ra", arr)
    out = np.empty_like(arr)
    res = ra.read_into(f"{base}/r.ra", out)
    assert res is out and np.array_equal(out, arr)
    with pytest.raises(ra.RawArrayError, match="shape"):
        ra.read_into(f"{base}/r.ra", np.empty((3, 3), np.float32))


def test_mmap_side_refuses_urls_and_write_needs_auth(served, monkeypatch):
    """mmap/append stay local-only; ``write`` to a URL now goes through the
    upload plane (DESIGN.md §11) — against this read-only server it must
    fail loudly (403), and without a token it must not even try."""
    root, base = served
    _write(root, "w.ra", np.zeros(4, np.float32))
    url = f"{base}/w.ra"
    monkeypatch.delenv("RA_REMOTE_TOKEN", raising=False)
    with pytest.raises(ra.RawArrayError, match="bearer token"):
        ra.write(url, np.zeros(4, np.float32))
    monkeypatch.setenv("RA_REMOTE_TOKEN", "some-token")
    with pytest.raises(ra.RawArrayError, match="403"):
        ra.write(url, np.zeros(4, np.float32))  # this server is read-only
    with pytest.raises(ra.RawArrayError, match="local-only"):
        ra.memmap(url)
    with pytest.raises(ra.RawArrayError, match="local-only"):
        ra.append_metadata(url, b"x")


def test_naive_single_stream_baseline_equivalence(served):
    root, base = served
    arr = np.random.default_rng(3).integers(0, 255, size=1 << 16).astype(np.uint8)
    _write(root, "n.ra", arr)
    reader = remote.RemoteReader(f"{base}/n.ra", use_cache=False)
    hdr = ra.header_of(f"{base}/n.ra")
    out = np.empty_like(arr)
    reader.pread_into_naive(hdr.nbytes, memoryview(out))
    assert np.array_equal(out, arr)
    reader.close()


# ------------------------------------------------------------- block cache
def test_block_cache_lru_and_counters():
    c = BlockCache(block_bytes=4, capacity_bytes=12)  # 3 blocks max
    assert c.get("t", 0) is None and c.misses == 1
    for i in range(3):
        c.put("t", i, b"abcd")
    assert c.get("t", 0) == b"abcd" and c.hits == 1
    c.put("t", 3, b"efgh")  # evicts block 1 (LRU; 0 was just touched)
    assert c.evictions == 1
    assert c.get("t", 1) is None
    assert c.get("t", 0) == b"abcd" and c.get("t", 3) == b"efgh"
    assert c.nbytes == 12 and len(c) == 3
    s = c.stats()
    assert s["hits"] == 3 and s["misses"] == 2 and s["evictions"] == 1
    c.clear()
    assert len(c) == 0 and c.nbytes == 0


def test_reader_cache_hits_on_reread(served):
    root, base = served
    arr = np.random.default_rng(4).normal(size=(256, 16)).astype(np.float32)
    _write(root, "c.ra", arr)
    cache = BlockCache(block_bytes=4096, capacity_bytes=1 << 22)
    reader = remote.RemoteReader(f"{base}/c.ra", cache=cache)
    hdr = ra.header_of(f"{base}/c.ra")
    out = np.empty_like(arr)
    reader.pread_into(hdr.nbytes, memoryview(out).cast("B"))
    assert np.array_equal(out, arr)
    misses_cold = cache.misses
    assert misses_cold > 0 and cache.hits == 0
    out2 = np.zeros_like(arr)
    reader.pread_into(hdr.nbytes, memoryview(out2).cast("B"))
    assert np.array_equal(out2, arr)
    assert cache.misses == misses_cold  # warm pass never touched the wire
    assert cache.hits >= misses_cold
    reader.close()


def test_cache_tag_isolation():
    c = BlockCache(block_bytes=4, capacity_bytes=1 << 10)
    c.put("a@1", 0, b"aaaa")
    c.put("b@1", 0, b"bbbb")
    assert c.get("a@1", 0) == b"aaaa"
    assert c.invalidate("a@1") == 1
    assert c.get("a@1", 0) is None
    assert c.get("b@1", 0) == b"bbbb"


# ------------------------------------------------ failure modes (no hangs)
def test_truncated_range_raises(served):
    root, base = served
    _write(root, "t.ra", np.zeros(64, np.float32))
    reader = remote.get_reader(f"{base}/t.ra")
    buf = bytearray(1024)
    with pytest.raises(ra.RawArrayError, match="truncated"):
        reader.pread_into(reader.size - 10, memoryview(buf))


def test_dead_server_raises_not_hangs(tmp_path):
    """Connecting to a killed server fails fast with RawArrayError (bounded
    retries, socket timeout) — it must not hang or leak a bare socket error."""
    arr = np.zeros(1024, np.float32)
    ra.write(os.path.join(str(tmp_path), "d.ra"), arr)
    server = remote.serve(str(tmp_path), port=0)
    url = f"{server.url}/d.ra"
    server.shutdown()
    server.server_close()
    with pytest.raises(ra.RawArrayError, match="cannot reach"):
        remote.RemoteReader(url, timeout=5.0, retries=1, use_cache=False)


def test_mid_transfer_disconnect_raises(tmp_path):
    """A server that dies after half the entity must surface RawArrayError
    after bounded retries — never a hang, never silent short data."""
    import http.server

    payload = bytes(range(256)) * 64  # 16 KiB

    class HalfHandler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"  # connection closes with the handler

        def log_message(self, *a):
            pass

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload[: len(payload) // 2])
            self.wfile.flush()
            self.connection.close()  # mid-entity disconnect

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), HalfHandler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/x"
        reader = remote.RemoteReader(url, timeout=5.0, retries=1, use_cache=False)
        buf = bytearray(len(payload))
        with pytest.raises(ra.RawArrayError, match="failed"):
            reader.pread_into(0, memoryview(buf))
        reader.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_etag_change_mid_session_detected(served):
    root, base = served
    p = _write(root, "e.ra", np.arange(4096, dtype=np.float32))
    reader = remote.RemoteReader(f"{base}/e.ra", use_cache=False, retries=0)
    # rewrite the file: same size, different mtime → different ETag
    os.utime(p, ns=(os.stat(p).st_mtime_ns + 10**9,) * 2)
    buf = bytearray(64)
    with pytest.raises(ra.RawArrayError, match="changed on server"):
        reader.pread_into(0, memoryview(buf))
    reader.close()


# ----------------------------------------------------- data plane over HTTP
def test_sharded_read_slice_remote(served):
    root, base = served
    arr = np.random.default_rng(5).normal(size=(300, 9)).astype(np.float32)
    ra.write_sharded(os.path.join(root, "sh"), arr, nshards=4)
    url = f"{base}/sh"
    assert np.array_equal(ra.read_slice(url, 37, 255), arr[37:255])
    assert np.array_equal(ra.read_slice_naive(url, 37, 255), arr[37:255])
    assert np.array_equal(ra.read_sharded(url), arr)
    with pytest.raises(ra.RawArrayError, match="local-only"):
        ra.write_sharded(url, arr, nshards=2)


def _make_dataset(root, rows=200, shard_rows=64, seed=6):
    rng = np.random.default_rng(seed)
    w = RaDatasetWriter(
        os.path.join(root, "ds"),
        {"tok": ((8,), "uint32"), "y": ((), "float32")},
        shard_rows=shard_rows,
    )
    w.append(
        tok=rng.integers(0, 1000, size=(rows, 8)).astype(np.uint32),
        y=rng.normal(size=rows).astype(np.float32),
    )
    w.finish()
    return os.path.join(root, "ds")


def test_dataset_rows_and_gather_remote(served):
    root, base = served
    local = RaDataset(_make_dataset(root))
    rem = RaDataset(f"{base}/ds")
    assert rem.is_remote and rem.total_rows == local.total_rows
    for f in ("tok", "y"):
        assert np.array_equal(rem.rows(30, 170)[f], local.rows(30, 170)[f])
    idx = np.random.default_rng(7).permutation(local.total_rows)[:90]
    gl, gr = local.gather(idx), rem.gather(idx)
    for f in ("tok", "y"):
        assert np.array_equal(gr[f], gl[f])
    stats = rem.io_stats()
    assert stats.get("misses", 0) > 0
    with pytest.raises(ra.RawArrayError, match="remote"):
        rem.gather_naive(idx[:4])
    rem.close()
    local.close()


def test_loader_streams_remote_batches(served):
    root, base = served
    _make_dataset(root, rows=256)
    local = RaDataset(os.path.join(root, "ds"))
    rem = RaDataset(f"{base}/ds")
    dl_r = DataLoader(rem, batch_size=32, seed=11, prefetch=1)
    dl_l = DataLoader(local, batch_size=32, seed=11, prefetch=1)
    try:
        for _ in range(4):
            br, bl = next(dl_r), next(dl_l)
            for f in ("tok", "y"):
                assert np.array_equal(br[f], bl[f])
    finally:
        dl_r.stop()
        dl_l.stop()
    assert "remote_cache_hits" in dl_r.stats()
    with pytest.raises(ValueError, match="naive"):
        DataLoader(rem, batch_size=8, naive=True)
    rem.close()
    local.close()


def test_checkpoint_remote_restore(served):
    root, base = served
    rng = np.random.default_rng(8)
    params = {
        "w": rng.normal(size=(96, 17)).astype(np.float32),
        "b": rng.normal(size=(17,)).astype(np.float32),
    }
    final = store.save_checkpoint(os.path.join(root, "ck"), 42, params)
    url = f"{base}/{os.path.relpath(final, root)}"
    like = {k: np.empty_like(v) for k, v in params.items()}
    got, _, _ = store.load_checkpoint(url, like)
    for k in params:
        assert np.array_equal(got[k], params[k])
    sl = store.restore_resharded(url, "param__w", row_start=20, row_stop=50)
    assert np.array_equal(sl, params["w"][20:50])
    # saves to a URL go through the upload plane (DESIGN.md §11) — against
    # this READ-ONLY server they must fail loudly, not half-publish
    with pytest.raises(ra.RawArrayError, match="bearer token|403"):
        store.save_checkpoint(base, 43, params)


def test_racat_over_http(served, capsys):
    from repro_torch.core.racat import main as racat_main

    root, base = served
    _write(root, "v.ra", np.arange(64, dtype=np.float32), crc32=True)
    url = f"{base}/v.ra"
    assert racat_main(["header", url]) == 0
    assert "float" in capsys.readouterr().out
    assert racat_main(["verify", url]) == 0
    # corrupt on disk; verify over HTTP must fail
    p = os.path.join(root, "v.ra")
    blob = bytearray(open(p, "rb").read())
    blob[60] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    assert racat_main(["verify", url]) == 1


def test_literal_header_directory_not_shadowed(served):
    """A real file under a directory literally named 'header/' must serve
    its bytes — the /header/ JSON fast path only answers when no such file
    exists (the client falls back to a ranged header read on non-JSON)."""
    root, base = served
    os.makedirs(os.path.join(root, "header"), exist_ok=True)
    arr = np.arange(32, dtype=np.float32)
    ra.write(os.path.join(root, "header", "x.ra"), arr)
    assert np.array_equal(ra.read(f"{base}/header/x.ra"), arr)
    assert ra.header_of(f"{base}/header/x.ra").shape == (32,)


# ------------------------------------------------------- auth fail-fast (§11)
import http.server as _http_server


class _DenyingHandler(_http_server.BaseHTTPRequestHandler):
    """Answers EVERY request with a fixed auth-failure status and counts
    them — the shape of a token-auth plane rejecting a credential."""

    def _deny(self):
        self.server.hits += 1  # type: ignore[attr-defined]
        body = b"denied\n"
        self.send_response(self.server.deny_status)  # type: ignore[attr-defined]
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_HEAD = do_PUT = _deny

    def log_message(self, fmt, *args):
        pass


@pytest.fixture(params=[401, 403])
def denying_server(request):
    srv = _http_server.ThreadingHTTPServer(("127.0.0.1", 0), _DenyingHandler)
    srv.deny_status = request.param
    srv.hits = 0
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        remote.close_readers()


def test_auth_rejection_fails_fast_on_reads(denying_server):
    """401/403 must raise ``RemoteAuthError`` after exactly ONE request —
    a rejected credential is permanent, so the retry budget (which exists
    for transient transport faults) must not be burned on it."""
    srv, base = denying_server
    with pytest.raises(remote.RemoteAuthError, match=str(srv.deny_status)):
        remote.RemoteReader(f"{base}/x.ra", retries=5)
    assert srv.hits == 1  # HEAD stat: one attempt, not retries+1

    srv.hits = 0
    with pytest.raises(remote.RemoteAuthError, match="token"):
        remote.fetch_bytes(f"{base}/manifest.json", retries=5)
    assert srv.hits == 1


def test_auth_rejection_fails_fast_on_ranged_get(denying_server):
    """A reader whose stat succeeded but whose GETs are rejected (token
    revoked mid-session) also fails fast on the ranged read itself."""
    srv, base = denying_server
    reader = remote.RemoteReader.__new__(remote.RemoteReader)
    # hand-build just enough state to drive _ranged_into directly
    from repro_torch.remote.client import _ConnPool
    from urllib.parse import urlsplit

    parts = urlsplit(f"{base}/x.ra")
    reader.url = f"{base}/x.ra"
    reader._path = parts.path
    reader.retries = 5
    reader._pool = _ConnPool(parts.scheme, parts.hostname, parts.port, 2, 5.0)
    reader._breaker = remote.breaker_for(parts.hostname, parts.port)
    reader.etag = None
    reader.size = 1 << 20
    with pytest.raises(remote.RemoteAuthError, match=str(srv.deny_status)):
        reader._ranged_into(0, memoryview(bytearray(64)))
    assert srv.hits == 1
    reader._pool.close()


def test_auth_rejection_fails_fast_on_uploads(denying_server):
    """Uploads against a rejecting server: one PUT, clear auth error,
    no retry burn (upload_bytes would otherwise blind-retry)."""
    srv, base = denying_server
    with pytest.raises(remote.RemoteAuthError, match="token"):
        remote.upload_bytes(f"{base}/up.ra", b"payload", token="bad", retries=5)
    assert srv.hits == 1


def test_auth_error_is_rawarray_error(denying_server):
    """RemoteAuthError stays catch-compatible with every existing caller
    that handles RawArrayError."""
    srv, base = denying_server
    assert issubclass(remote.RemoteAuthError, ra.RawArrayError)
    with pytest.raises(ra.RawArrayError):
        remote.fetch_bytes(f"{base}/x")


# ------------------------------------------- observability + breaker (§14)
def test_healthz_and_metrics_json(served):
    root, base = served
    arr = np.arange(4096, dtype=np.float32)
    _write(root, "m.ra", arr)
    assert np.array_equal(ra.read(f"{base}/m.ra"), arr)

    with urllib.request.urlopen(f"{base}/healthz") as resp:
        h = json.load(resp)
    assert h["ok"] is True and h["role"] == "origin" and h["uptime_s"] >= 0

    with urllib.request.urlopen(f"{base}/metrics") as resp:
        m = json.load(resp)
    assert m["role"] == "origin"
    assert m["requests"] > 0 and m["bytes_out"] > 0 and m["errors"] >= 0
    assert "/m.ra" in m["paths"]


def test_metrics_survive_a_concurrent_hammer(served):
    """Counter mutations race N reader threads against N metrics scrapers;
    the snapshot must stay internally consistent (no torn counts, no
    exceptions from the handler thread pool)."""
    root, base = served
    arr = np.arange(65536, dtype=np.uint8)
    _write(root, "h.ra", arr)
    url = f"{base}/h.ra"
    errors = []

    def reader():
        try:
            for _ in range(5):
                with remote.RemoteReader(url, use_cache=False) as r:
                    out = bytearray(1024)
                    r.pread_into(0, memoryview(out))
        except Exception as exc:  # pragma: no cover - the assertion payload
            errors.append(exc)

    def scraper():
        try:
            for _ in range(10):
                with urllib.request.urlopen(f"{base}/metrics") as resp:
                    m = json.load(resp)
                assert m["requests"] >= 0 and m["bytes_out"] >= 0
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=t) for t in (reader,) * 4 + (scraper,) * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors
    with urllib.request.urlopen(f"{base}/metrics") as resp:
        m = json.load(resp)
    assert m["requests"] >= 20  # 4 readers x 5 GETs at minimum


def test_breaker_opens_after_dead_replica(tmp_path):
    """Regression for per-host circuit breaking: after K consecutive refused
    connects the breaker opens and later calls fail in microseconds instead
    of burning connect+retry budgets against a corpse."""
    import time as _time

    remote.reset_breakers()
    arr = np.zeros(512, np.float32)
    ra.write(os.path.join(str(tmp_path), "b.ra"), arr)
    server = remote.serve(str(tmp_path), port=0)
    url = f"{server.url}/b.ra"
    server.shutdown()
    server.server_close()
    try:
        with pytest.raises(ra.RawArrayError, match="cannot reach"):
            remote.RemoteReader(url, retries=4, use_cache=False)
        t0 = _time.perf_counter()
        with pytest.raises(ra.RawArrayError, match="circuit open"):
            remote.RemoteReader(url, retries=4, use_cache=False)
        assert _time.perf_counter() - t0 < 0.25
        brk = remote.breaker_for(*_host_port(url))
        assert brk.stats()["open"]
    finally:
        remote.reset_breakers()


def _host_port(url):
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    return parts.hostname, parts.port


def test_breaker_half_open_recovers(tmp_path):
    """A healed host closes the breaker on the first successful probe; a
    still-dead host re-opens it after ONE refusal (the streak stays primed
    at the threshold through half-open)."""
    remote.reset_breakers()
    os.environ["RA_REMOTE_BREAKER_COOLDOWN"] = "0.05"
    try:
        arr = np.arange(256, dtype=np.float32)
        ra.write(os.path.join(str(tmp_path), "r.ra"), arr)
        server = remote.serve(str(tmp_path), port=0)
        host, port = _host_port(server.url)
        addr = server.server_address
        url = f"{server.url}/r.ra"
        server.shutdown()
        server.server_close()
        with pytest.raises(ra.RawArrayError, match="cannot reach"):
            remote.RemoteReader(url, retries=4, use_cache=False)
        assert remote.breaker_for(host, port).stats()["open"]
        import time as _time

        _time.sleep(0.06)  # cooldown elapses -> half-open
        server2 = remote.ArrayServer(str(tmp_path), addr)  # same port heals
        t = threading.Thread(target=server2.serve_forever, daemon=True)
        t.start()
        try:
            got = ra.read(url)
            assert np.array_equal(got, arr)
            assert not remote.breaker_for(host, port).stats()["open"]
        finally:
            server2.shutdown()
            server2.server_close()
            remote.close_readers()
            remote.reset_shared_cache()
    finally:
        os.environ.pop("RA_REMOTE_BREAKER_COOLDOWN", None)
        remote.reset_breakers()


def test_cache_counters_consistent_under_threads():
    """hits + misses must equal issued gets even when get/put race from many
    threads, and hit_ratio stays within [0, 1] — the §14 counter audit."""
    cache = BlockCache(block_bytes=64, capacity_bytes=64 * 32)
    gets_per_thread = 400
    nthreads = 8

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(gets_per_thread):
            b = int(rng.integers(0, 64))
            if cache.get("t", b) is None:
                cache.put("t", b, bytes(64))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    s = cache.stats()
    assert s["hits"] + s["misses"] == nthreads * gets_per_thread
    assert 0.0 <= s["hit_ratio"] <= 1.0
    cache.reset_stats()
    s2 = cache.stats()
    assert s2["hits"] == s2["misses"] == s2["evictions"] == s2["invalidations"] == 0


def test_overwrite_never_serves_stale_blocks(served):
    """ETag-tagged cache keys end-to-end: overwrite the file on the origin
    mid-session; a fresh read must see the new bytes and never mix cached
    blocks of the old version."""
    import time as _time

    root, base = served
    p = _write(root, "s.ra", np.zeros(30_000, np.float32))
    url = f"{base}/s.ra"
    assert float(ra.read(url)[0]) == 0.0
    _time.sleep(0.01)  # mtime tick -> new ETag
    ra.write(p, np.full(30_000, 7.0, np.float32))
    remote.close_readers()  # old pinned readers retire; cache stays hot
    got = ra.read(url)
    assert np.array_equal(got, np.full(30_000, 7.0, np.float32))

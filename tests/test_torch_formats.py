"""The port's foreign formats and streaming ingest plane, held to the JAX
package's tests: a mirror of ``tests/test_ingest.py`` (incremental RaWriter,
ShardedWriter, DatasetBuilder, the remote upload path, and racat ingest)
and of ``tests/test_formats_baselines.py`` (png / hdf5min / nrrd), with the
targets in ``repro_torch``.

The load-bearing invariants:

* streamed output is BYTE-IDENTICAL to monolithic ``write()`` for every
  flag combination (plain, crc32, chunked x {raw, zlib}, metadata);
* crash-safety: a writer killed mid-stream (SIGKILL, no cleanup handlers)
  leaves NO partial file visible under the final name;
* finalize-twice / write-after-finalize / finish-after-abort raise;
* the remote PUT session round-trips byte-identically through the existing
  read plane and enforces its token.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro_torch.core as ra
from repro_torch import remote
from repro_torch.core.io import RaWriter
from repro_torch.core.sharded import ShardedWriter
from repro_torch.data.dataset import DatasetBuilder, RaDataset
from repro_torch.formats import hdf5min, nrrd, png

TOKEN = "test-ingest-token"


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def writable(tmp_path):
    """(root, base_url) with a live upload-enabled server."""
    root = tmp_path / "served"
    root.mkdir()
    server = remote.serve(str(root), port=0, upload_token=TOKEN)
    try:
        yield str(root), server.url
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()
        remote.reset_shared_cache()


FLAG_COMBOS = [
    dict(),
    dict(crc32=True),
    dict(chunked=True, codec="raw", chunk_bytes=4096),
    dict(chunked=True, codec="zlib", chunk_bytes=4096),
    dict(chunked=True, codec="zlib", chunk_bytes=4096, crc32=True),
]


def _stream(w: RaWriter, arr, batches=(1, 7, 64, 3, 200)):
    i = 0
    bi = 0
    while i < len(arr):
        n = batches[bi % len(batches)]
        w.write_rows(arr[i : i + n])
        i += n
        bi += 1


# ----------------------------------------------------------- byte identity
@pytest.mark.parametrize("kw", FLAG_COMBOS)
@pytest.mark.parametrize("meta", [None, b'{"captured": "live"}'])
def test_streamed_byte_identical_to_monolithic(tmp_path, rng, kw, meta):
    arr = rng.integers(0, 1 << 16, size=(531, 37), dtype=np.int64).astype(np.float32)
    mono = tmp_path / "mono.ra"
    streamed = tmp_path / "streamed.ra"
    ra.write(str(mono), arr, metadata=meta, **kw)
    w = RaWriter(str(streamed), arr.dtype, arr.shape[1:], metadata=meta, **kw)
    _stream(w, arr)
    hdr = w.finalize()
    assert mono.read_bytes() == streamed.read_bytes()
    assert hdr.shape == arr.shape
    back = ra.read(str(streamed), with_metadata=meta is not None)
    got = back[0] if meta is not None else back
    assert np.array_equal(np.asarray(got), arr)
    if meta is not None:
        assert back[1] == meta


@pytest.mark.parametrize("kw", [dict(), dict(crc32=True), dict(chunked=True, crc32=True)])
def test_zero_row_stream_matches_empty_write(tmp_path, kw):
    mono = tmp_path / "mono.ra"
    streamed = tmp_path / "streamed.ra"
    ra.write(str(mono), np.empty((0, 9), np.float32), **kw)
    RaWriter(str(streamed), np.float32, (9,), **kw).finalize()
    assert mono.read_bytes() == streamed.read_bytes()


def test_scalar_rows_and_casting(tmp_path):
    """Row shape () → a 1-D file; inputs are cast like the dataset writer."""
    w = RaWriter(str(tmp_path / "v.ra"), np.float32, ())
    w.write_rows(np.arange(5))  # int64 in, cast to float32
    w.write_rows(np.arange(5.0, 8.0))
    w.finalize()
    back = ra.read(str(tmp_path / "v.ra"))
    assert back.dtype == np.float32 and np.array_equal(back, np.arange(8, dtype=np.float32))


def test_wrong_row_shape_rejected(tmp_path):
    w = RaWriter(str(tmp_path / "x.ra"), np.float32, (4,))
    with pytest.raises(ra.RawArrayError, match="row shape"):
        w.write_rows(np.zeros((2, 5), np.float32))
    w.abort()


# ------------------------------------------------------------- crash safety
def test_unfinalized_writer_leaves_no_visible_file(tmp_path):
    w = RaWriter(str(tmp_path / "x.ra"), np.float32, (8,))
    w.write_rows(np.ones((100, 8), np.float32))
    del w  # never finalized
    assert not (tmp_path / "x.ra").exists()


def test_sigkill_mid_stream_leaves_no_partial_file(tmp_path):
    """A writer process killed with SIGKILL (no atexit, no cleanup) must not
    leave a partial file under the final name — only an invisible temp."""
    script = textwrap.dedent(
        f"""
        import numpy as np, os, sys
        sys.path.insert(0, {repr(os.path.join(os.path.dirname(__file__), "..", "src"))})
        from repro_torch.core.io import RaWriter
        w = RaWriter({repr(str(tmp_path / "x.ra"))}, np.float32, (64,), chunked=True)
        batch = np.ones((1024, 64), np.float32)
        while True:
            w.write_rows(batch)
            print("tick", flush=True)
        """
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        assert proc.stdout.readline().strip() == b"tick"  # mid-stream for sure
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not (tmp_path / "x.ra").exists()
    leftovers = [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    assert all(f.startswith(".x.ra.tmp-") for f in leftovers)  # hidden temps only


def test_finalize_twice_and_abort_paths(tmp_path):
    p = tmp_path / "x.ra"
    w = RaWriter(str(p), np.float32, (4,))
    w.write_rows(np.ones((3, 4), np.float32))
    w.finalize()
    with pytest.raises(ra.RawArrayError, match="finalized"):
        w.finalize()
    with pytest.raises(ra.RawArrayError, match="finalized"):
        w.write_rows(np.ones((1, 4), np.float32))
    w.abort()  # no-op after finalize: must NOT delete the published file
    assert p.exists()

    q = tmp_path / "y.ra"
    w = RaWriter(str(q), np.float32, (4,))
    w.write_rows(np.ones((3, 4), np.float32))
    w.abort()
    w.abort()  # idempotent
    assert not q.exists()
    with pytest.raises(ra.RawArrayError, match="aborted"):
        w.finalize()
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


def test_context_manager_finalizes_or_aborts(tmp_path, rng):
    arr = rng.normal(size=(10, 4)).astype(np.float32)
    with RaWriter(str(tmp_path / "ok.ra"), np.float32, (4,)) as w:
        w.write_rows(arr)
    assert np.array_equal(ra.read(str(tmp_path / "ok.ra")), arr)

    with pytest.raises(RuntimeError):
        with RaWriter(str(tmp_path / "bad.ra"), np.float32, (4,)) as w:
            w.write_rows(arr)
            raise RuntimeError("boom")
    assert not (tmp_path / "bad.ra").exists()


# ------------------------------------------------------------ ShardedWriter
def test_sharded_writer_rolls_and_reads_back(tmp_path, rng):
    arr = rng.normal(size=(777, 16)).astype(np.float32)
    d = str(tmp_path / "st")
    with ShardedWriter(d, np.float32, (16,), shard_rows=200, chunked=True,
                       chunk_bytes=2048) as w:
        for lo in range(0, 777, 31):
            w.write_rows(arr[lo : lo + 31])
    idx = ra.load_index(d)
    assert idx.offsets == (0, 200, 400, 600, 777)
    assert np.array_equal(ra.read_sharded(d), arr)
    assert np.array_equal(ra.read_slice(d, 150, 650), arr[150:650])
    # each shard byte-identical to a monolithic write of its slab
    slab = tmp_path / "slab.ra"
    # stats=True: ShardedWriter defaults stats ON for numeric dtypes (§16)
    ra.write(str(slab), arr[200:400], chunked=True, chunk_bytes=2048, stats=True)
    assert slab.read_bytes() == (tmp_path / "st" / "shard_00001.ra").read_bytes()


def test_sharded_writer_size_threshold(tmp_path, rng):
    arr = rng.normal(size=(1000, 32)).astype(np.float32)  # 128 B rows
    d = str(tmp_path / "st")
    with ShardedWriter(d, np.float32, (32,), shard_bytes=16 * 1024) as w:  # 128 rows
        w.write_rows(arr)
    idx = ra.load_index(d)
    assert len(idx.files) == 8  # ceil(1000 / 128)
    assert np.array_equal(ra.read_sharded(d), arr)


def test_sharded_writer_abort_leaves_no_index(tmp_path):
    d = str(tmp_path / "st")
    w = ShardedWriter(d, np.float32, (8,), shard_rows=10)
    w.write_rows(np.ones((25, 8), np.float32))  # 2 sealed shards + 1 open
    w.abort()
    assert not os.path.exists(os.path.join(d, "index.json"))
    with pytest.raises(ra.RawArrayError, match="aborted"):
        w.finalize()


def test_sharded_writer_empty_matches_write_sharded(tmp_path):
    a = str(tmp_path / "a")
    b = str(tmp_path / "b")
    ra.write_sharded(a, np.empty((0, 4), np.float32), nshards=3)
    ShardedWriter(b, np.float32, (4,), shard_rows=10).finalize()
    assert ra.load_index(a).offsets == ra.load_index(b).offsets == (0, 0)
    assert ra.read_sharded(b).shape == (0, 4)


# ------------------------------------------------------------ DatasetBuilder
def test_dataset_builder_streams_and_rolls(tmp_path, rng):
    root = str(tmp_path / "ds")
    x = rng.normal(size=(500, 12)).astype(np.float32)
    y = rng.integers(0, 10, size=500)
    with DatasetBuilder(root, {"x": ((12,), "float32"), "y": ((), "int64")},
                        shard_rows=150) as b:
        for i in range(0, 500, 7):
            b.append(x=x[i : i + 7], y=y[i : i + 7])
    ds = RaDataset(root)
    assert len(ds) == 500 and len(ds.shards) == 4
    got = ds.rows(140, 160)
    assert np.array_equal(got["x"], x[140:160])
    assert np.array_equal(got["y"], y[140:160])
    # shard files byte-identical to the pre-streaming (monolithic) writer
    mono = tmp_path / "mono.ra"
    # stats=True: DatasetBuilder defaults stats ON for numeric dtypes (§16)
    ra.write(str(mono), x[150:300], stats=True)
    assert mono.read_bytes() == (tmp_path / "ds" / "x_00001.ra").read_bytes()


def test_dataset_builder_add_and_states(tmp_path):
    root = str(tmp_path / "ds")
    b = DatasetBuilder(root, {"v": ((3,), "float32")}, shard_rows=4)
    for i in range(6):
        b.add(v=np.full(3, i, np.float32))
    assert b.rows == 6
    man = b.finish(metadata={"origin": "unit-test"})
    assert man["total_rows"] == 6
    with pytest.raises(ra.RawArrayError, match="finished"):
        b.finish()
    with pytest.raises(ra.RawArrayError, match="finished"):
        b.append(v=np.zeros((1, 3), np.float32))
    assert RaDataset(root).metadata == {"origin": "unit-test"}


def test_dataset_builder_abort_publishes_nothing(tmp_path):
    root = str(tmp_path / "ds")
    b = DatasetBuilder(root, {"v": ((3,), "float32")}, shard_rows=100)
    b.append(v=np.ones((5, 3), np.float32))
    b.abort()
    assert not os.path.exists(os.path.join(root, "manifest.json"))
    assert not [f for f in os.listdir(root) if f.endswith(".ra")]


# ------------------------------------------------------------- remote plane
@pytest.mark.parametrize("kw", FLAG_COMBOS)
def test_remote_writer_byte_identical_roundtrip(writable, tmp_path, rng, kw):
    root, base = writable
    arr = rng.integers(0, 1 << 16, size=(257, 19), dtype=np.int64).astype(np.float32)
    url = f"{base}/up/stream.ra"
    w = remote.RemoteWriter(url, np.float32, (19,), token=TOKEN,
                            metadata=b"remote!", **kw)
    _stream(w, arr)
    w.finalize()
    local = tmp_path / "local.ra"
    ra.write(str(local), arr, metadata=b"remote!", **kw)
    assert local.read_bytes() == open(os.path.join(root, "up", "stream.ra"), "rb").read()
    assert not os.path.exists(os.path.join(root, "up", "stream.ra.part"))
    # through the existing remote read plane
    back, meta = ra.read(url, with_metadata=True)
    assert np.array_equal(back, arr) and meta == b"remote!"


def test_whole_object_put_via_write(writable, tmp_path, rng, monkeypatch):
    root, base = writable
    monkeypatch.setenv("RA_REMOTE_TOKEN", TOKEN)
    arr = rng.normal(size=(64, 8)).astype(np.float32)
    n = ra.write(f"{base}/whole.ra", arr, crc32=True)
    local = tmp_path / "local.ra"
    assert n == ra.write(str(local), arr, crc32=True)
    assert local.read_bytes() == open(os.path.join(root, "whole.ra"), "rb").read()
    assert np.array_equal(ra.read(f"{base}/whole.ra"), arr)


def test_upload_auth_is_enforced(writable, tmp_path):
    _, base = writable
    with pytest.raises(ra.RawArrayError, match="401"):
        remote.upload_bytes(f"{base}/x.ra", b"data", token="wrong-token")
    with pytest.raises(ra.RawArrayError, match="bearer token"):
        remote.upload_bytes(f"{base}/x.ra", b"data", token=None)
    # read-only server: 403 regardless of token
    ro = remote.serve(str(tmp_path), port=0)
    try:
        with pytest.raises(ra.RawArrayError, match="403"):
            remote.upload_bytes(f"{ro.url}/x.ra", b"data", token=TOKEN)
    finally:
        ro.shutdown()
        ro.server_close()


def test_upload_rejects_path_escape(writable):
    _, base = writable
    with pytest.raises(ra.RawArrayError, match="404"):
        remote.upload_bytes(f"{base}/../evil.ra", b"data", token=TOKEN)


def test_remote_abort_removes_part(writable):
    root, base = writable
    w = remote.RemoteWriter(f"{base}/gone.ra", np.float32, (8,), token=TOKEN)
    w.write_rows(np.ones((4, 8), np.float32))
    assert os.path.exists(os.path.join(root, "gone.ra.part"))
    w.abort()
    assert not os.path.exists(os.path.join(root, "gone.ra.part"))
    assert not os.path.exists(os.path.join(root, "gone.ra"))


def test_append_offset_desync_is_loud(writable):
    root, base = writable
    from repro_torch.remote.client import _UploadSink

    s = _UploadSink(f"{base}/clash.ra", token=TOKEN)
    s.append([b"aaaa"])
    # the server loses the session under the writer (crash, cleanup, a
    # competing writer's reset): the next append must 409, never corrupt
    os.unlink(os.path.join(root, "clash.ra.part"))
    with pytest.raises(ra.RawArrayError, match="409"):
        s.append([b"bbbb"])  # writer thinks offset 4; server part is empty
    s.close()


def test_stale_part_does_not_block_new_session(writable, rng):
    """A SIGKILLed predecessor leaves <path>.part server-side; a fresh
    RemoteWriter must reset the session instead of 409ing forever."""
    root, base = writable
    arr = rng.normal(size=(20, 8)).astype(np.float32)
    dead = remote.RemoteWriter(f"{base}/re.ra", np.float32, (8,), token=TOKEN)
    dead.write_rows(arr)
    dead._sink.close()  # vanish without abort/commit (the SIGKILL shape)
    dead._state = "aborted"  # keep __del__ from politely cleaning up
    assert os.path.exists(os.path.join(root, "re.ra.part"))
    with remote.RemoteWriter(f"{base}/re.ra", np.float32, (8,), token=TOKEN) as w:
        w.write_rows(arr)
    assert np.array_equal(ra.read(f"{base}/re.ra"), arr)


def test_checkpoint_save_to_url_roundtrip(writable):
    root, base = writable
    from repro_torch.checkpoint.store import save_checkpoint, load_checkpoint

    params = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
              "b": np.ones(6, np.float32)}
    os.environ["RA_REMOTE_TOKEN"] = TOKEN
    try:
        final = save_checkpoint(base, 3, params, chunked=True, chunk_bytes=64,
                                extra={"lr": 0.1})
    finally:
        os.environ.pop("RA_REMOTE_TOKEN", None)
    assert final == f"{base}/step_00000003"
    assert os.path.exists(os.path.join(root, "step_00000003", "manifest.json"))
    back, _, extra = load_checkpoint(final, params)
    assert np.array_equal(np.asarray(back["w"]), params["w"])
    assert extra == {"lr": 0.1}


# ------------------------------------------------------------- racat ingest
def test_racat_ingest_concatenates_sources(tmp_path, rng, capsys):
    from repro_torch.core.racat import main as racat

    a = rng.normal(size=(40, 6)).astype(np.float32)
    b = rng.normal(size=(25, 6)).astype(np.float32)
    np.save(str(tmp_path / "a.npy"), a)
    ra.write(str(tmp_path / "b.ra"), b, chunked=True, chunk_bytes=512)
    out = tmp_path / "cat.ra"
    rc = racat(["ingest", str(out), str(tmp_path / "a.npy"), str(tmp_path / "b.ra"),
                "--codec", "zlib", "--chunk-bytes", "256", "--crc32",
                "--batch-rows", "9"])
    assert rc == 0
    mono = tmp_path / "mono.ra"
    ra.write(str(mono), np.concatenate([a, b]), chunked=True, codec="zlib",
             chunk_bytes=256, crc32=True)
    assert mono.read_bytes() == out.read_bytes()
    assert racat(["verify", str(out)]) == 0


def test_racat_ingest_shape_mismatch_fails(tmp_path, rng, capsys):
    from repro_torch.core.racat import main as racat

    np.save(str(tmp_path / "a.npy"), rng.normal(size=(4, 6)).astype(np.float32))
    np.save(str(tmp_path / "b.npy"), rng.normal(size=(4, 7)).astype(np.float32))
    rc = racat(["ingest", str(tmp_path / "o.ra"),
                str(tmp_path / "a.npy"), str(tmp_path / "b.npy")])
    assert rc == 1
    assert not (tmp_path / "o.ra").exists()  # aborted, nothing published


def test_racat_inspect_reports_metadata_length(tmp_path, capsys):
    from repro_torch.core.racat import main as racat

    p = tmp_path / "m.ra"
    ra.write(str(p), np.arange(8, dtype=np.float32), metadata=b"0123456789ab",
             crc32=True)
    assert racat(["inspect", str(p)]) == 0
    out = capsys.readouterr().out
    assert "metadata     12 bytes" in out

    q = tmp_path / "c.ra"
    ra.write(str(q), np.arange(512, dtype=np.float32), metadata=b"xyz",
             chunked=True, chunk_bytes=256)
    assert racat(["inspect", str(q)]) == 0
    out = capsys.readouterr().out
    assert "metadata     3 bytes" in out


def test_racat_help_epilog_lists_subcommands(capsys):
    from repro_torch.core.racat import main as racat

    with pytest.raises(SystemExit) as e:
        racat(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for word in ["header", "verify", "compress", "inspect", "ingest", "exit codes"]:
        assert word in out


# ------------------------------------------------------------------- png
@settings(max_examples=20, deadline=None)
@given(
    h=st.integers(1, 40),
    w=st.integers(1, 40),
    rgb=st.booleans(),
    level=st.sampled_from([0, 1, 6]),
)
def test_png_roundtrip_property(h, w, rgb, level):
    rng = np.random.default_rng(h * 41 + w)
    img = rng.integers(0, 256, (h, w, 3) if rgb else (h, w), dtype=np.uint8)
    assert np.array_equal(png.decode(png.encode(img, level=level)), img)


@pytest.mark.parametrize("filt", [1, 2, 3, 4])
def test_png_decode_all_filters(filt):
    """Our encoder emits filter 0; the decoder must handle 1-4 (real files)."""
    import struct
    import zlib

    rng = np.random.default_rng(filt)
    img = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    h, w = img.shape
    raw = bytearray()
    prev = np.zeros(w, np.int16)
    for y in range(h):
        raw.append(filt)
        row = img[y].astype(np.int16)
        if filt == 1:
            enc = row.copy()
            enc[1:] -= row[:-1]
        elif filt == 2:
            enc = row - prev
        elif filt == 3:
            left = np.concatenate([[0], row[:-1]])
            enc = row - ((left + prev) // 2)
        else:  # paeth
            enc = np.empty_like(row)
            for x in range(w):
                a = int(row[x - 1]) if x else 0
                b = int(prev[x])
                c = int(prev[x - 1]) if x else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                enc[x] = row[x] - pred
        raw += (enc % 256).astype(np.uint8).tobytes()
        prev = row

    def chunk(tag, payload):
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )
    assert np.array_equal(png.decode(data), img)


# ------------------------------------------------------------------- hdf5
@pytest.mark.parametrize("dtype", ["int8", "uint16", "int32", "int64", "float32", "float64"])
def test_hdf5_dtype_roundtrip(tmp_path, dtype):
    arr = (np.arange(24) - 12).astype(dtype).reshape(2, 3, 4)
    p = str(tmp_path / "x.h5")
    hdf5min.write(p, arr)
    assert np.array_equal(hdf5min.read(p), arr)


def test_hdf5_signature_and_many_datasets(tmp_path):
    p = str(tmp_path / "m.h5")
    arrs = {f"ds{i:03d}": np.full((5,), i, np.float32) for i in range(50)}
    hdf5min.write_datasets(p, arrs)
    assert open(p, "rb").read(8) == b"\x89HDF\r\n\x1a\n"
    f = hdf5min.H5MinFile(p)
    assert set(f.names) == set(arrs)
    for n, a in arrs.items():
        assert np.array_equal(f.read(n), a)


def test_hdf5_incremental_equivalent(tmp_path):
    arrs = {f"d{i}": np.random.default_rng(i).normal(size=(7,)).astype(np.float32) for i in range(9)}
    p1, p2 = str(tmp_path / "a.h5"), str(tmp_path / "b.h5")
    hdf5min.write_datasets(p1, arrs)
    hdf5min.write_datasets_incremental(p2, arrs)
    f1, f2 = hdf5min.H5MinFile(p1), hdf5min.H5MinFile(p2)
    for n in arrs:
        assert np.array_equal(f1.read(n), f2.read(n))


# ------------------------------------------------------------------- nrrd
@settings(max_examples=15, deadline=None)
@given(
    dtype=st.sampled_from(["uint8", "int16", "int32", "float32", "float64"]),
    shape=st.lists(st.integers(1, 6), min_size=1, max_size=4),
)
def test_nrrd_roundtrip_property(tmp_path_factory, dtype, shape):
    d = tmp_path_factory.mktemp("nrrd")
    arr = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    p = str(d / "x.nrrd")
    nrrd.write(p, arr)
    back = nrrd.read(p)
    assert back.shape == arr.shape and np.array_equal(back, arr)

"""The port's devtools, held to the JAX package's tests: a mirror of the
layouts, tsan and ``racat doctor`` cases of ``tests/test_devtools.py`` with
the targets in ``repro_torch`` (the ralint cases stay with the JAX package,
whose ``tools/ralint.py`` lints both packages), the guard scanner the port's
tsan carries in place of ralint's, and the port's threaded URL plane (a
cold start and a ``DataLoader`` epoch from a byte-range server) run under
the port's sanitizer with every threaded module watched."""

import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import remote
from repro_torch.checkpoint import load_checkpoint, restore_pipelined, save_checkpoint
from repro_torch.core import io as ra_io
from repro_torch.core import layouts
from repro_torch.core.racat import main as racat_main
from repro_torch.data import DataLoader, DatasetBuilder, RaDataset
from repro_torch.devtools import doctor, tsan
from repro_torch.devtools import guards as guards_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ guard scanner


class TestLintTree:
    def test_collect_guards_reads_annotations(self):
        cache_py = os.path.join(REPO, "src", "repro_torch", "remote", "cache.py")
        guards = guards_mod.collect_guards(cache_py)
        assert guards["BlockCache"]["hits"] == "_lock"
        assert guards["BlockCache"]["_blocks"] == "_lock"

    def test_watch_all_covers_the_threaded_modules(self):
        watched = tsan.watch_all()
        try:
            assert {w.rsplit(".", 1)[0] for w in watched} >= {
                "repro_torch.remote.cache", "repro_torch.remote.client",
                "repro_torch.fleet.edge", "repro_torch.data.loader",
                "repro_torch.checkpoint.coldstart"}
            assert all(m.startswith("repro_torch.") for m in tsan.DEFAULT_WATCH_MODULES)
        finally:
            tsan.unwatch_all()


# ------------------------------------------------------------------ layouts


class TestLayouts:
    def test_header_geometry(self):
        H = layouts.HEADER
        assert H.magic == b"rawarray"
        assert H.head_bytes == 48
        assert H.nbytes(3) == 48 + 24
        assert H.magic_int == int.from_bytes(b"rawarray", "little")

    def test_chunk_table_and_stats_geometry(self):
        assert layouts.CHUNK_TABLE.head_bytes == 32
        assert layouts.CHUNK_TABLE.entry_bytes == 32
        assert layouts.RASTATS.head_bytes == 40
        assert layouts.RASTATS.entry_bytes == 32
        assert layouts.CRC32.head_bytes == 4

    def test_registered_formats_closed_set(self):
        for fmt in ("<QQQQQQ", "<QQQQ", "<QQQQQ", "<Q", "<I"):
            assert fmt in layouts.REGISTERED_FORMATS
        # registry sizes agree with struct itself
        for lay in layouts.LAYOUTS.values():
            assert struct.calcsize(lay.head_fmt) == lay.head_bytes


# --------------------------------------------------------------------- tsan

_SCOPE = ("/tests/", "/repro_torch/", os.sep + "tests" + os.sep)


@pytest.fixture
def sanitizer():
    """Locally-installed sanitizer; restores global state afterwards."""
    was_installed = tsan.installed()
    tsan.install(scope=_SCOPE, hold_ms=60_000)
    yield tsan
    tsan.drain()
    if not was_installed:
        tsan.uninstall()
    else:  # suite runs under --ra-sanitize: restore its default config
        tsan.install()


class TestTsanLocks:
    def test_lock_order_inversion_detected(self, sanitizer):
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        kinds = [r.kind for r in sanitizer.drain()]
        assert "lock-order-inversion" in kinds

    def test_consistent_order_clean(self, sanitizer):
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
        assert [r for r in sanitizer.drain() if r.severity == "error"] == []

    def test_acquire_after_finalize(self, sanitizer):
        lk = threading.Lock()
        lk.finalize()
        with lk:
            pass
        kinds = [r.kind for r in sanitizer.drain()]
        assert kinds == ["acquire-after-finalize"]

    def test_long_hold_warns(self, sanitizer):
        sanitizer.install(scope=_SCOPE, hold_ms=5)
        lk = threading.Lock()
        with lk:
            time.sleep(0.03)
        reps = sanitizer.drain()
        assert [r.kind for r in reps] == ["long-hold"]
        assert reps[0].severity == "warn"

    def test_condition_wait_notify_works_instrumented(self, sanitizer):
        cond = threading.Condition()
        ready = []

        def waiter():
            with cond:
                while not ready:
                    cond.wait(timeout=2.0)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            ready.append(1)
            cond.notify_all()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert [r for r in sanitizer.drain() if r.severity == "error"] == []

    def test_rlock_reentrancy_no_false_positive(self, sanitizer):
        r = threading.RLock()
        with r:
            with r:
                pass
        assert [x for x in sanitizer.drain() if x.severity == "error"] == []


class TestTsanFieldTracer:
    def test_cross_thread_unguarded_write_flagged(self, sanitizer):
        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: _lock

        sanitizer.watch_class(Counter, {"n": "_lock"})
        try:
            c = Counter()
            c.n += 1  # creator thread: single-owner idiom, exempt

            def locked_bump():
                with c._lock:
                    c.n += 1

            def racy_bump():
                c.n += 1

            for fn, expect in ((locked_bump, 0), (racy_bump, 1)):
                t = threading.Thread(target=fn)
                t.start()
                t.join()
                reps = [r for r in sanitizer.drain() if r.kind == "unguarded-write"]
                assert len(reps) == expect, (fn.__name__, reps)
        finally:
            sanitizer.unwatch_all()


class TestSeededRaces:
    """Recreations of two races this repo actually shipped and later fixed.

    These prove the sanitizer would have caught both at the time."""

    def test_pr5_zombie_ring_writer(self, sanitizer):
        # The loader ring as first shipped: stop() set a flag but never joined the
        # producer, which could wake after shutdown and write into a ring
        # whose owner considered it dead.
        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self.depth = 0  # guarded-by: _lock

        sanitizer.watch_class(Ring, {"depth": "_lock"})
        try:
            ring = Ring()
            ring.depth = 1  # creator warms the ring
            wake = threading.Event()

            def zombie():
                wake.wait(timeout=5.0)
                with ring._lock:  # acquire-after-finalize
                    pass
                ring.depth += 1  # unguarded cross-thread write

            t = threading.Thread(target=zombie)
            t.start()
            # "shutdown": owner declares the ring dead without joining
            ring._lock.finalize()
            wake.set()
            t.join(timeout=5.0)

            kinds = [r.kind for r in sanitizer.drain() if r.severity == "error"]
            assert "acquire-after-finalize" in kinds
            assert "unguarded-write" in kinds
        finally:
            sanitizer.unwatch_all()

    def test_pr7_cache_counter_race(self, sanitizer):
        # BlockCache's counters as first shipped: `cache.hits += 1` outside _lock.
        # The real class + its real guarded-by annotations, via the same
        # lint-derived map the pytest plugin uses.
        import repro_torch.remote.cache as cache_mod

        watched = sanitizer.watch_module(cache_mod)
        try:
            assert "BlockCache" in watched
            cache = cache_mod.BlockCache(capacity_bytes=1 << 20)
            barrier = threading.Barrier(2)

            def racy_reader():
                barrier.wait(timeout=5.0)
                for _ in range(50):
                    cache.hits += 1  # the shipped bug: no self._lock

            ts = [threading.Thread(target=racy_reader) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=5.0)

            reps = [r for r in sanitizer.drain() if r.kind == "unguarded-write"]
            assert reps, "sanitizer missed the block cache counter race"
            assert any("hits" in r.where for r in reps)
        finally:
            sanitizer.unwatch_all()

    def test_guarded_cache_use_is_clean(self, sanitizer):
        import repro_torch.remote.cache as cache_mod

        sanitizer.watch_module(cache_mod)
        try:
            cache = cache_mod.BlockCache(capacity_bytes=1 << 20)

            def worker(i):
                cache.put(f"k{i}", 0, b"x" * 64)
                cache.get(f"k{i}", 0)
                cache.get("missing", 0)

            ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=5.0)
            errors = [r for r in sanitizer.drain() if r.severity == "error"]
            assert errors == [], errors
        finally:
            sanitizer.unwatch_all()


# ------------------------------------------------------------------- doctor


@pytest.fixture
def corpus(tmp_path):
    a = np.arange(4096, dtype=np.float32).reshape(64, 64)
    plain = tmp_path / "plain.ra"
    chunked = tmp_path / "chunked.ra"
    ra_io.write(str(plain), a)
    ra_io.write(str(chunked), a, codec="zlib", chunk_bytes=4096, stats=True)
    return tmp_path, plain, chunked


class TestDoctor:
    def test_clean_files_pass(self, corpus):
        _dir, plain, chunked = corpus
        assert doctor.doctor_file(str(plain)) == []
        assert doctor.doctor_file(str(chunked)) == []

    def test_truncated_stats_block_is_drift(self, corpus):
        d, _plain, chunked = corpus
        bad = d / "bad.ra"
        bad.write_bytes(chunked.read_bytes()[:-16])
        problems = doctor.doctor_file(str(bad))
        assert problems and any("rastats" in p for p in problems)

    def test_stale_stats_window_count_is_drift(self, corpus):
        # rewrite the rastats head to claim one window fewer: framing stays
        # internally consistent but disagrees with the file's geometry
        from repro_torch.core import stats as stats_mod

        d, _plain, chunked = corpus
        data = bytearray(chunked.read_bytes())
        idx = data.find(stats_mod.RASTATS_MAGIC_BYTES)
        assert idx > 0
        head = layouts.RASTATS.head_struct
        magic, ver, block, n, cb = head.unpack_from(data, idx)
        assert n >= 2
        shrunk = head.pack(magic, ver, layouts.RASTATS.nbytes(n - 1), n - 1, cb)
        trimmed = (
            bytes(data[:idx])
            + shrunk
            + bytes(data[idx + head.size:idx + layouts.RASTATS.nbytes(n - 1)])
            + bytes(data[idx + layouts.RASTATS.nbytes(n):])
        )
        stale = d / "stale.ra"
        stale.write_bytes(trimmed)
        problems = doctor.doctor_file(str(stale))
        assert any("stale" in p for p in problems), problems

    def test_racat_doctor_exit_codes(self, corpus, capsys):
        d, plain, _chunked = corpus
        assert racat_main(["doctor", str(plain)]) == 0
        bad = d / "bad2.ra"
        bad.write_bytes(plain.read_bytes()[:20])
        assert racat_main(["doctor", str(bad)]) == 1
        assert racat_main(["doctor", str(d)]) == 1  # dir walk finds bad2.ra
        out = capsys.readouterr()
        assert "DRIFT" in out.err

    def test_directory_without_ra_files(self, tmp_path):
        res = doctor.doctor_paths([str(tmp_path)])
        assert any(problems for problems in res.values())



# --------------------------------------------------- the URL plane under tsan


def test_url_restore_and_loader_epoch_are_clean_under_tsan(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"w": torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32)),
            "inner": {"b": torch.from_numpy(rng.standard_normal((96,)).astype(np.float32))}}
    ckpt = save_checkpoint(str(tmp_path / "ck"), 1, tree, chunked=True, chunk_bytes=8192)
    b = DatasetBuilder(str(tmp_path / "ds"), {"x": ((4, 3), "float32"), "y": ((), "int32")},
                       quantize={"x": ("u8", 0.0, 1.0)})
    b.append(x=rng.random((200, 4, 3), dtype=np.float32),
             y=rng.integers(0, 10, 200).astype(np.int32))
    b.finish()
    want, _, _ = load_checkpoint(ckpt, tree)

    was_installed = tsan.installed()
    tsan.install()
    watched = tsan.watch_all()
    server = remote.serve(str(tmp_path), port=0)
    try:
        assert watched
        url = f"{server.url}/ck/{os.path.basename(ckpt)}"
        got, _, _ = restore_pipelined(url, tree, device="cpu")
        assert torch.equal(got["w"], want["w"])
        assert torch.equal(got["inner"]["b"], want["inner"]["b"])
        dl = DataLoader(RaDataset(f"{server.url}/ds"), 32, seed=0, dequant=True)
        try:
            batches = [next(dl) for _ in range(200 // 32)]
        finally:
            dl.stop()
        assert len(batches) == 6 and all(bt["x"].shape == (32, 4, 3) for bt in batches)
        errors = [r for r in tsan.drain() if r.severity == "error"]
        assert errors == [], errors
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()
        remote.reset_shared_cache()
        tsan.unwatch_all()
        tsan.drain()
        if not was_installed:
            tsan.uninstall()

"""The port's device feed (``repro_torch.data``) against the JAX package's
host loader, on the CPU (``device="cpu"``): batches byte for byte, datasets
and loader state carried across in both directions, and the loader
lifecycle fixes (sticky errors, the stop()/restore() zombie ring, the
wedged-feeder detach) re-run against the port's copies."""

import filecmp
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro_torch.data as tdata
from repro_torch.core.spec import RawArrayError
from repro_torch.data import DataLoader, DeviceLoader, LoaderState, RaDataset
from repro_torch.data import device_loader as dl_mod

CPU = "cpu"


def _image_inputs(n=250, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 6, 6, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _build_images(pkg, root, *, quantize=True):
    images, labels = _image_inputs()
    b = pkg.DatasetBuilder(
        root,
        {"image": ((6, 6, 3), "float32"), "label": ((), "int32")},
        shard_rows=96,
        quantize={"image": "u8"} if quantize else None,
    )
    b.append(image=images, label=labels)
    b.finish()
    return root


@pytest.fixture(scope="module")
def token_root(tmp_path_factory):
    """Written by the JAX package's builder."""
    root = str(tmp_path_factory.mktemp("tfeed") / "toks")
    jdata.make_token_dataset(root, n_docs=256, seq_len=16, vocab=64, shard_rows=100)
    return root


@pytest.fixture(scope="module")
def quant_root(tmp_path_factory):
    """Quantized images written by the JAX package's builder."""
    return _build_images(jdata, str(tmp_path_factory.mktemp("tfeed") / "imgs"))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------ batches match the reference
def _equiv(root, *, batches=4, batch=16, seed=7):
    host = jdata.DataLoader(jdata.RaDataset(root), batch, seed=seed)
    dev = DeviceLoader(
        DataLoader(RaDataset(root), batch, seed=seed, reuse_buffers=True), device=CPU
    )
    try:
        kept = []
        for _ in range(batches):
            hb, db = next(host), next(dev)
            assert hb["_state"].__dict__ == db["_state"].__dict__
            for f in hb:
                if f == "_state":
                    continue
                assert isinstance(db[f], torch.Tensor) and db[f].device.type == CPU
                da = _np(db[f])
                assert da.dtype == hb[f].dtype, f
                assert np.array_equal(da, hb[f]), f
            kept.append((db, {f: np.array(v) for f, v in hb.items() if f != "_state"}))
        # reuse_buffers: batches handed out earlier never change under the consumer
        for db, hb in kept:
            for f, v in hb.items():
                assert np.array_equal(_np(db[f]), v), f
    finally:
        host.stop()
        dev.stop()


def test_device_loader_matches_reference_tokens(token_root):
    _equiv(token_root)


def test_device_loader_matches_reference_quantized(quant_root):
    """uint8 over the 'link' + the port's decode equals the reference host
    numpy decode (``DataLoader(dequant=True)``) byte for byte."""
    _equiv(quant_root, batches=12)


def test_device_loader_matches_reference_unshuffled(quant_root):
    host = jdata.DataLoader(jdata.RaDataset(quant_root), 16, seed=1, shuffle=False)
    dev = DeviceLoader(DataLoader(RaDataset(quant_root), 16, seed=1, shuffle=False),
                       device=CPU)
    try:
        for _ in range(5):
            hb, db = next(host), next(dev)
            assert np.array_equal(_np(db["image"]), hb["image"])
            assert np.array_equal(_np(db["label"]), hb["label"])
    finally:
        host.stop()
        dev.stop()


def test_device_loader_moves_quantized_bytes(quant_root):
    dev = DeviceLoader(DataLoader(RaDataset(quant_root), 16, seed=0), device=CPU)
    next(dev)
    s = dev.stats()
    dev.stop()
    per_batch = s["h2d_bytes"] / s["h2d_batches"]
    # image moves as u8 codes (108 B/row) + int32 label: 4x less than f32
    assert per_batch == 16 * (6 * 6 * 3 + 4)
    assert {"h2d_s", "device_wait_s", "device_batches"} <= set(s)
    # same keys as the reference; the chunk_* decode counters are process-wide
    # per package and appear once anything in the process decoded a chunk
    ref_keys = set(jdata.DataLoader(jdata.RaDataset(quant_root), 16).stats()) | {
        "h2d_s", "h2d_bytes", "h2d_batches", "device_wait_s", "device_batches"}
    assert {k for k in s if not k.startswith("chunk_")} == {
        k for k in ref_keys if not k.startswith("chunk_")}


# ------------------------------------------------ datasets carry across
@pytest.mark.parametrize("quantize", [True, False])
def test_port_builder_is_byte_identical(tmp_path, quantize):
    ref_root = _build_images(jdata, str(tmp_path / "ref"), quantize=quantize)
    port_root = _build_images(tdata, str(tmp_path / "port"), quantize=quantize)
    names = sorted(os.listdir(ref_root))
    assert names == sorted(os.listdir(port_root)) and "manifest.json" in names
    match, mismatch, errors = filecmp.cmpfiles(ref_root, port_root, names, shallow=False)
    assert mismatch == [] and errors == [] and sorted(match) == names
    # and the reference reads what the port wrote
    ref_ds, port_ds = jdata.RaDataset(port_root), RaDataset(ref_root)
    a, b = ref_ds.rows(0, 250), port_ds.rows(0, 250)
    for f in ("image", "label"):
        assert np.array_equal(a[f], b[f])
    if quantize:
        assert port_ds.quant["image"].to_dict() == ref_ds.quant["image"].to_dict()


# ------------------------------------------------ loader state carries across
def test_restore_from_reference_state(token_root):
    ref = jdata.DataLoader(jdata.RaDataset(token_root), 16, seed=9)
    batches = [next(ref) for _ in range(5)]
    ref.stop()
    dev = DeviceLoader(DataLoader(RaDataset(token_root), 16, seed=9), device=CPU)
    [next(dev) for _ in range(2)]
    dev.restore(LoaderState.from_dict(batches[2]["_state"].to_dict()))
    nxt = next(dev)
    dev.stop()
    assert nxt["_state"].__dict__ == batches[3]["_state"].__dict__
    assert np.array_equal(_np(nxt["tokens"]), batches[3]["tokens"])


def test_reference_restores_from_port_state(quant_root):
    dev = DeviceLoader(DataLoader(RaDataset(quant_root), 16, seed=5), device=CPU)
    got = [next(dev) for _ in range(4)]
    dev.stop()
    ref = jdata.DataLoader(jdata.RaDataset(quant_root), 16, seed=5)
    ref.restore(jdata.LoaderState.from_dict(got[1]["_state"].to_dict()))
    nxt = next(ref)
    ref.stop()
    assert nxt["_state"].__dict__ == got[2]["_state"].__dict__
    assert np.array_equal(nxt["image"], _np(got[2]["image"]))


def test_device_loader_restore_exact_across_epoch(token_root):
    ref = DataLoader(RaDataset(token_root), 16, seed=9)
    spe = ref.steps_per_epoch()
    batches = [next(ref) for _ in range(spe + 2)]
    ref.stop()
    dev = DeviceLoader(DataLoader(RaDataset(token_root), 16, seed=9), device=CPU)
    dev.restore(batches[spe - 1]["_state"])  # last batch of epoch 0
    nxt = next(dev)
    dev.stop()
    assert nxt["_state"].__dict__ == {"epoch": 1, "step": 0, "mesh_segments": None}
    assert np.array_equal(_np(nxt["tokens"]), batches[spe]["tokens"])


# ------------------------------------------------ construction
def test_device_loader_refuses_started_loader(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=0)
    next(dl)
    with pytest.raises(RawArrayError, match="not started"):
        DeviceLoader(dl, device=CPU)
    dl.stop()
    DeviceLoader(dl, device=CPU).stop()  # after stop() wrapping is fine


def test_device_bufs_knob(token_root, monkeypatch):
    monkeypatch.setenv("RA_DEVICE_BUFS", "5")
    dev = DeviceLoader(DataLoader(RaDataset(token_root), 16, seed=0), device=CPU)
    assert dev.bufs == 5
    dev.stop()
    dev2 = DeviceLoader(DataLoader(RaDataset(token_root), 16, seed=0), bufs=1, device=CPU)
    assert dev2.bufs == 1
    dev2.stop()


def test_global_arrays_not_ported(token_root):
    with pytest.raises(NotImplementedError, match="data-mesh device assembly"):
        DeviceLoader(DataLoader(RaDataset(token_root), 16), global_arrays=True, device=CPU)

    class Mesh:  # a mesh loader asks for global assembly by default
        host_index, host_count = 0, 1

    with pytest.raises(NotImplementedError, match="not ported yet"):
        DeviceLoader(DataLoader(RaDataset(token_root), 16, mesh=Mesh()), device=CPU)


def test_no_device_without_cuda_raises(token_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dl = DataLoader(RaDataset(token_root), 16)
    with pytest.raises(RawArrayError, match="no CUDA device"):
        DeviceLoader(dl)
    assert dl.dequant is True  # nothing was reconfigured
    with pytest.raises(RawArrayError, match="no CUDA device"):
        dl_mod.resolve_device()
    assert dl_mod.resolve_device("cpu") == torch.device("cpu")


def test_decoded_dtype_must_be_a_torch_float():
    assert dl_mod.torch_dtype("float32") is torch.float32
    assert dl_mod.torch_dtype(np.dtype("float16")) is torch.float16
    with pytest.raises(RawArrayError, match="cannot write"):
        dl_mod.torch_dtype("int32")


def test_url_sources_are_not_ported():
    # URL sources are ported now: a dataset URL goes to its server (here
    # none listens) instead of stopping at a stub
    with pytest.raises(RawArrayError, match="manifest.json failed"):
        RaDataset("http://127.0.0.1:9/ds")


# ------------------------------------------------ sticky errors
def test_device_loader_error_is_sticky(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=0)
    dl._produce = lambda e, s, out=None: (_ for _ in ()).throw(OSError("gone"))
    dev = DeviceLoader(dl, device=CPU)
    with pytest.raises(OSError, match="gone"):
        next(dev)
    t0 = time.perf_counter()
    with pytest.raises(OSError, match="gone"):
        next(dev)  # sticky through the device pipeline too
    assert time.perf_counter() - t0 < 1.0
    dev.stop()


def test_dead_producer_error_is_sticky(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=0)
    boom = RuntimeError("disk on fire")

    def bad_produce(epoch, step, out=None):
        raise boom

    dl._produce = bad_produce
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(dl)
    t0 = time.perf_counter()
    for _ in range(3):
        with pytest.raises(RuntimeError, match="disk on fire"):
            next(dl)
    assert time.perf_counter() - t0 < 1.0
    dl.stop()


def test_error_cleared_by_stop_then_restart(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=0)
    dl._produce = lambda e, s, out=None: (_ for _ in ()).throw(ValueError("x"))
    with pytest.raises(ValueError):
        next(dl)
    dl.stop()
    del dl._produce  # restore the class implementation
    assert "tokens" in next(dl)
    dl.stop()


# ------------------------------------------------ stop()/restore() zombie ring
def test_stop_verifies_join_and_discards_ring(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=1, reuse_buffers=True, prefetch=1)
    gate = threading.Event()
    entered = threading.Event()
    orig = DataLoader._produce.__get__(dl)

    def wedged(epoch, step, out=None):
        entered.set()
        gate.wait()
        return orig(epoch, step, out)

    dl._produce = wedged
    dl._start_prefetch()
    assert entered.wait(5.0)
    old_ring = dl._ring
    zombie = dl._thread
    assert old_ring
    dl.stop(join_timeout=0.2)  # zombie ignores the stop: join must time out
    assert zombie.is_alive()
    assert dl._ring == []

    del dl._produce
    ref = jdata.DataLoader(jdata.RaDataset(token_root), 16, seed=1)
    for i in range(6):
        if i == 3:
            gate.set()  # let the zombie finish its produce mid-iteration
        b, r = next(dl), next(ref)
        assert np.array_equal(b["tokens"], r["tokens"]), i
        assert b["_state"].__dict__ == r["_state"].__dict__
    assert dl._ring and dl._ring is not old_ring
    zombie.join(timeout=5.0)
    assert not zombie.is_alive()
    dl.stop()
    ref.stop()


def test_clean_stop_keeps_ring(token_root):
    dl = DataLoader(RaDataset(token_root), 16, seed=2, reuse_buffers=True)
    next(dl)
    ring = dl._ring
    assert ring
    dl.stop()
    assert dl._ring is ring


def test_restore_after_wedged_stop_is_exact(token_root):
    ref = jdata.DataLoader(jdata.RaDataset(token_root), 16, seed=3)
    batches = [next(ref) for _ in range(5)]
    ref.stop()

    dl = DataLoader(RaDataset(token_root), 16, seed=3, reuse_buffers=True)
    [next(dl) for _ in range(3)]
    gate = threading.Event()
    orig = DataLoader._produce.__get__(dl)
    dl._produce = lambda e, s, out=None: (gate.wait(), orig(e, s, out))[1]
    time.sleep(0.05)  # let the producer enter the wedge
    dl.restore(batches[2]["_state"])
    del dl._produce
    gate.set()
    nxt = next(dl)
    assert nxt["_state"].__dict__ == batches[3]["_state"].__dict__
    assert np.array_equal(nxt["tokens"], batches[3]["tokens"])
    dl.stop()


def test_device_loader_stop_detaches_wedged_feeder(token_root):
    inner = DataLoader(RaDataset(token_root), 16, seed=6)
    gate = threading.Event()
    orig = DataLoader._produce.__get__(inner)

    def wedged(epoch, step, out=None):
        gate.wait()
        return orig(epoch, step, out)

    inner._produce = wedged
    dev = DeviceLoader(inner, device=CPU)
    dev._start()  # feeder blocks inside next(inner)
    time.sleep(0.1)
    feeder = dev._thread
    dev.stop()  # join times out (~2s): wrapped loader must be replaced
    assert dev.loader is not inner
    assert dev.loader.seed == 6 and dev.loader.batch_size == 16
    ref = jdata.DataLoader(jdata.RaDataset(token_root), 16, seed=6)
    b, r = next(dev), next(ref)
    assert np.array_equal(_np(b["tokens"]), r["tokens"])
    assert b["_state"].__dict__ == r["_state"].__dict__
    gate.set()  # release the zombie; it must exit without stealing a batch
    feeder.join(timeout=5.0)
    assert not feeder.is_alive()
    b, r = next(dev), next(ref)
    assert np.array_equal(_np(b["tokens"]), r["tokens"])
    dev.stop()
    ref.stop()
    inner.stop()

